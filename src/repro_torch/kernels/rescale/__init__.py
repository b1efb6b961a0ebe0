from .ops import rescale
