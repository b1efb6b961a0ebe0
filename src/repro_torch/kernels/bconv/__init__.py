from .ops import bconv
