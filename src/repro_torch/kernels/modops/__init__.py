from .ops import pointwise_addmod, pointwise_mulmod, pointwise_submod
