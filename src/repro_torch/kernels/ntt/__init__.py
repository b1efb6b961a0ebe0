from .ops import ntt_fwd, ntt_inv
