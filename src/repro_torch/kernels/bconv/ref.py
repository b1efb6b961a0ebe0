"""Plain PyTorch version of fast basis conversion (BConv), int64.

Conv_{B→C}(x)[j, n] = Σ_i  x̂[i, n] · W[i, j]   (mod c_j)

where x̂[i] = x[i]·[B̂_i^{-1}]_{b_i} mod b_i was already applied by the caller
and W[i, j] = B̂_i mod c_j.
"""

from __future__ import annotations

import numpy as np
import torch


def bconv_ref(xhat, w, cs):
    """xhat: (k, N) int32; w: (k, m) uint32 array; cs: (m,) → (m, N) int32.

    Each 62-bit term is reduced mod c_j before it is added: summing unreduced
    products over ~60 source limbs would overflow int64.  The reduced terms
    are < 2^31, so their sum over k ≤ 64 limbs stays far inside int64.
    """
    dev = xhat.device
    wt = torch.as_tensor(np.asarray(w, np.int64), device=dev)  # (k, m)
    c = torch.as_tensor(np.asarray(cs, np.int64).reshape(-1, 1), device=dev)  # (m, 1)
    xh = xhat.long()
    acc = torch.zeros((wt.shape[1], xhat.shape[1]), dtype=torch.int64, device=dev)
    for i in range(xh.shape[0]):
        acc += xh[i][None, :] * wt[i][:, None] % c
    return (acc % c).int()
