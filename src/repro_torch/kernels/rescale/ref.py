"""Plain PyTorch version of the fused CKKS rescale.

The reference's composition (``repro.fhe.ops._rescale``), stacked over the two
components: the inverse NTT of the dropped limb, its centred coefficients
re-embedded in every remaining limb in int64 arithmetic, the forward NTT, the
subtraction and the multiply by q_ℓ⁻¹.  It calls the plain functions, not the
recording wrappers, so a fused rescale counts one dispatch on the CPU as on
the card.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.fhe import poly
from repro_torch.fhe.params import CkksParams
from repro_torch.kernels.modops.ref import limb_moduli, mulmod_ref, submod_ref
from repro_torch.kernels.ntt.ref import ntt_fwd_ref, ntt_inv_ref


def rescale_ref(c0, c1, params: CkksParams, level: int):
    """c0, c1: (level+1, N) int32 eval-domain.  Returns the two (level, N) int32 components."""
    q_last = int(params.q_primes[level])
    qs = params.q_primes[:level]
    x = torch.stack((c0, c1))
    v = ntt_inv_ref(x[:, level:], poly.plan_for(params, (level,))).long()  # (2, 1, N)
    q_rem = limb_moduli(qs, x)
    rem = (torch.where(v > q_last // 2, v + q_rem - q_last, v) % q_rem).int()
    diff = submod_ref(x[:, :level], ntt_fwd_ref(rem, poly.plan_for(params, poly.q_idx(params, level - 1))), qs)
    qinv = torch.as_tensor(np.array([pow(q_last % q, -1, q) for q in qs], np.int32)[:, None], device=x.device)
    out = mulmod_ref(diff, qinv.expand(diff.shape), qs)
    return out[0], out[1]
