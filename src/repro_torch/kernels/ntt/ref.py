"""Plain PyTorch version of the negacyclic NTT (int64, natural-order output).

Iterative radix-2 decimation-in-time over the cyclic root w = psi^2, with the
negacyclic psi-twist applied before (fwd) / after (inv) — the same algorithm
as the CUDA kernel, one vectorised stage at a time.
"""

from __future__ import annotations

import torch

from repro_torch.fhe.ntt import NttPlan, bit_reverse_indices
from repro_torch.kernels.tables import table


@table("ntt_bitrev")
def _bitrev(n: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(bit_reverse_indices(n), device=device)


@table("ntt_ref_tables")
def _tables(plan: NttPlan, l: int, device: torch.device) -> dict[str, torch.Tensor]:
    """The plan's first ``l`` limbs as int64 tensors on ``device``."""
    def t(a):
        return torch.as_tensor(a[:l].astype("int64"), device=device)

    return dict(q=t(plan.qs).reshape(l, 1), psi=t(plan.psi_pows), w=t(plan.w_pows),
                winv=t(plan.winv_pows), psiinv_ninv=t(plan.psiinv_ninv))


def _cyclic_ntt(a, w_pows, q):
    """Cyclic NTT along the last axis.  a: (..., L, N) int64; w_pows: (L, N); q: (L, 1)."""
    n = a.shape[-1]
    a = a.index_select(-1, _bitrev(n, a.device))
    qb = q[..., None]
    m = 1
    while m < n:
        span = 2 * m
        tw = w_pows[:, :: n // span][:, :m]  # (L, m): w^((N/2m)·j)
        ar = a.reshape(a.shape[:-1] + (n // span, 2, m))
        even = ar[..., 0, :]  # (..., L, n//span, m)
        odd = ar[..., 1, :] * tw[:, None, :] % qb
        s = even + odd
        plus = torch.where(s >= qb, s - qb, s)
        minus = torch.where(even >= odd, even - odd, even + qb - odd)
        a = torch.stack([plus, minus], dim=-2).reshape(a.shape)
        m = span
    return a


def ntt_fwd_ref(x, plan: NttPlan):
    """x: (..., l, N) int32 coefficients → (..., l, N) int32 slots."""
    t = _tables(plan, x.shape[-2], x.device)
    return _cyclic_ntt(x.long() * t["psi"] % t["q"], t["w"], t["q"]).int()


def ntt_inv_ref(x, plan: NttPlan):
    t = _tables(plan, x.shape[-2], x.device)
    return (_cyclic_ntt(x.long(), t["winv"], t["q"]) * t["psiinv_ninv"] % t["q"]).int()
