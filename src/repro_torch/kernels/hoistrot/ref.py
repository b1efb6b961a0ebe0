"""Plain PyTorch version of the hoisted-rotation kernels.

Composes the plain stage functions (prescale, BConv, NTT, MAC) exactly as the
staged pipeline of ``repro_torch.fhe.keyswitch`` does, without recording
dispatches of its own, as ``fusedks/ref.py`` does for the fused key-switch.
"""

from __future__ import annotations

import torch

from repro_torch.fhe import poly, rns
from repro_torch.fhe.params import CkksParams
from repro_torch.kernels.bconv.ref import bconv_ref
from repro_torch.kernels.fusedks.ref import _scale
from repro_torch.kernels.modops.ref import addmod_ref, mulmod_ref
from repro_torch.kernels.ntt.ref import ntt_fwd_ref


def mod_up_digits_ref(d_coeff, params: CkksParams, level: int):
    """(level+1, N) coeff limbs → (β, m, N) eval-domain extended-basis digits."""
    ext = poly.ext_idx(params, level)
    ext_primes = poly.primes_for(params, ext)
    plan = poly.plan_for(params, ext)
    rows = []
    for j in range(params.beta(level)):
        limbs, src, _, bhat_inv, w = rns.digit_tables(params, level, j)
        xhat = _scale(d_coeff[limbs[0] : limbs[-1] + 1], bhat_inv, src)
        rows.append(ntt_fwd_ref(bconv_ref(xhat, w, ext_primes), plan))
    return torch.stack(rows)


def galois_mac_ref(dig, ksk, params: CkksParams, level: int, mulmod=mulmod_ref, addmod=addmod_ref):
    """Σ_j dig_j ∘ ksk_{r,j} per rotation: (R, β, 2, m, N) keys → (R, 2, m, N).

    ``mulmod``/``addmod`` are the per-op functions of every MAC step: the plain
    versions here, the recording wrappers of ``kernels.modops`` for the staged
    pipeline (one launch per op on the card)."""
    ext_primes = poly.primes_for(params, poly.ext_idx(params, level))
    m, n = dig.shape[1], dig.shape[2]
    outs = []
    for r in range(ksk.shape[0]):
        acc0 = torch.zeros((m, n), dtype=torch.int32, device=dig.device)
        acc1 = torch.zeros((m, n), dtype=torch.int32, device=dig.device)
        for j in range(params.beta(level)):
            t0 = mulmod(dig[j], ksk[r, j, 0], ext_primes)
            t1 = mulmod(dig[j], ksk[r, j, 1], ext_primes)
            acc0 = addmod(acc0, t0, ext_primes)
            acc1 = addmod(acc1, t1, ext_primes)
        outs.append(torch.stack([acc0, acc1]))
    return torch.stack(outs)
