"""Plain PyTorch version of the fused key-switch pipeline.

Composes the plain versions of the stage ops (prescale, BConv, NTT, MAC)
exactly as the staged pipeline in ``repro_torch.fhe.keyswitch`` does.  It
calls the plain functions directly, not the recording wrappers, so a fused
key-switch counts the same dispatches on the CPU as on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.fhe import poly, rns
from repro_torch.fhe.params import CkksParams
from repro_torch.kernels.bconv.ref import bconv_ref
from repro_torch.kernels.modops.ref import addmod_ref, mulmod_ref, submod_ref
from repro_torch.kernels.ntt.ref import ntt_fwd_ref


def _scale(x, consts, qs):
    c = torch.as_tensor(np.asarray(consts, np.int64).astype(np.int32), device=x.device)[:, None]
    return mulmod_ref(x, c.expand(x.shape), qs)


def key_switch_digits_ref(d_coeff, ksk_sel, params: CkksParams, level: int):
    ext = poly.ext_idx(params, level)
    ext_primes = poly.primes_for(params, ext)
    plan = poly.plan_for(params, ext)
    shape = (len(ext), params.n)
    acc0 = torch.zeros(shape, dtype=torch.int32, device=d_coeff.device)
    acc1 = torch.zeros(shape, dtype=torch.int32, device=d_coeff.device)
    for j in range(params.beta(level)):
        limbs, src, _, bhat_inv, w = rns.digit_tables(params, level, j)
        xhat = _scale(d_coeff[limbs[0] : limbs[-1] + 1], bhat_inv, src)
        dj_eval = ntt_fwd_ref(bconv_ref(xhat, w, ext_primes), plan)
        acc0 = addmod_ref(acc0, mulmod_ref(dj_eval, ksk_sel[j, 0], ext_primes), ext_primes)
        acc1 = addmod_ref(acc1, mulmod_ref(dj_eval, ksk_sel[j, 1], ext_primes), ext_primes)
    return acc0, acc1


def mod_down_digits_ref(p_coeff, q_part, params: CkksParams, level: int):
    p_primes, q_primes, bhat_inv, w, pinv = rns.moddown_tables(params, level)
    plan = poly.plan_for(params, poly.q_idx(params, level))
    pinv_t = torch.as_tensor(pinv.astype(np.int32), device=q_part.device)[:, None]
    outs = []
    for c in range(p_coeff.shape[0]):
        xhat = _scale(p_coeff[c], bhat_inv, p_primes)
        conv_eval = ntt_fwd_ref(bconv_ref(xhat, w, q_primes), plan)
        diff = submod_ref(q_part[c], conv_eval, q_primes)
        outs.append(mulmod_ref(diff, pinv_t.expand(diff.shape), q_primes))
    return torch.stack(outs)
