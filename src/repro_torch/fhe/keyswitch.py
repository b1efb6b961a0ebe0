"""Hybrid key switching — the iNTT→BConv→NTT pipeline the paper accelerates.

`key_switch(d, level, ...)` homomorphically maps a polynomial d (eval domain,
basis q_0..q_ℓ) multiplied by s' into a pair under s:

    1. INTT d over the active basis                       (iNTT stage)
    2. per digit j < β(ℓ): prescale by [B̂_i^{-1}]_{b_i},
       BConv digit → {q_0..q_ℓ} ∪ {p_0..p_α-1}            (BConv stage)
    3. NTT each converted digit over the extended basis   (NTT stage)
    4. accumulate  Σ_j  d̂_j ∘ ksk_j                       (MAC stage)
    5. ModDown by P: INTT(P limbs) → BConv P→Q → NTT → subtract, ×[P^{-1}]_q

Two pipeline shapes execute the same math:

  * **fused** — stages 2–4 run as ONE kernel launch per key-switch (and one
    more for the ModDown tails of both accumulators) via
    ``repro_torch.kernels.fusedks``; the trace carries the fused per-stage
    records with no working-set boundaries.
  * **staged** — one launch per stage per digit; every stage boundary emits
    STORE_WS/LOAD_WS trace records because the intermediate polynomial
    round-trips through device memory between launches.

``backend`` selects the pipeline: "fused"/"kernel" → fused, "staged"/"ref" →
staged, "auto" → fused on the card and staged on the CPU.  Which code runs each
stage is decided by the tensors' device alone: the plain PyTorch version on the
CPU, the CUDA kernel on the card.  The staged pipeline needs a BConv kernel,
which the card does not have yet, so on the card it raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels.bconv import ops as bconv_ops
from repro_torch.kernels.fusedks import ops as fused_ops
from repro_torch.kernels.modops import ops as mo
from repro_torch.kernels.ntt import ops as ntt_ops

from . import poly, rns, trace
from .keys import SwitchingKey
from .params import CkksParams


def resolve_pipeline(backend: str, device) -> tuple[str, str]:
    """Map a backend choice on ``device`` to (pipeline, stage_backend).

    The stage names are the reference package's; in this package the stage
    code is chosen by the tensors' device, so only the pipeline shapes a call.
    """
    if backend == "fused":
        return "fused", "auto"
    if backend == "kernel":
        return "fused", "kernel"
    if backend == "staged":
        return "staged", "auto"
    if backend == "ref":
        return "staged", "ref"
    if backend == "auto":
        if torch.device(device).type == "cuda":
            return "fused", "auto"
        return "staged", "ref"
    raise ValueError(f"unknown key-switch backend {backend!r}")


def _boundary(n: int, limbs: int) -> None:
    """A staged-dispatch boundary: the intermediate round-trips through memory."""
    trace.record("STORE_WS", n, limbs)
    trace.record("LOAD_WS", n, limbs)


@functools.lru_cache(maxsize=2048)
def _digit_tables(params: CkksParams, level: int, j: int):
    """(src_idx, bhat_inv, w, dst_primes) for digit j at ``level``."""
    digit_idx = tuple(i for i in params.digit(j) if i <= level)
    src = poly.primes_for(params, digit_idx)
    dst = poly.primes_for(params, poly.ext_idx(params, level))
    bhat_inv, w = rns.bconv_tables(src, dst)
    return digit_idx, bhat_inv, w, dst


@functools.lru_cache(maxsize=512)
def _moddown_tables(params: CkksParams, level: int):
    p_primes = poly.primes_for(params, poly.p_idx(params))
    q_primes = poly.primes_for(params, poly.q_idx(params, level))
    bhat_inv, w = rns.bconv_tables(p_primes, q_primes)
    P = rns.product(p_primes)
    pinv = np.array([pow(P % q, -1, q) for q in q_primes], np.uint32)
    return bhat_inv, w, q_primes, pinv


def _per_limb(consts, like: torch.Tensor) -> torch.Tensor:
    """(k,) constants < 2^31 broadcast over ``like``'s (k, N) shape (stride 0 along N)."""
    c = torch.as_tensor(np.asarray(consts).astype(np.int32), device=like.device)
    return c[:, None].expand(like.shape)


def _scale_limbs(x, consts, qs):
    """x ∘ diag(consts) per limb — consts: (k,) broadcast over N."""
    trace.record("PMULT", x.shape[-1], x.shape[-2])
    return mo.pointwise_mulmod(x, _per_limb(consts, x), qs)


def _select_ksk(ksk: SwitchingKey, params: CkksParams, level: int, beta: int):
    """(β, 2, |ext|, N): key limbs restricted to active + special moduli."""
    return torch.cat([ksk.k[:, :, : level + 1], ksk.k[:, :, params.L + 1 :]], dim=2)[:beta]


def _record_fused_digits(params: CkksParams, level: int) -> None:
    """Trace the fused per-digit pipeline (planner `key_switch(fused=True)`)."""
    n = params.n
    m = len(poly.ext_idx(params, level))
    for j in range(params.beta(level)):
        k = len(tuple(i for i in params.digit(j) if i <= level))
        trace.record("PMULT", n, k, fused=True)
        trace.record("BCONV", n, k, dst=m, fused=True)
        trace.record("NTT", n, m, fused=True)
        trace.record("PMULT", n, 2 * m, mac=True, fused=True)
        trace.record("PADD", n, 2 * m, mac=True, fused=True)


def _record_fused_moddown(params: CkksParams, level: int) -> None:
    n, nq, a = params.n, level + 1, params.alpha
    trace.record("INTT", n, a)
    trace.record("PMULT", n, a, fused=True)
    trace.record("BCONV", n, a, dst=nq, fused=True)
    trace.record("NTT", n, nq, fused=True)
    trace.record("PSUB", n, nq, mac=True, fused=True)
    trace.record("PMULT", n, nq, mac=True, fused=True)


def mod_down(acc_ext, params: CkksParams, level: int):
    """Extended-basis eval-domain poly → q-basis, divided (rounded) by P.

    Staged pipeline for one accumulator; the fused path batches both
    accumulators through ``mod_down_pair`` instead.
    """
    n = params.n
    nq = level + 1
    alpha = params.alpha
    q_part, p_part = acc_ext[:nq], acc_ext[nq:]
    bhat_inv, w, q_primes, pinv = _moddown_tables(params, level)
    p_primes = poly.primes_for(params, poly.p_idx(params))

    p_coeff = poly.to_coeff(p_part, params, poly.p_idx(params))
    xhat = _scale_limbs(p_coeff, bhat_inv, p_primes)
    _boundary(n, alpha)
    trace.record("BCONV", n, alpha, dst=nq)
    conv = bconv_ops.bconv(xhat, w, q_primes)
    _boundary(n, nq)
    conv_eval = poly.to_eval(conv, params, poly.q_idx(params, level))
    _boundary(n, nq)
    trace.record("PSUB", n, nq, mac=True)
    diff = mo.pointwise_submod(q_part, conv_eval, q_primes)
    _boundary(n, nq)
    trace.record("PMULT", n, nq, mac=True)
    return mo.pointwise_mulmod(diff, _per_limb(pinv, diff), q_primes)


def mod_down_pair(acc0, acc1, params: CkksParams, level: int, backend: str = "auto"):
    """ModDown both MAC accumulators; the fused path shares one kernel launch."""
    pipeline, _ = resolve_pipeline(backend, acc0.device)
    if pipeline != "fused":
        return mod_down(acc0, params, level), mod_down(acc1, params, level)
    nq = level + 1
    _record_fused_moddown(params, level)
    _record_fused_moddown(params, level)
    p_part = torch.stack([acc0[nq:], acc1[nq:]])
    p_coeff = ntt_ops.ntt_inv(p_part, poly.plan_for(params, poly.p_idx(params)))
    q_part = torch.stack([acc0[:nq], acc1[:nq]])
    out = fused_ops.mod_down_digits(p_coeff, q_part, params, level)
    return out[0], out[1]


def key_switch(d_eval, params: CkksParams, level: int, ksk: SwitchingKey, backend: str = "auto"):
    """d (eval, basis q_0..q_ℓ) ⊗ s' → (ks0, ks1) eval over q_0..q_ℓ under s."""
    ksk_sel = _select_ksk(ksk, params, level, params.beta(level))
    return key_switch_selected(d_eval, params, level, ksk_sel, backend)


def key_switch_selected(d_eval, params: CkksParams, level: int, ksk_sel, backend: str = "auto"):
    """``key_switch`` over pre-selected key limbs ksk_sel: (β, 2, m, N)."""
    acc0, acc1 = key_switch_accumulate(d_eval, params, level, ksk_sel, backend)
    return mod_down_pair(acc0, acc1, params, level, backend)


def key_switch_accumulate(d_eval, params: CkksParams, level: int, ksk_sel, backend: str = "auto"):
    """Stages 1–4 of a key switch: decompose d into digits and MAC against the
    key, returning both raw accumulators (eval domain, extended basis Q∪P)
    *before* ModDown."""
    pipeline, _ = resolve_pipeline(backend, d_eval.device)
    n = params.n
    beta = params.beta(level)
    ext = poly.ext_idx(params, level)
    ext_primes = poly.primes_for(params, ext)
    m = len(ext)

    trace.record("LOAD_KSK", n, beta * 2 * m)
    d_coeff = poly.to_coeff(d_eval, params, poly.q_idx(params, level))

    if pipeline == "fused":
        # stages 2–4 for all β digits and both key components: ONE launch
        _record_fused_digits(params, level)
        return fused_ops.key_switch_digits(d_coeff, ksk_sel, params, level)

    acc0 = torch.zeros((m, n), dtype=torch.int32, device=d_eval.device)
    acc1 = torch.zeros((m, n), dtype=torch.int32, device=d_eval.device)
    for j in range(beta):
        digit_idx, bhat_inv, w, dst = _digit_tables(params, level, j)
        k = len(digit_idx)
        src = poly.primes_for(params, digit_idx)
        dj = d_coeff[digit_idx[0] : digit_idx[-1] + 1]
        xhat = _scale_limbs(dj, bhat_inv, src)
        _boundary(n, k)
        trace.record("BCONV", n, k, dst=m)
        dj_ext = bconv_ops.bconv(xhat, w, dst)
        _boundary(n, m)
        dj_eval = poly.to_eval(dj_ext, params, ext)
        _boundary(n, m)
        trace.record("PMULT", n, 2 * m, mac=True)
        t0 = mo.pointwise_mulmod(dj_eval, ksk_sel[j, 0], ext_primes)
        t1 = mo.pointwise_mulmod(dj_eval, ksk_sel[j, 1], ext_primes)
        _boundary(n, 2 * m)
        trace.record("PADD", n, 2 * m, mac=True)
        acc0 = mo.pointwise_addmod(acc0, t0, ext_primes)
        acc1 = mo.pointwise_addmod(acc1, t1, ext_primes)
    return acc0, acc1
