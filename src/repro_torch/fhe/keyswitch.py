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

``fused`` selects the pipeline: the context resolves its policy's backend to it
once (``FheContext.plan_fused``, through ``resolve_pipeline``).  Which code runs
each stage is decided by the tensors' device alone: the plain PyTorch version
on the CPU, the CUDA kernel on the card.  The key-switch's RNS constants come
from ``fhe.rns.digit_tables`` and ``fhe.rns.moddown_tables``.

The hoisted (Halevi–Shoup) helpers at the end split a rotation's key-switch
into a ModUp shared by every rotation of one ciphertext and a per-rotation
MAC + ModDown (``repro_torch.kernels.hoistrot``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.bconv import ops as bconv_ops
from repro_torch.kernels.fusedks import ops as fused_ops
from repro_torch.kernels.hoistrot import ops as hoist_ops
from repro_torch.kernels.modops import ops as mo
from repro_torch.kernels.ntt import ops as ntt_ops
from repro_torch.obs.spans import span

from . import poly, rns, trace
from .keys import KeySet, SwitchingKey
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


def _per_limb(consts, like: torch.Tensor) -> torch.Tensor:
    """(k,) constants < 2^31 broadcast over ``like``'s (k, N) shape (stride 0 along N)."""
    values = tuple(int(c) for c in np.asarray(consts).reshape(-1))
    return poly.limb_column(values, torch.int32, like.device).expand(like.shape)


def _scale_limbs(x, consts, qs):
    """x ∘ diag(consts) per limb — consts: (k,) broadcast over N."""
    trace.record("PMULT", x.shape[-1], x.shape[-2])
    return mo.pointwise_mulmod(x, _per_limb(consts, x), qs)


def _select_ksk(ksk: SwitchingKey, params: CkksParams, level: int, beta: int):
    """(β, 2, |ext|, N): key limbs restricted to active + special moduli."""
    return torch.cat([ksk.k[:, :, : level + 1], ksk.k[:, :, params.L + 1 :]], dim=2)[:beta]


def _record_fused_digits(params: CkksParams, level: int, mac: bool = True) -> None:
    """Trace the fused per-digit pipeline: planner ``key_switch(fused=True)``,
    or without the MAC records ``mod_up(fused=True)``."""
    n = params.n
    m = len(poly.ext_idx(params, level))
    for j in range(params.beta(level)):
        k = len(tuple(i for i in params.digit(j) if i <= level))
        trace.record("PMULT", n, k, fused=True)
        trace.record("BCONV", n, k, dst=m, fused=True)
        trace.record("NTT", n, m, fused=True)
        if mac:
            trace.record("PMULT", n, 2 * m, mac=True, fused=True)
            trace.record("PADD", n, 2 * m, mac=True, fused=True)


def _staged_mod_up(d_coeff, params: CkksParams, level: int):
    """The staged ModUp, digit by digit: prescale → BConv → NTT into the
    extended basis, one launch a stage.  Yields each digit's eval-domain
    polynomial before it converts the next."""
    n = params.n
    ext = poly.ext_idx(params, level)
    m = len(ext)
    for j in range(params.beta(level)):
        limbs, src, dst, bhat_inv, w = rns.digit_tables(params, level, j)
        k = len(limbs)
        xhat = _scale_limbs(d_coeff[limbs[0] : limbs[-1] + 1], bhat_inv, src)
        _boundary(n, k)
        trace.record("BCONV", n, k, dst=m)
        dj_ext = bconv_ops.bconv(xhat, w, dst)
        _boundary(n, m)
        yield poly.to_eval(dj_ext, params, ext)


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
    p_primes, q_primes, bhat_inv, w, pinv = rns.moddown_tables(params, level)

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


def mod_down_pair(acc0, acc1, params: CkksParams, level: int, fused: bool):
    """ModDown both MAC accumulators; the fused path shares one kernel launch."""
    if not fused:
        return mod_down(acc0, params, level), mod_down(acc1, params, level)
    nq = level + 1
    _record_fused_moddown(params, level)
    _record_fused_moddown(params, level)
    p_part = torch.stack([acc0[nq:], acc1[nq:]])
    p_coeff = ntt_ops.ntt_inv(p_part, poly.plan_for(params, poly.p_idx(params)))
    q_part = torch.stack([acc0[:nq], acc1[:nq]])
    out = fused_ops.mod_down_digits(p_coeff, q_part, params, level)
    return out[0], out[1]


def key_switch(d_eval, params: CkksParams, level: int, ksk: SwitchingKey, fused: bool):
    """d (eval, basis q_0..q_ℓ) ⊗ s' → (ks0, ks1) eval over q_0..q_ℓ under s."""
    ksk_sel = _select_ksk(ksk, params, level, params.beta(level))
    return key_switch_selected(d_eval, params, level, ksk_sel, fused)


def key_switch_selected(d_eval, params: CkksParams, level: int, ksk_sel, fused: bool):
    """``key_switch`` over pre-selected key limbs ksk_sel: (β, 2, m, N)."""
    acc0, acc1 = key_switch_accumulate(d_eval, params, level, ksk_sel, fused)
    return mod_down_pair(acc0, acc1, params, level, fused)


def key_switch_accumulate(d_eval, params: CkksParams, level: int, ksk_sel, fused: bool):
    """Stages 1–4 of a key switch: decompose d into digits and MAC against the
    key, returning both raw accumulators (eval domain, extended basis Q∪P)
    *before* ModDown."""
    n = params.n
    beta = params.beta(level)
    ext = poly.ext_idx(params, level)
    ext_primes = poly.primes_for(params, ext)
    m = len(ext)

    trace.record("LOAD_KSK", n, beta * 2 * m)
    d_coeff = poly.to_coeff(d_eval, params, poly.q_idx(params, level))

    if fused:
        # stages 2–4 for all β digits and both key components: ONE launch
        _record_fused_digits(params, level)
        return fused_ops.key_switch_digits(d_coeff, ksk_sel, params, level)

    acc0 = torch.zeros((m, n), dtype=torch.int32, device=d_eval.device)
    acc1 = torch.zeros((m, n), dtype=torch.int32, device=d_eval.device)
    for j, dj_eval in enumerate(_staged_mod_up(d_coeff, params, level)):
        _boundary(n, m)
        trace.record("PMULT", n, 2 * m, mac=True)
        t0 = mo.pointwise_mulmod(dj_eval, ksk_sel[j, 0], ext_primes)
        t1 = mo.pointwise_mulmod(dj_eval, ksk_sel[j, 1], ext_primes)
        _boundary(n, 2 * m)
        trace.record("PADD", n, 2 * m, mac=True)
        acc0 = mo.pointwise_addmod(acc0, t0, ext_primes)
        acc1 = mo.pointwise_addmod(acc1, t1, ext_primes)
    return acc0, acc1


# ---------------------------------------------------------------------------
# hoisted (Halevi–Shoup) rotation key-switching
# ---------------------------------------------------------------------------
#
# The ModUp half of a key-switch (iNTT → digit decompose → prescale → BConv →
# NTT into the extended basis) depends only on the input polynomial — never on
# the Galois element — so k rotations of the same ciphertext can share ONE
# ModUp and pay only KSK-MAC + ModDown each: O(β + k) forward NTTs through the
# extended basis instead of O(k·β).
#
# The automorphism is folded instead of applied per digit: with keys
# pre-permuted by σ_t^{-1} (cached per KeySet in ``hoisted_ksk``),
#
#   KS(σ_t(d)) = σ_t( ModDown( Σ_j D_j(d) ∘ σ_t^{-1}(ksk_j) ) )
#
# because σ_t commutes exactly (per residue) with every stage: it is a pure
# slot permutation in the eval domain, a signed coefficient permutation in the
# coefficient domain, and every ModUp/ModDown stage is a per-coefficient-index
# linear map over the limbs.  So the whole MAC + ModDown runs in the σ_t^{-1}
# frame and ONE permutation per output component lands the result — that
# single AUTO also absorbs the σ_t(c0) term: the final ciphertext is
# (σ_t(c0 + ks0'), σ_t(ks1')).


@dataclasses.dataclass
class HoistedDigits:
    """Reusable ModUp decomposition of one eval-domain polynomial.

    ``digits`` is (β, m, N) int32 over the extended basis (eval domain) —
    the rotation-independent half of a key-switch, shared by every rotation
    of a hoisted group.
    """

    digits: torch.Tensor
    level: int

    @property
    def beta(self) -> int:
        return int(self.digits.shape[0])


def hoisted_mod_up(d_eval, params: CkksParams, level: int, fused: bool) -> HoistedDigits:
    """ModUp once: d (eval, q_0..q_ℓ) → reusable extended-basis digits.

    The returned digits are materialised (they round-trip to the later MAC
    launches — the trace carries one STORE_WS/LOAD_WS pair of β·m limbs),
    amortising the β forward NTTs across every rotation that reuses them.
    """
    d_coeff = poly.to_coeff(d_eval, params, poly.q_idx(params, level))
    if fused:
        _record_fused_digits(params, level, mac=False)
        digits = hoist_ops.mod_up_digits(d_coeff, params, level)
    else:
        digits = torch.stack(list(_staged_mod_up(d_coeff, params, level)))
    # the hoisted digits round-trip to the MAC launches
    _boundary(params.n, params.beta(level) * len(poly.ext_idx(params, level)))
    return HoistedDigits(digits=digits, level=level)


# Each cached entry is a full (β, 2, m, N) key copy — comparable to the
# level-restricted key itself — so the per-KeySet cache is LRU-bounded BY
# BYTES (an entry count would still admit ~β·m·N-sized blowups at production
# parameters: one N=2^16 deep entry is >100 MB).  An entry larger than the
# whole budget is simply not cached.
HOIST_KSK_CACHE_BYTES = 256 * 2**20


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def hoisted_ksk(params: CkksParams, keys: KeySet, t: int, level: int):
    """σ_t^{-1}-pre-permuted Galois key, restricted to the active basis.

    (β, 2, m, N) int32 — LRU-cached per KeySet/(t, level): the permutation
    is a keygen-time precompute, not per-rotation work (no trace records).
    """
    cache = keys.hoist_cache
    hit = cache.get((t, level))
    if hit is not None:
        cache[(t, level)] = cache.pop((t, level))  # move to MRU position
        return hit
    with span("fhe.table.hoisted_ksk"):
        sel = _select_ksk(keys.galois(t), params, level, params.beta(level))
        tinv = pow(t, -1, 2 * params.n)
        pre = torch.index_select(sel, -1, poly.eval_perm(params.n, tinv, sel.device))
        if _nbytes(pre) <= HOIST_KSK_CACHE_BYTES:
            while cache and sum(_nbytes(v) for v in cache.values()) + _nbytes(pre) > HOIST_KSK_CACHE_BYTES:
                cache.pop(next(iter(cache)))  # evict LRU (dicts preserve insertion order)
            cache[(t, level)] = pre
        return pre


def hoisted_galois_ks(hd: HoistedDigits, ksk_stack, params: CkksParams, level: int, fused: bool):
    """KSK inner products for a whole rotation group, σ_t^{-1} frame.

    ksk_stack: (R, β, 2, m, N) pre-permuted key limbs (``hoisted_ksk``).
    Returns (R, 2, m, N) accumulator pairs; the fused pipeline issues ONE
    batched MAC launch that reads the hoisted digits once.
    """
    n = params.n
    beta = params.beta(level)
    m = int(hd.digits.shape[1])
    for _ in range(ksk_stack.shape[0]):
        trace.record("LOAD_KSK", n, beta * 2 * m)
        for _j in range(beta):
            trace.record("PMULT", n, 2 * m, mac=True, fused=fused)
            if not fused:
                _boundary(n, 2 * m)
            trace.record("PADD", n, 2 * m, mac=True, fused=fused)
    return hoist_ops.galois_mac(hd.digits, ksk_stack, params, level, staged=not fused)


def mod_down_group(accs, params: CkksParams, level: int, fused: bool):
    """ModDown every accumulator pair of a hoisted group.

    accs: (R, 2, m, N) → (R, 2, level+1, N).  The fused pipeline batches all
    2·R tails through ONE P-block iNTT + ONE ModDown launch.
    """
    nrot = accs.shape[0]
    if not fused:
        return torch.stack([
            torch.stack([mod_down(accs[i, c], params, level) for c in range(2)])
            for i in range(nrot)
        ])
    nq = level + 1
    for _ in range(2 * nrot):
        _record_fused_moddown(params, level)
    p_part = accs[:, :, nq:].reshape(2 * nrot, params.alpha, params.n)
    p_coeff = ntt_ops.ntt_inv(p_part, poly.plan_for(params, poly.p_idx(params)))
    q_part = accs[:, :, :nq].reshape(2 * nrot, nq, params.n)
    out = fused_ops.mod_down_digits(p_coeff, q_part, params, level)
    return out.reshape(nrot, 2, nq, params.n)


def permute_last(c0_eval, ks0, ks1, t: int, params: CkksParams, level: int):
    """The shared rotation epilogue: c0 + ks0, then ONE σ_t per component.

    ``ks0``/``ks1`` come from a key-switch against the σ_t^{-1}-pre-permuted
    key (``hoisted_ksk``), so the single automorphism here lands the rotated
    ciphertext — it also absorbs the σ_t(c0) term.  Every rotation path
    (standard, single-hoisted, group-hoisted) MUST end through this helper:
    the trace shape ([PADD, AUTO, AUTO], matching the planner) and the
    bit-exactness of hoisted vs standard both hang on the three paths doing
    literally the same thing.
    """
    n = params.n
    qs = params.q_primes[: level + 1]
    trace.record("PADD", n, level + 1)
    s0 = mo.pointwise_addmod(c0_eval, ks0, qs)
    return poly.automorphism_eval(s0, n, t), poly.automorphism_eval(ks1, n, t)


def rotate_hoisted(c0_eval, hd: HoistedDigits, t: int, keys: KeySet, params: CkksParams, level: int,
                   fused: bool):
    """One key-switched automorphism σ_t over a hoisted decomposition.

    Runs only KSK-MAC + ModDown (+ the folded automorphism) — the expensive
    ModUp was paid once when ``hd`` was built.  Returns the rotated
    ciphertext's (c0, c1) eval-domain polynomials, bit-exact against the
    un-hoisted rotation.
    """
    ksk_stack = hoisted_ksk(params, keys, t, level)[None]
    accs = hoisted_galois_ks(hd, ksk_stack, params, level, fused)
    ks = mod_down_group(accs, params, level, fused)
    return permute_last(c0_eval, ks[0, 0], ks[0, 1], t, params, level)
