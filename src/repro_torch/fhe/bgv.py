"""BGV exact integer arithmetic over the shared CKKS RNS/NTT substrate.

BGV ciphertexts are the same (level+1, N) int32 eval-domain RNS polynomials
CKKS uses, run through the same NTT / BConv / key-switch kernels; only the
plaintext embedding and the level-drop arithmetic differ.  Messages are
integers mod t packed into polynomial coefficients (message in the low-order
bits: phase = m + t·e), so every result is exact mod t, with no scale.

t is a power of two dividing 2·N_MAX = 2^17 (``CkksParams.plain_modulus``).
Every master-chain prime is NTT-friendly for N_MAX, so q ≡ 1 (mod t) and the
special-modulus product P ≡ 1 (mod t).  Consequences used throughout:

  * **Modulus switch** (``_mod_switch``, the BGV analogue of the rescale): drop
    the last limb by subtracting δ = t·[t^{-1}·c]_{q_ℓ} (centred) and dividing
    by q_ℓ.  δ ≡ c (mod q_ℓ), δ ≡ 0 (mod t) and q_ℓ^{-1} ≡ 1 (mod t), so the
    message mod t is preserved exactly.
  * **Relinearisation** (inside ``_mul``): the shared hybrid key-switch ends in
    a ModDown by P whose rounding term must also vanish mod t.  The ModDown
    kernels run unchanged inside a t-scaling sandwich,
    BGV_ModDown(x) = t · ModDown(t^{-1} · x): the correction the kernel
    subtracts becomes t·(lift) ≡ 0 (mod t), and the fused and staged
    pipelines stay bit-identical, as they are for CKKS.
  * **Keys**: BGV public and switching keys carry t-scaled errors
    (``keys._err_scale``), so ``full_keyset`` needs no scheme flag.

Every expression is the reference package's, in its order, and every op
records the same trace instructions with the same sizes, so the same params
and seeds give the same ciphertext bytes, trace and dispatch counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.modops import ops as mo

from . import keyswitch, ops, poly, rns, trace
from .keys import PublicKey, SecretKey, SwitchingKey
from .params import CkksParams


@dataclasses.dataclass
class BgvPlaintext:
    """Integer message packed into coefficients — (level+1, N) int32, eval domain."""

    data: torch.Tensor
    level: int


@dataclasses.dataclass
class BgvCiphertext:
    c0: torch.Tensor  # (level+1, N) int32, eval domain
    c1: torch.Tensor
    level: int

    @property
    def nbytes(self) -> int:
        return (self.c0.numel() + self.c1.numel()) * 4


def _t(params: CkksParams) -> int:
    t = params.plain_modulus
    if t is None:
        raise ValueError("BGV ops need params with plain_modulus set")
    return int(t)


def _qs(params: CkksParams, level: int) -> tuple[int, ...]:
    return params.q_primes[: level + 1]


# ---------------------------------------------------------------------------
# encode / decode — coefficient packing of integers mod t
# ---------------------------------------------------------------------------


def _encode(ctx, z, level: int | None = None) -> BgvPlaintext:
    """Pack ≤ N integers mod t into polynomial coefficients (eval domain), so
    that multiplication acts as negacyclic convolution mod t."""
    params = ctx.params
    t = _t(params)
    level = params.L if level is None else level
    z = np.asarray(z, dtype=np.int64) % t
    if z.ndim != 1 or z.shape[0] > params.n:
        raise ValueError(f"BGV encode wants ≤ {params.n} integers, got shape {z.shape}")
    coeffs = np.zeros(params.n, np.int64)
    coeffs[: z.shape[0]] = z
    # centred representatives keep |m| ≤ t/2 — half a bit of noise headroom
    coeffs = np.where(coeffs > t // 2, coeffs - t, coeffs)
    data = ops._residues_eval(ctx, poly.to_rns_signed(coeffs, params.q_primes[: level + 1]), level)
    return BgvPlaintext(data=data, level=level)


def _decode(ctx, pt: BgvPlaintext) -> np.ndarray:
    """Coefficients → integers in [0, t).  Exact while the phase noise
    m + t·e stays below q_ℓ/2: a centred CRT over every limb."""
    params = ctx.params
    t = _t(params)
    coeffs = poly.to_coeff(pt.data, params, poly.q_idx(params, pt.level))
    centered = rns.crt_reconstruct_centered(
        coeffs.cpu().numpy().astype(np.uint32), params.q_primes[: pt.level + 1], max_limbs=pt.level + 1
    )
    return (centered % t).astype(np.int64)


# ---------------------------------------------------------------------------
# encrypt / decrypt — message in the low-order bits: phase = m + t·e
# ---------------------------------------------------------------------------


def _encrypt(ctx, pk: PublicKey, pt: BgvPlaintext, seed: int = 17) -> BgvCiphertext:
    params = ctx.params
    t = _t(params)
    rng = np.random.default_rng(seed)
    level = pt.level
    primes = params.q_primes[: level + 1]
    qs = _qs(params, level)
    v = ops._residues_eval(ctx, poly.to_rns_signed(poly.sample_ternary(rng, params.n, params.n // 2), primes), level)
    # encryption errors are t-scaled, like the key errors (pk.b = -a·s + t·e)
    e0 = ops._residues_eval(ctx, poly.to_rns_signed(t * poly.sample_gaussian(rng, params.n), primes), level)
    e1 = ops._residues_eval(ctx, poly.to_rns_signed(t * poly.sample_gaussian(rng, params.n), primes), level)
    trace.record("PMULT", params.n, 2 * (level + 1))
    c0 = mo.pointwise_addmod(
        mo.pointwise_addmod(mo.pointwise_mulmod(v, pk.b[: level + 1], qs), e0, qs), pt.data, qs
    )
    c1 = mo.pointwise_addmod(mo.pointwise_mulmod(v, pk.a[: level + 1], qs), e1, qs)
    return BgvCiphertext(c0=c0, c1=c1, level=level)


def _decrypt(ctx, sk: SecretKey, ct: BgvCiphertext) -> BgvPlaintext:
    params = ctx.params
    qs = _qs(params, ct.level)
    trace.record("PMULT", params.n, ct.level + 1)
    m = mo.pointwise_addmod(ct.c0, mo.pointwise_mulmod(ct.c1, sk.s_eval[: ct.level + 1], qs), qs)
    return BgvPlaintext(data=m, level=ct.level)


# ---------------------------------------------------------------------------
# additive ops
# ---------------------------------------------------------------------------


def level_drop(ct: BgvCiphertext, level: int) -> BgvCiphertext:
    """Limb truncation: the phase mod a smaller Q' still equals m + t·e',
    since every dropped prime is ≡ 1 (mod t)."""
    if level == ct.level:
        return ct
    assert level < ct.level
    return BgvCiphertext(c0=ct.c0[: level + 1], c1=ct.c1[: level + 1], level=level)


def _align(a: BgvCiphertext, b: BgvCiphertext):
    lv = min(a.level, b.level)
    return level_drop(a, lv), level_drop(b, lv)


def _add(ctx, a: BgvCiphertext, b: BgvCiphertext) -> BgvCiphertext:
    params = ctx.params
    a, b = _align(a, b)
    qs = _qs(params, a.level)
    trace.record("PADD", params.n, 2 * (a.level + 1))
    return BgvCiphertext(
        c0=mo.pointwise_addmod(a.c0, b.c0, qs), c1=mo.pointwise_addmod(a.c1, b.c1, qs), level=a.level
    )


def _sub(ctx, a: BgvCiphertext, b: BgvCiphertext) -> BgvCiphertext:
    params = ctx.params
    a, b = _align(a, b)
    qs = _qs(params, a.level)
    trace.record("PSUB", params.n, 2 * (a.level + 1))
    return BgvCiphertext(
        c0=mo.pointwise_submod(a.c0, b.c0, qs), c1=mo.pointwise_submod(a.c1, b.c1, qs), level=a.level
    )


def _negate(ctx, a: BgvCiphertext) -> BgvCiphertext:
    params = ctx.params
    qs = _qs(params, a.level)
    z = torch.zeros_like(a.c0)
    trace.record("PSUB", params.n, 2 * (a.level + 1))
    return BgvCiphertext(
        c0=mo.pointwise_submod(z, a.c0, qs), c1=mo.pointwise_submod(z, a.c1, qs), level=a.level
    )


# ---------------------------------------------------------------------------
# multiplication + relinearisation (t-wrapped hybrid key switch)
# ---------------------------------------------------------------------------


def _relin(ctx, d2, rlk: SwitchingKey, level: int):
    """Key-switch d2·s² → s with the ModDown wrapped in the t-scaling sandwich
    (module docstring): the subtracted rounding correction becomes a multiple
    of t, so the key-switch error lands entirely in the t·e slot."""
    params = ctx.params
    t = _t(params)
    fused = ctx.plan_fused
    ksk_sel = keyswitch._select_ksk(rlk, params, level, params.beta(level))
    acc0, acc1 = keyswitch.key_switch_accumulate(d2, params, level, ksk_sel, fused)

    ext_primes = poly.primes_for(params, poly.ext_idx(params, level))
    tinv_ext = [pow(t, -1, int(p)) for p in ext_primes]
    acc0 = keyswitch._scale_limbs(acc0, tinv_ext, ext_primes)
    acc1 = keyswitch._scale_limbs(acc1, tinv_ext, ext_primes)

    ks0, ks1 = keyswitch.mod_down_pair(acc0, acc1, params, level, fused)

    qs = _qs(params, level)
    t_q = [t] * (level + 1)  # t < 2^31 ⇒ [t]_q = t
    ks0 = keyswitch._scale_limbs(ks0, t_q, qs)
    ks1 = keyswitch._scale_limbs(ks1, t_q, qs)
    return ks0, ks1


def _mul(ctx, a: BgvCiphertext, b: BgvCiphertext, rlk: SwitchingKey,
         mod_switch_after: bool = True) -> BgvCiphertext:
    """Homomorphic multiply: tensor, relinearise d2, optionally mod-switch one
    level down (the BGV noise-management analogue of the CKKS rescale)."""
    params = ctx.params
    a, b = _align(a, b)
    qs = _qs(params, a.level)
    trace.record("PMULT", params.n, 4 * (a.level + 1))
    d0 = mo.pointwise_mulmod(a.c0, b.c0, qs)
    d2 = mo.pointwise_mulmod(a.c1, b.c1, qs)
    cross1 = mo.pointwise_mulmod(a.c0, b.c1, qs)
    cross2 = mo.pointwise_mulmod(a.c1, b.c0, qs)
    trace.record("PADD", params.n, a.level + 1)
    d1 = mo.pointwise_addmod(cross1, cross2, qs)
    ks0, ks1 = _relin(ctx, d2, rlk, a.level)
    trace.record("PADD", params.n, 2 * (a.level + 1))
    out = BgvCiphertext(
        c0=mo.pointwise_addmod(d0, ks0, qs), c1=mo.pointwise_addmod(d1, ks1, qs), level=a.level
    )
    return _mod_switch(ctx, out) if mod_switch_after else out


# ---------------------------------------------------------------------------
# modulus switch — the BGV level-drop
# ---------------------------------------------------------------------------


def _mod_switch(ctx, ct: BgvCiphertext) -> BgvCiphertext:
    """Drop q_ℓ: c' = (c − δ)·q_ℓ^{-1} with δ = t·[t^{-1}·c]_{q_ℓ} centred.

    δ ≡ c (mod q_ℓ) makes the division exact; δ ≡ 0 (mod t) and q_ℓ ≡ 1
    (mod t) keep the message mod t while the noise drops by a factor ≈ q_ℓ.
    The dataflow and trace are the CKKS rescale's, plus one single-limb PMULT
    for the t^{-1} twist.  The remainder runs on the ciphertext's device, in
    int64, as the reference's does in u64.
    """
    params = ctx.params
    t = _t(params)
    lv = ct.level
    assert lv >= 1, "cannot mod-switch at level 0"
    q_last = int(params.q_primes[lv])
    qs_rem = _qs(params, lv - 1)
    tinv = pow(t, -1, q_last)
    # the remaining moduli and q_ℓ^{-1} mod each, as (lv, 1) columns: the rescale's tables
    q_rem, qinv = ops.rescale_tables(q_last, qs_rem, ct.c0.device)

    def _one(c):
        # iNTT the dropped limb, twist by t^{-1}, centre, re-scale by t — the
        # centred multiple of t congruent to c mod q_ℓ — then re-embed in the
        # remaining bases, subtract, and divide by q_ℓ.
        last_coeff = poly.to_coeff(c[lv : lv + 1], params, (lv,))
        trace.record("PMULT", params.n, 1)
        u = (last_coeff[0].long() * tinv) % q_last
        u_signed = torch.where(u > q_last // 2, u - q_last, u)
        delta = t * u_signed  # |δ| ≤ t·q_ℓ/2 < 2^47: exact in int64
        rem = (delta[None, :] % q_rem).int()
        rem_eval = poly.to_eval(rem, params, poly.q_idx(params, lv - 1))
        trace.record("PSUB", params.n, lv)
        diff = mo.pointwise_submod(c[:lv], rem_eval, qs_rem)
        trace.record("PMULT", params.n, lv)
        return mo.pointwise_mulmod(diff, qinv.expand(diff.shape), qs_rem)

    return BgvCiphertext(c0=_one(ct.c0), c1=_one(ct.c1), level=lv - 1)
