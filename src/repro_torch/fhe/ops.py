"""CKKS homomorphic operations over eval-domain RNS ciphertexts.

Ciphertexts are pairs of (level+1, N) int32 eval-domain polynomials with a
tracked floating-point scale (Lattigo-style scale management).  All heavy ops
go through the kernel wrappers (CUDA on the card, plain PyTorch on the CPU)
and record trace instructions exactly as the reference package does.  Each op
is implemented once as a context-consuming function; ``FheContext``'s methods
are the public API.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.modops import ops as mo
from repro_torch.kernels.rescale import ops as rescale_ops
from repro_torch.kernels.tables import table
from repro_torch.obs.spans import span

from . import encoder, keyswitch, poly, trace
from .keys import KeySet, PublicKey, SecretKey, SwitchingKey
from .params import CkksParams


@dataclasses.dataclass
class Ciphertext:
    c0: torch.Tensor  # (level+1, N) int32, eval domain
    c1: torch.Tensor
    level: int
    scale: float

    @property
    def nbytes(self) -> int:
        return (self.c0.numel() + self.c1.numel()) * 4


@dataclasses.dataclass
class Plaintext:
    data: torch.Tensor  # (level+1, N) int32, eval domain
    level: int
    scale: float


def _qs(params: CkksParams, level: int) -> tuple[int, ...]:
    return params.q_primes[: level + 1]


def _residues_eval(ctx, coeffs: np.ndarray, level: int) -> torch.Tensor:
    """Host coefficient residues over q_0..q_level → eval domain on the context's device."""
    return poly.to_eval(poly.residues(coeffs, ctx.device), ctx.params, poly.q_idx(ctx.params, level))


# ---------------------------------------------------------------------------
# encode / encrypt / decrypt
# ---------------------------------------------------------------------------


def _encode(ctx, z, level: int | None = None, scale: float | None = None) -> Plaintext:
    with span("fhe.encode"):
        params = ctx.params
        level = params.L if level is None else level
        scale = params.scale if scale is None else scale
        with span("fhe.encode.coeffs"):
            coeffs = encoder.encode(np.asarray(z), params.n, scale, params.q_primes[: level + 1])
        with span("fhe.encode.upload"):
            data = _residues_eval(ctx, coeffs, level)
        return Plaintext(data=data, level=level, scale=scale)


def _encode_const(ctx, c, level: int, scale: float) -> Plaintext:
    """A real constant c encodes to the polynomial round(c·scale), whose NTT
    is that integer's residue in every slot of a limb: the eval-domain
    plaintext is built where it is used, as the column r_i = round(c·scale)
    mod q_i broadcast over N, with the integer passed as a kernel argument
    (no host array, no copy, no NTT).  A complex constant, or a real one of
    2^62 or more, is encoded on the host and transformed."""
    with span("fhe.encode_const"):
        params = ctx.params
        qs = _qs(params, level)
        v = encoder.const_integer(c, scale)
        if v is not None and abs(v) < 1 << 62:
            with span("fhe.encode.const_column"):
                q = poly.limb_column(qs, torch.int64, ctx.device)
                col = torch.remainder(torch.full_like(q, v), q).to(torch.int32)
            return Plaintext(data=col.expand(level + 1, params.n), level=level, scale=scale)
        with span("fhe.encode.coeffs"):
            coeffs = encoder.encode_const(c, params.n, scale, qs)
        with span("fhe.encode.upload"):
            data = _residues_eval(ctx, coeffs, level)
        return Plaintext(data=data, level=level, scale=scale)


def _decode(ctx, pt: Plaintext) -> np.ndarray:
    params = ctx.params
    coeffs = poly.to_coeff(pt.data, params, poly.q_idx(params, pt.level))
    limbs = min(pt.level + 1, 4)
    host = coeffs[:limbs].cpu().numpy().astype(np.uint32)
    return encoder.decode(host, params.q_primes[: pt.level + 1], pt.scale, max_limbs=limbs)


def _encrypt(ctx, pk: PublicKey, pt: Plaintext, seed: int = 17) -> Ciphertext:
    params = ctx.params
    rng = np.random.default_rng(seed)
    level = pt.level
    primes = params.q_primes[: level + 1]
    qs = _qs(params, level)
    v = _residues_eval(ctx, poly.to_rns_signed(poly.sample_ternary(rng, params.n, params.n // 2), primes), level)
    e0 = _residues_eval(ctx, poly.to_rns_signed(poly.sample_gaussian(rng, params.n), primes), level)
    e1 = _residues_eval(ctx, poly.to_rns_signed(poly.sample_gaussian(rng, params.n), primes), level)
    trace.record("PMULT", params.n, 2 * (level + 1))
    c0 = mo.pointwise_addmod(
        mo.pointwise_addmod(mo.pointwise_mulmod(v, pk.b[: level + 1], qs), e0, qs), pt.data, qs
    )
    c1 = mo.pointwise_addmod(mo.pointwise_mulmod(v, pk.a[: level + 1], qs), e1, qs)
    return Ciphertext(c0=c0, c1=c1, level=level, scale=pt.scale)


def _decrypt(ctx, sk: SecretKey, ct: Ciphertext) -> Plaintext:
    params = ctx.params
    qs = _qs(params, ct.level)
    trace.record("PMULT", params.n, ct.level + 1)
    m = mo.pointwise_addmod(ct.c0, mo.pointwise_mulmod(ct.c1, sk.s_eval[: ct.level + 1], qs), qs)
    return Plaintext(data=m, level=ct.level, scale=ct.scale)


# ---------------------------------------------------------------------------
# additive ops
# ---------------------------------------------------------------------------


def _align(params: CkksParams, a: Ciphertext, b: Ciphertext) -> tuple[Ciphertext, Ciphertext]:
    """Drop the deeper ciphertext to the shallower level. Scales must match closely."""
    lv = min(a.level, b.level)
    a = level_drop(a, lv)
    b = level_drop(b, lv)
    assert abs(a.scale / b.scale - 1.0) < 1e-9, f"scale mismatch {a.scale} vs {b.scale}"
    return a, b


def level_drop(ct: Ciphertext, level: int) -> Ciphertext:
    if level == ct.level:
        return ct
    assert level < ct.level
    return Ciphertext(c0=ct.c0[: level + 1], c1=ct.c1[: level + 1], level=level, scale=ct.scale)


def _add(ctx, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    params = ctx.params
    a, b = _align(params, a, b)
    qs = _qs(params, a.level)
    trace.record("PADD", params.n, 2 * (a.level + 1))
    return Ciphertext(
        c0=mo.pointwise_addmod(a.c0, b.c0, qs),
        c1=mo.pointwise_addmod(a.c1, b.c1, qs),
        level=a.level, scale=a.scale,
    )


def _sub(ctx, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    params = ctx.params
    a, b = _align(params, a, b)
    qs = _qs(params, a.level)
    trace.record("PSUB", params.n, 2 * (a.level + 1))
    return Ciphertext(
        c0=mo.pointwise_submod(a.c0, b.c0, qs),
        c1=mo.pointwise_submod(a.c1, b.c1, qs),
        level=a.level, scale=a.scale,
    )


def _negate(ctx, a: Ciphertext) -> Ciphertext:
    params = ctx.params
    qs = _qs(params, a.level)
    z = torch.zeros_like(a.c0)
    trace.record("PSUB", params.n, 2 * (a.level + 1))
    return Ciphertext(
        c0=mo.pointwise_submod(z, a.c0, qs),
        c1=mo.pointwise_submod(z, a.c1, qs),
        level=a.level, scale=a.scale,
    )


def _add_plain(ctx, a: Ciphertext, pt: Plaintext) -> Ciphertext:
    params = ctx.params
    assert pt.level >= a.level
    qs = _qs(params, a.level)
    trace.record("PADD", params.n, a.level + 1)
    return Ciphertext(
        c0=mo.pointwise_addmod(a.c0, pt.data[: a.level + 1], qs),
        c1=a.c1, level=a.level, scale=a.scale,
    )


def _add_const(ctx, a: Ciphertext, c) -> Ciphertext:
    return _add_plain(ctx, a, _encode_const(ctx, c, a.level, a.scale))


# ---------------------------------------------------------------------------
# multiplicative ops
# ---------------------------------------------------------------------------


def _mul_plain(ctx, a: Ciphertext, pt: Plaintext, rescale_after: bool = True) -> Ciphertext:
    params = ctx.params
    assert pt.level >= a.level
    qs = _qs(params, a.level)
    trace.record("PMULT", params.n, 2 * (a.level + 1))
    d = pt.data[: a.level + 1]
    out = Ciphertext(
        c0=mo.pointwise_mulmod(a.c0, d, qs),
        c1=mo.pointwise_mulmod(a.c1, d, qs),
        level=a.level, scale=a.scale * pt.scale,
    )
    return _rescale(ctx, out) if rescale_after else out


def _mul_const(ctx, a: Ciphertext, c, rescale_after: bool = True) -> Ciphertext:
    return _mul_plain(ctx, a, _encode_const(ctx, c, a.level, ctx.params.scale), rescale_after)


def _mul_const_exact(ctx, a: Ciphertext, c, target_scale: float) -> Ciphertext:
    """a·c with the constant's encoding scale chosen so the rescaled result has
    exactly ``target_scale`` — the anchor that keeps scale bookkeeping from
    drifting through multiplicative trees (see polyeval).  The float
    expression is the reference package's, in its order: another rounding of
    the encoding scale is another plaintext, and so another ciphertext."""
    params = ctx.params
    q = float(params.q_primes[a.level])
    enc_scale = target_scale * q / a.scale
    assert enc_scale > 256.0, f"enc_scale underflow ({enc_scale}); scale drift upstream"
    pt = _encode_const(ctx, c, a.level, enc_scale)
    out = _mul_plain(ctx, a, pt, rescale_after=True)
    return Ciphertext(out.c0, out.c1, out.level, target_scale)


def _mul(ctx, a: Ciphertext, b: Ciphertext, rlk: SwitchingKey, rescale_after: bool = True) -> Ciphertext:
    """Full homomorphic multiplication with relinearisation (key-switch of d2)."""
    params = ctx.params
    lv = min(a.level, b.level)
    a, b = level_drop(a, lv), level_drop(b, lv)
    qs = _qs(params, lv)
    trace.record("PMULT", params.n, 4 * (lv + 1))
    d0 = mo.pointwise_mulmod(a.c0, b.c0, qs)
    d2 = mo.pointwise_mulmod(a.c1, b.c1, qs)
    cross1 = mo.pointwise_mulmod(a.c0, b.c1, qs)
    cross2 = mo.pointwise_mulmod(a.c1, b.c0, qs)
    trace.record("PADD", params.n, lv + 1)
    d1 = mo.pointwise_addmod(cross1, cross2, qs)
    with span("fhe.keyswitch"):
        ks0, ks1 = keyswitch.key_switch(d2, params, lv, rlk, ctx.plan_fused)
    trace.record("PADD", params.n, 2 * (lv + 1))
    out = Ciphertext(
        c0=mo.pointwise_addmod(d0, ks0, qs),
        c1=mo.pointwise_addmod(d1, ks1, qs),
        level=lv, scale=a.scale * b.scale,
    )
    return _rescale(ctx, out) if rescale_after else out


@table("rescale_tables")
def rescale_tables(q_last: int, qs_rem: tuple[int, ...], device: torch.device):
    """The remaining moduli's (l, 1) int64 column and q_last^{-1} mod each,
    an (l, 1) int32 column, on ``device``."""
    qinv = np.array([pow(q_last % q, -1, q) for q in qs_rem], np.int32)
    return poly.limb_column(qs_rem, torch.int64, device), torch.as_tensor(qinv[:, None], device=device)


def _rescale(ctx, ct: Ciphertext) -> Ciphertext:
    """Divide by q_ℓ and drop a level (eval-domain RNS rescale).

    Under the fused pipeline both components are one ``fused_rescale`` call
    (an ``fhe.rescale.fused`` span) that records the reference's instructions
    in its order; the staged pipeline runs the reference's composition."""
    params = ctx.params
    lv = ct.level
    assert lv >= 1, "cannot rescale at level 0"
    q_last = int(params.q_primes[lv])
    if ctx.plan_fused:
        with span("fhe.rescale"):
            for _ in range(2):
                trace.record("INTT", params.n, 1)
                trace.record("NTT", params.n, lv)
                trace.record("PSUB", params.n, lv)
                trace.record("PMULT", params.n, lv)
            with span("fhe.rescale.fused"):
                c0, c1 = rescale_ops.rescale(ct.c0, ct.c1, params, lv)
            return Ciphertext(c0=c0, c1=c1, level=lv - 1, scale=ct.scale / q_last)
    qs_rem = _qs(params, lv - 1)
    q_rem, qinv_t = rescale_tables(q_last, qs_rem, ct.c0.device)

    def _one(c):
        # iNTT the dropped limb, re-embed its (centred) coefficients in every
        # remaining basis, NTT back, subtract, multiply by q_ℓ^{-1}.
        last_coeff = poly.to_coeff(c[lv : lv + 1], params, (lv,))
        v = last_coeff[0].long()
        centered = torch.where(v > q_last // 2, v + q_rem - q_last, v)
        rem = (centered % q_rem).int()
        rem_eval = poly.to_eval(rem, params, poly.q_idx(params, lv - 1))
        trace.record("PSUB", params.n, lv)
        diff = mo.pointwise_submod(c[:lv], rem_eval, qs_rem)
        trace.record("PMULT", params.n, lv)
        return mo.pointwise_mulmod(diff, qinv_t.expand(diff.shape), qs_rem)

    with span("fhe.rescale"):
        return Ciphertext(c0=_one(ct.c0), c1=_one(ct.c1), level=lv - 1, scale=ct.scale / q_last)


# ---------------------------------------------------------------------------
# rotations / conjugation
# ---------------------------------------------------------------------------


def _rotate(ctx, ct: Ciphertext, r: int, keys: KeySet) -> Ciphertext:
    """Cyclic left-rotation of the slot vector by r (σ_{5^r} + key switch).

    The policy's hoisting mode selects the key-switch shape: "never"/"auto"
    run the standard per-rotation ModUp (a single rotation has nothing to
    amortise); "always" routes through the hoisted path — bit-exact either
    way.  Groups of rotations of the same ciphertext should use
    ``rotate_hoisted_group`` to actually share the ModUp.
    """
    if r % ctx.params.slots == 0:
        return ct
    if ctx.policy.hoisting == "always":
        return _rotate_hoisted(ctx, ct, r, keys)
    return _rotate_standard(ctx, ct, r, keys)


def _rotate_standard(ctx, ct: Ciphertext, r: int, keys: KeySet) -> Ciphertext:
    """Per-rotation key switch regardless of the policy's hoisting mode —
    the path for rotations of *distinct* ciphertexts (e.g. BSGS giant steps),
    which can never share a ModUp."""
    params = ctx.params
    if r % params.slots == 0:
        return ct
    t = pow(5, r % params.slots, 2 * params.n)
    return _apply_galois(ctx, ct, t, keys)


def _rotate_hoisted(ctx, ct: Ciphertext, r: int, keys: KeySet,
                    hoisted: keyswitch.HoistedDigits | None = None) -> Ciphertext:
    """Hoisted rotation: reuse (or build) the ModUp decomposition of ct.c1.

    Pass ``hoisted=keyswitch.hoisted_mod_up(ct.c1, ...)`` to amortise the
    ModUp across several calls on the same ciphertext; each call then costs
    only KSK-MAC + ModDown + one automorphism.  Bit-exact vs ``rotate``.
    """
    params = ctx.params
    if r % params.slots == 0:
        return ct
    t = pow(5, r % params.slots, 2 * params.n)
    with span("fhe.keyswitch"):
        hd = hoisted if hoisted is not None else keyswitch.hoisted_mod_up(ct.c1, params, ct.level, ctx.plan_fused)
        c0, c1 = keyswitch.rotate_hoisted(ct.c0, hd, t, keys, params, ct.level, ctx.plan_fused)
    return Ciphertext(c0=c0, c1=c1, level=ct.level, scale=ct.scale)


def _rotate_hoisted_group(ctx, ct: Ciphertext, rots, keys: KeySet) -> dict[int, Ciphertext]:
    """Halevi–Shoup hoisting: ONE ModUp shared by every rotation in ``rots``.

    The fused pipeline batches the whole group: one ModUp launch, one Galois
    KSK-MAC launch covering every rotation's key, and one batched ModDown
    launch — O(β + k) extended-basis NTTs for k rotations instead of O(k·β).
    Returns {r: rotated ciphertext} keyed by the input rotation values; each
    entry is bit-exact vs ``rotate``.
    """
    params = ctx.params
    fused = ctx.plan_fused
    uniq: dict[int, int] = {}  # r mod slots → galois element
    for r in rots:
        rm = r % params.slots
        if rm and rm not in uniq:
            uniq[rm] = pow(5, rm, 2 * params.n)
    if not uniq:
        return {r: ct for r in rots}
    lv = ct.level
    by_rm: dict[int, Ciphertext] = {}
    with span("fhe.keyswitch"):
        hd = keyswitch.hoisted_mod_up(ct.c1, params, lv, fused)
        ksk_stack = torch.stack([keyswitch.hoisted_ksk(params, keys, t, lv) for t in uniq.values()])
        accs = keyswitch.hoisted_galois_ks(hd, ksk_stack, params, lv, fused)
        ks = keyswitch.mod_down_group(accs, params, lv, fused)
        for i, (rm, t) in enumerate(uniq.items()):
            c0, c1 = keyswitch.permute_last(ct.c0, ks[i, 0], ks[i, 1], t, params, lv)
            by_rm[rm] = Ciphertext(c0=c0, c1=c1, level=lv, scale=ct.scale)
    return {r: (by_rm[r % params.slots] if r % params.slots else ct) for r in rots}


def _conjugate(ctx, ct: Ciphertext, keys: KeySet) -> Ciphertext:
    return _apply_galois(ctx, ct, 2 * ctx.params.n - 1, keys)


def _apply_galois(ctx, ct: Ciphertext, t: int, keys: KeySet) -> Ciphertext:
    """Key-switched automorphism σ_t, permute-last formulation.

    The key-switch runs against the σ_t^{-1}-pre-permuted Galois key and the
    shared ``keyswitch.permute_last`` epilogue lands the result.  This is the
    same per-digit math as the hoisted path, so ``rotate`` and
    ``rotate_hoisted``/``rotate_hoisted_group`` are bit-exact against each
    other, and the trace shape matches the classic permute-first pipeline
    (2×AUTO + key-switch + PADD).
    """
    params = ctx.params
    lv = ct.level
    with span("fhe.keyswitch"):
        ksk_pre = keyswitch.hoisted_ksk(params, keys, t, lv)
        ks0, ks1 = keyswitch.key_switch_selected(ct.c1, params, lv, ksk_pre, ctx.plan_fused)
        c0, c1 = keyswitch.permute_last(ct.c0, ks0, ks1, t, params, lv)
    return Ciphertext(c0=c0, c1=c1, level=lv, scale=ct.scale)
