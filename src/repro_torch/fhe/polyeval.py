"""Homomorphic polynomial evaluation in the Chebyshev basis.

Used by EvalMod (homomorphic sine) in bootstrapping.  Depth is
⌈log2(degree)⌉+1 levels: T_j is built by the product rule
T_{a+b} = 2·T_a·T_b − T_{|a−b|} with a ≈ b ≈ j/2, then the polynomial is a
single plaintext linear combination over the basis.

Scale discipline (exact — no tolerance fudging):
  * T_{|a−b|} always lives at a strictly higher level than the product, so the
    subtraction aligns through `force_to`, which folds the exact scale ratio
    into a mul-by-one plaintext (rounding ≤ 2^-25 relative).
  * the linear combination encodes each coefficient at scale
    s*·q_ℓ/s_i so every term lands at exactly (level*, s*).

Every encoding scale is the reference package's float expression, in its
order, so both packages encode the same plaintexts and give the same
ciphertexts bit for bit.

Evaluate through a context: ``ctx.eval_poly(ct, coeffs)`` (or
``ctx.chebyshev_basis`` + ``ctx.eval_chebyshev`` to reuse a basis).
"""

from __future__ import annotations

import numpy as np

from repro_torch.obs.spans import span

from . import ops


SIGMOID3 = (0.5, 0.15012, 0.0, -0.0015930)  # σ3: power coefficients, least squares on [−8, 8] (Kim et al. 2018)


def chebyshev_on_unit(power, bound: float) -> np.ndarray:
    """Chebyshev coefficients of t ↦ p(bound·t) on [−1, 1], p in the power basis."""
    return np.polynomial.chebyshev.poly2cheb([c * bound**k for k, c in enumerate(power)])


def chebyshev_fit(f, degree: int, k: float = 1.0) -> np.ndarray:
    """Chebyshev coefficients of f on [-k, k] (degree+1 coeffs)."""
    cheb = np.polynomial.chebyshev.Chebyshev.interpolate(f, degree, domain=[-k, k])
    return cheb.coef


# ---------------------------------------------------------------------------
# context implementations
# ---------------------------------------------------------------------------


def _force_to(ctx, ct: ops.Ciphertext, level: int, scale: float) -> ops.Ciphertext:
    """Bring ct to exactly (level, scale).

    Exact whenever ≥1 level is consumed: the scale ratio is folded into a
    mul-by-one encoded at scale  target·q_{lv+1}/current  (≈ 2^30 ≫ 1),
    followed by one rescale.
    """
    params = ctx.params
    assert ct.level >= level
    if ct.level == level:
        if scale != ct.scale:
            assert abs(scale / ct.scale - 1.0) < 1e-7, (
                f"same-level scale mismatch {ct.scale} vs {scale} — exact-scale "
                "discipline violated upstream"
            )
            ct = ops.Ciphertext(ct.c0, ct.c1, ct.level, scale)
        return ct
    ct = ops.level_drop(ct, level + 1)
    q = float(params.q_primes[level + 1])
    enc_scale = scale * q / ct.scale
    pt = ops._encode_const(ctx, 1.0, ct.level, enc_scale)
    out = ops._mul_plain(ctx, ct, pt, rescale_after=True)
    return ops.Ciphertext(out.c0, out.c1, out.level, scale)  # exact by construction


def _add_any(ctx, a: ops.Ciphertext, b: ops.Ciphertext) -> ops.Ciphertext:
    """Add ciphertexts at arbitrary levels (aligns to the deeper one, exactly)."""
    if a.level < b.level:
        b = _force_to(ctx, b, a.level, a.scale)
    elif b.level < a.level:
        a = _force_to(ctx, a, b.level, b.scale)
    elif a.scale != b.scale:
        b = _force_to(ctx, b, a.level, a.scale)  # asserts near-equality
    return ops._add(ctx, a, b)


class ChebyshevBasis:
    """T_1..T_degree over a normalised input x ∈ [-1, 1] (log-depth tree).

    Built through a context: ``ChebyshevBasis(ctx, x, degree)`` or
    ``ctx.chebyshev_basis(x, degree)``.
    """

    def __init__(self, ctx, x: ops.Ciphertext, degree: int):
        from .context import FheContext

        assert isinstance(ctx, FheContext) and isinstance(degree, int), "ChebyshevBasis(ctx, x, degree)"
        self.ctx = ctx
        self.params = ctx.params
        self.keys = ctx.keys
        self.degree = degree
        self.backend = ctx.backend
        self.t: dict[int, ops.Ciphertext] = {1: x}
        with span("fhe.cheb.basis"):
            for j in range(2, degree + 1):
                self.t[j] = self._pair(j)

    def _pair(self, j: int) -> ops.Ciphertext:
        """T_j = 2·T_a·T_b − T_{|a−b|},  a = ⌊j/2⌋."""
        ctx = self.ctx
        a = j // 2
        b = j - a
        prod = ops._mul(ctx, self.t[a], self.t[b], ctx.require_keys().rlk)  # rescaled
        two = ops._add(ctx, prod, prod)
        if a == b:
            return ops._add_const(ctx, two, -1.0)
        # T_{|a-b|} = T_{b-a} was built earlier ⇒ strictly higher level ⇒ exact
        return _add_any(ctx, two, ops._negate(ctx, self.t[b - a]))

    def min_level(self) -> int:
        return min(ct.level for ct in self.t.values())


def _eval_chebyshev(ctx, basis: ChebyshevBasis, coeffs: np.ndarray) -> ops.Ciphertext:
    """Σ c_i·T_i(x) as one exact plaintext linear combination."""
    with span("fhe.cheb.combine"):
        params = ctx.params
        c = np.asarray(coeffs, dtype=np.float64)
        assert len(c) - 1 <= basis.degree
        s_star = params.scale
        lv_star = basis.min_level() - 1

        acc: ops.Ciphertext | None = None
        for i in range(1, len(c)):
            if abs(c[i]) < 1e-14:
                continue
            ti = basis.t[i]
            # encode so the rescaled product lands at exactly (ti.level-1, s*)
            enc_scale = s_star * float(params.q_primes[ti.level]) / ti.scale
            assert enc_scale > 256.0, f"enc_scale underflow at T_{i} (scale drift)"
            pt = ops._encode_const(ctx, float(c[i]), ti.level, enc_scale)
            term = ops._mul_plain(ctx, ti, pt, rescale_after=True)
            term = ops.Ciphertext(term.c0, term.c1, term.level, s_star)  # exact
            term = _force_to(ctx, term, lv_star, s_star)
            acc = term if acc is None else ops._add(ctx, acc, term)
        if acc is None:
            z = ops._mul_const(ctx, basis.t[1], 0.0)
            acc = _force_to(ctx, ops.Ciphertext(z.c0, z.c1, z.level, s_star), lv_star, s_star)
        if abs(c[0]) > 1e-14:
            acc = ops._add_const(ctx, acc, float(c[0]))
        return acc
