"""The port's Chebyshev evaluation and scale anchors against the reference package on the CPU.

``chebyshev_basis``, ``eval_chebyshev``, ``eval_poly``, ``force_to``,
``add_any`` and ``mul_const_exact`` must give the reference's ciphertexts bit
for bit (the encoding scales are float expressions, so one reordered product
would show here), at n = 2^9 with one and two key-switch digits.  The
reference runs its ``ref`` backend; the port runs its fused pipeline and, for
the trace and dispatch comparison, ``ref`` too: there the port's streams are
the reference's less the NTT of each real constant, which the port builds
with none.
"""

import numpy as np
import pytest
import reference_constants
import torch

from repro.fhe import keys as R_K
from repro.fhe import params as R_P
from repro.fhe import trace as R_trace
from repro.fhe.context import ExecPolicy as R_Policy
from repro.fhe.context import FheContext as R_Ctx
from repro.kernels import dispatch as R_dispatch
from repro_torch import fhe as T_fhe
from repro_torch.fhe import keys as T_K
from repro_torch.fhe import params as T_P
from repro_torch.fhe import polyeval as T_pe
from repro_torch.fhe import trace as T_trace
from repro_torch.fhe.context import ExecPolicy as T_Policy
from repro_torch.fhe.context import FheContext as T_Ctx
from repro_torch.kernels import dispatch as T_dispatch

torch.set_num_threads(1)

CPU = "cpu"
L = 7


def _ct_eq(port, ref):
    np.testing.assert_array_equal(port.c0.numpy().astype(np.int64), np.asarray(ref.c0).astype(np.int64))
    np.testing.assert_array_equal(port.c1.numpy().astype(np.int64), np.asarray(ref.c1).astype(np.int64))
    assert (port.level, port.scale) == (ref.level, ref.scale)


def _stream(instrs):
    return [(i.op, i.n, i.limbs, i.meta) for i in instrs]


@pytest.fixture(scope="module", params=[1, 2], ids=lambda d: f"dnum={d}")
def pair(request):
    dnum = request.param
    rp = R_P.make_params(1 << 9, L, dnum, check_security=False)
    tp = T_P.make_params(1 << 9, L, dnum, check_security=False)
    rctx = R_Ctx(params=rp, keys=R_K.full_keyset(rp, seed=4), policy=R_Policy(backend="ref"))
    tctx = T_Ctx(params=tp, keys=T_K.full_keyset(tp, seed=4, device=CPU), policy=T_Policy(backend="fused"), device=CPU)
    x = np.random.default_rng(5).uniform(-0.9, 0.9, size=tp.slots)
    return rctx, rctx.encrypt(rctx.encode(x)), tctx, tctx.encrypt(tctx.encode(x)), x


def _coeffs(degree):
    c = np.random.default_rng(degree).normal(size=degree + 1) / np.arange(1, degree + 2)
    c[2] = 1e-15  # below the skip threshold: no term
    return c


@pytest.mark.parametrize("degree", [7, 15])
def test_chebyshev_basis_and_eval_match_reference(pair, degree):
    rctx, rct, tctx, tct, x = pair
    rb, tb = rctx.chebyshev_basis(rct, degree), tctx.chebyshev_basis(tct, degree)
    assert sorted(tb.t) == sorted(rb.t) == list(range(1, degree + 1))
    for j in rb.t:
        _ct_eq(tb.t[j], rb.t[j])
    assert tb.min_level() == rb.min_level() == L - degree.bit_length()
    c = _coeffs(degree)
    got = tctx.eval_chebyshev(tb, c)
    _ct_eq(got, rctx.eval_chebyshev(rb, c))
    _ct_eq(tctx.eval_poly(tct, c), rctx.eval_poly(rct, c))
    want = np.polynomial.chebyshev.Chebyshev(c)(x)
    np.testing.assert_allclose(tctx.decrypt_decode(got).real, want, atol=1e-3)


def test_eval_poly_trace_and_dispatches_match_reference(pair):
    """The reference's streams less the NTT instruction and the ``ntt``
    dispatch of each real constant, which the port builds with no NTT."""
    rctx, rct, tctx, tct, _ = pair
    c = _coeffs(7)
    tref = tctx.with_policy(backend="ref")
    with reference_constants.track() as marks:
        with T_trace.capture_trace() as tt, T_dispatch.count_dispatches() as tc:
            got = tref.eval_poly(tct, c)
        with R_trace.capture_trace() as rt, R_dispatch.count_dispatches() as rc:
            want = rctx.eval_poly(rct, c)
    _ct_eq(got, want)
    assert _stream(tt) == _stream(marks.stream(rt))
    assert tc == marks.counts(rc, rt)
    removed = len(marks.of(rt))
    assert removed == marks.port_constants(tt) == rc["ntt"] - tc.get("ntt", 0) > 0


def test_eval_chebyshev_of_zero_and_constant_polynomials(pair):
    rctx, rct, tctx, tct, _ = pair
    rb, tb = rctx.chebyshev_basis(rct, 3), tctx.chebyshev_basis(tct, 3)
    for c in (np.zeros(4), np.array([0.25, 0.0, 1e-15])):
        _ct_eq(tctx.eval_chebyshev(tb, c), rctx.eval_chebyshev(rb, c))


@pytest.mark.parametrize("drop, factor", [(0, 1.0), (0, 1 + 1e-9), (1, 1.01), (4, 0.97)])
def test_force_to_matches_reference(pair, drop, factor):
    rctx, rct, tctx, tct, x = pair
    level, scale = L - drop, tct.scale * factor
    got = tctx.force_to(tct, level, scale)
    _ct_eq(got, rctx.force_to(rct, level, scale))
    assert (got.level, got.scale) == (level, scale)
    np.testing.assert_allclose(tctx.decrypt_decode(got).real, x, atol=2e-3)  # the ratio is folded in


def test_force_to_keeps_the_reference_asserts(pair):
    rctx, rct, tctx, tct, _ = pair
    for ctx, ct in ((tctx, tct), (rctx, rct)):
        with pytest.raises(AssertionError, match="same-level scale mismatch"):
            ctx.force_to(ct, ct.level, ct.scale * 1.001)
        with pytest.raises(AssertionError):
            ctx.force_to(ctx.level_drop(ct, 2), 3, ct.scale)


def test_add_any_matches_reference(pair):
    rctx, rct, tctx, tct, _ = pair
    rsq, tsq = rctx.square(rct), tctx.square(tct)  # one level down, scale Δ²/q_L
    for ra, rb, ta, tb in ((rct, rsq, tct, tsq), (rsq, rct, tsq, tct), (rct, rct, tct, tct)):
        _ct_eq(tctx.add_any(ta, tb), rctx.add_any(ra, rb))


@pytest.mark.parametrize("c, target", [(0.5, None), (-1.75, 2.0 ** 29), (0.3 + 0.2j, None)])
def test_mul_const_exact_matches_reference(pair, c, target):
    rctx, rct, tctx, tct, x = pair
    target = tct.scale if target is None else target
    got = tctx.mul_const_exact(tct, c, target)
    _ct_eq(got, rctx.mul_const_exact(rct, c, target))
    assert (got.level, got.scale) == (L - 1, target)
    np.testing.assert_allclose(tctx.decrypt_decode(got), c * x, atol=2e-3)
    with pytest.raises(AssertionError, match="enc_scale underflow"):
        tctx.mul_const_exact(tct, c, 1.0)


def test_polyeval_is_exported_and_fits_like_the_reference():
    from repro.fhe import polyeval as R_pe

    assert T_fhe.polyeval is T_pe and "polyeval" in dir(T_fhe)
    f = lambda v: np.sin(3 * v)
    for degree, k in ((7, 1.0), (32, 2.5)):
        np.testing.assert_array_equal(T_pe.chebyshev_fit(f, degree, k), R_pe.chebyshev_fit(f, degree, k))
