"""The port's BSGS linear transforms against the reference package on the CPU.

Plans (n1, diagonals, rotation sets, the cost model) must equal the
reference's, and ``apply_bsgs``, ``apply_bsgs_pair``, ``real_part`` and
``imag_part`` must give its bytes exactly under every hoisting mode, with the
same ``fhe.trace`` stream and the same kernel-dispatch counts, but that a
matvec's products and sums are one ``bsgsmac`` dispatch (``reference_bsgs``).
The last test runs the
encrypted MLP of ``examples/fhe_inference.py`` at the ``lola_mnist_plain``
preset's full width (N = 2^13) against the digests ``chip_smoke.py`` checks
on the card."""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import reference_bsgs
import reference_rescale
import torch

from repro.fhe import keys as R_K
from repro.fhe import linear as R_lin
from repro.fhe import params as R_P
from repro.fhe import trace as R_trace
from repro.fhe.context import ExecPolicy as R_Policy
from repro.fhe.context import FheContext as R_Ctx
from repro.kernels import dispatch as R_dispatch
from repro_torch import fhe as T_fhe
from repro_torch.fhe import keys as T_K
from repro_torch.fhe import linear as T_lin
from repro_torch.fhe import params as T_P
from repro_torch.fhe import trace as T_trace
from repro_torch.fhe.context import ExecPolicy as T_Policy
from repro_torch.fhe.context import FheContext as T_Ctx
from repro_torch.kernels import dispatch as T_dispatch

torch.set_num_threads(1)

CPU = "cpu"


def _np(x):
    return np.asarray(x).astype(np.int64)


def _ct_eq(port, ref):
    np.testing.assert_array_equal(port.c0.numpy().astype(np.int64), _np(ref.c0))
    np.testing.assert_array_equal(port.c1.numpy().astype(np.int64), _np(ref.c1))
    assert (port.level, port.scale) == (ref.level, ref.scale)


def _stream(instrs):
    return [(i.op, i.n, i.limbs, i.meta) for i in instrs]


def _fresh(plan):
    """A copy of ``plan`` that holds no encoded diagonal yet: applied once, it
    encodes every diagonal as the reference does, so the streams compare whole."""
    return dataclasses.replace(plan)


def _plans_eq(port, ref):
    assert port.n1 == ref.n1
    assert sorted(port.diags) == sorted(ref.diags)
    for d in ref.diags:
        np.testing.assert_array_equal(port.diags[d], ref.diags[d])
    assert port.rotations() == ref.rotations()
    assert port.baby_steps() == ref.baby_steps() and port.giant_steps() == ref.giant_steps()


# ---------------------------------------------------------------------------
# planning: pure numpy, equal to the reference's
# ---------------------------------------------------------------------------


def test_choose_n1_shifts_under_hoisting():
    """The radix-32 CtS stage shape (63 diagonals): n1 = 8 unhoisted, 16 hoisted."""
    rp = R_P.make_params(1 << 14, 3, 3, check_security=False)
    tp = T_P.make_params(1 << 14, 3, 3, check_security=False)
    assert T_lin.choose_n1(range(63), tp, tp.L, hoisted=False) == 8
    assert T_lin.choose_n1(range(63), tp, tp.L, hoisted=True) == 16
    assert T_lin.choose_n1((), tp, tp.L, hoisted=True) == 1
    for hoisted in (False, True):
        for n1 in (1, 2, 4, 8, 16, 32, 64):
            assert T_lin.bsgs_rotation_cost(range(63), n1, tp, tp.L, hoisted) == R_lin.bsgs_rotation_cost(
                range(63), n1, rp, rp.L, hoisted)


@pytest.mark.parametrize("hoisting", [False, True])
@pytest.mark.parametrize("tol", [0.0, 1e-12])
def test_plan_matrix_and_plan_diags_match_reference(hoisting, tol):
    rp = R_P.make_params(1 << 9, 5, 2, check_security=False)
    tp = T_P.make_params(1 << 9, 5, 2, check_security=False)
    rng = np.random.default_rng(0)
    m = np.zeros((tp.slots, tp.slots), np.complex128)
    for d in (0, 1, 2, 5, 40, 200):
        m[np.arange(tp.slots), (np.arange(tp.slots) + d) % tp.slots] = rng.normal(size=tp.slots)
    _plans_eq(T_lin.plan_matrix(m, tol=tol), R_lin.plan_matrix(m, tol=tol))
    _plans_eq(T_lin.plan_matrix(m, tol=tol, params=tp, level=3, hoisting=hoisting),
              R_lin.plan_matrix(m, tol=tol, params=rp, level=3, hoisting=hoisting))
    assert T_lin.plan_matrix(m, n1=4, params=tp, hoisting=hoisting).n1 == 4
    diags = {d: np.ones(tp.slots, np.complex128) for d in range(7)}
    _plans_eq(T_lin.plan_diags(diags, tp, hoisting=hoisting), R_lin.plan_diags(diags, rp, hoisting=hoisting))


def test_linear_is_exported_and_plans_cache_rotations():
    assert T_fhe.linear is T_lin
    assert "linear" in dir(T_fhe)
    plan = T_lin.plan_diags({d: np.ones(4) for d in (0, 3, 9, 17)}, T_P.make_params(1 << 9, 2, 1, check_security=False),
                            n1=8)
    assert plan.rotations() is plan.rotations() and plan.baby_steps() is plan.baby_steps()
    assert plan.baby_steps() == (1, 3) and plan.giant_steps() == (8, 16)


# ---------------------------------------------------------------------------
# apply_bsgs under every hoisting mode
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BSet:
    rp: object
    rctx: object
    rct: object
    tp: object
    tctx: object
    tct: object
    mat: np.ndarray
    z: np.ndarray
    rplan: object
    tplan: object


@pytest.fixture(scope="module")
def bset():
    rp = R_P.make_params(1 << 9, 5, 2, check_security=False)
    tp = T_P.make_params(1 << 9, 5, 2, check_security=False)
    rng = np.random.default_rng(3)
    mat = (rng.normal(size=(tp.slots, tp.slots)) + 1j * rng.normal(size=(tp.slots, tp.slots))) / tp.slots
    band = np.zeros_like(mat)  # n1 = 16: babies 1, 2, 3, 5, 8 and giants 16, 32
    for d in (0, 1, 2, 3, 5, 17, 40):
        band[np.arange(tp.slots), (np.arange(tp.slots) + d) % tp.slots] = mat[d]
    rplan, tplan = R_lin.plan_matrix(band, tol=1e-12), T_lin.plan_matrix(band, tol=1e-12)
    rots = tuple(sorted(tplan.rotations()))
    rctx = R_Ctx(params=rp, keys=R_K.full_keyset(rp, seed=1, rotations=rots, conjugate=True),
                 policy=R_Policy(backend="ref"))
    tctx = T_Ctx(params=tp, keys=T_K.full_keyset(tp, seed=1, rotations=rots, conjugate=True, device=CPU),
                 policy=T_Policy(backend="ref"), device=CPU)
    z = rng.normal(size=tp.slots) * 0.5
    return BSet(rp, rctx, rctx.encrypt(rctx.encode(z)), tp, tctx, tctx.encrypt(tctx.encode(z)), band, z,
                rplan, tplan)


@pytest.mark.parametrize("hoisting", ["never", "auto", "always"])
def test_apply_bsgs_matches_reference_with_equal_trace_and_dispatches(bset, hoisting):
    b = bset
    _plans_eq(b.tplan, b.rplan)
    tctx, rctx = b.tctx.with_policy(hoisting=hoisting), b.rctx.with_policy(hoisting=hoisting)
    with T_trace.capture_trace() as tt, T_dispatch.count_dispatches() as tc:
        got = tctx.apply_bsgs(b.tct, _fresh(b.tplan))
    with R_trace.capture_trace() as rt, R_dispatch.count_dispatches() as rc:
        want = rctx.apply_bsgs(b.rct, b.rplan)
    _ct_eq(got, want)
    assert _stream(tt) == _stream(rt)
    assert tc == reference_bsgs.port_counts(rc, [b.rplan])
    np.testing.assert_allclose(tctx.decrypt_decode(got), b.mat @ b.z, atol=5e-2)


@pytest.mark.parametrize("hoisting", ["never", "always"])
def test_apply_bsgs_fused_pipeline_matches_reference(bset, hoisting):
    """The fused pipeline (hoisted group: one ModUp, one MAC, one ModDown launch)."""
    b = bset
    tctx = b.tctx.with_policy(backend="fused", hoisting=hoisting)
    rctx = b.rctx.with_policy(backend="fused", hoisting=hoisting)
    with T_dispatch.count_dispatches() as tc:
        got = tctx.apply_bsgs(b.tct, _fresh(b.tplan))
    with reference_rescale.track() as marks, R_dispatch.count_dispatches() as rc:
        want = rctx.apply_bsgs(b.rct, b.rplan)
    _ct_eq(got, want)
    assert marks.count == 1
    assert tc == reference_bsgs.port_counts(marks.counts(rc), [b.rplan])
    assert ("hoistmac" in tc) == (hoisting == "always")


def test_apply_bsgs_pair_and_scale(bset):
    b = bset
    other = T_lin.plan_matrix(b.mat * (0.5 - 0.25j), tol=1e-12)
    rother = R_lin.plan_matrix(b.mat * (0.5 - 0.25j), tol=1e-12)
    assert other.rotations() == b.tplan.rotations()
    got = b.tctx.apply_bsgs_pair(b.tct, (b.tplan, other), scale=b.tp.scale)
    want = b.rctx.apply_bsgs_pair(b.rct, (b.rplan, rother), scale=b.rp.scale)
    for g, w in zip(got, want):
        _ct_eq(g, w)


def test_context_plan_matrix_follows_policy(bset):
    b = bset
    for hoisting in ("never", "always"):
        _plans_eq(b.tctx.with_policy(hoisting=hoisting).plan_matrix(b.mat, tol=1e-12, level=4),
                  b.rctx.with_policy(hoisting=hoisting).plan_matrix(b.mat, tol=1e-12, level=4))


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_real_and_imag_part_match_reference(bset, backend):
    b = bset
    rng = np.random.default_rng(9)
    w = (rng.normal(size=b.tp.slots) + 1j * rng.normal(size=b.tp.slots)) * 0.3
    tct = b.tctx.encrypt(b.tctx.encode(w))
    rct = b.rctx.encrypt(b.rctx.encode(w))
    tctx, rctx = b.tctx.with_policy(backend=backend), b.rctx.with_policy(backend=backend)
    for name in ("real_part", "imag_part"):
        with T_dispatch.count_dispatches() as tc:
            got = getattr(tctx, name)(tct)
        with reference_rescale.track() as marks, R_dispatch.count_dispatches() as rc:
            want = getattr(rctx, name)(rct)
        _ct_eq(got, want)
        assert tc == (marks.counts(rc) if tctx.plan_fused else rc)
        part = w.real if name == "real_part" else w.imag
        np.testing.assert_allclose(tctx.decrypt_decode(got).real, part, atol=2e-2)


# ---------------------------------------------------------------------------
# the encrypted MLP at lola_mnist_plain, full width: the digests chip_smoke.py checks
# ---------------------------------------------------------------------------


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_lola_mnist_mlp_full_width_matches_reference_digests():
    chip_smoke = _chip_smoke()
    ref = chip_smoke.MLP
    p = T_P.workload_params(ref["preset"])
    model = chip_smoke.mlp_model(p)
    plan1, plan2 = (T_lin.plan_matrix(m, tol=1e-12, params=p, level=lv, hoisting=True)
                    for m, lv in ((model["m1"], p.L), (model["m2"], p.L - 2)))
    assert (plan1.n1, plan2.n1, len(plan1.diags), len(plan2.diags)) == ref["plans"]
    rots = tuple(sorted(plan1.rotations() | plan2.rotations()))
    ks = T_K.full_keyset(p, seed=0, rotations=rots, device=CPU)
    assert len(ks.gks) == ref["galois_keys"]
    ctx = T_Ctx(params=p, keys=ks, device=CPU)
    ct = ctx.encrypt(ctx.encode(model["x_slots"]))
    ct1 = ctx.apply_bsgs(ct, plan1)
    ct3 = ctx.apply_bsgs(ctx.square(ct1), plan2)
    assert (ct1.level, ct3.level) == (5, 3)
    assert (chip_smoke.digest(ct1), chip_smoke.digest(ct3)) == (ref["ct1"], ref["ct3"])
    err = float(np.max(np.abs(ctx.decrypt_decode(ct3).real[:4] - model["want"])))
    assert err <= ref["max_err"]
