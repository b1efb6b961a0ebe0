"""The port's core package (planner expansions, simulator, cache model) against
the reference's, and the planner against the port's own execution traces.

Both packages run the same Python expressions on the same inputs, so every
instruction stream and every ``SimResult`` field must be equal, floats bit for
bit.  The planner-against-execution checks mirror the reference's parity
tests (``tests/test_core.py``, ``test_fusedks.py``, ``test_hoisting.py`` and
``test_bgv.py``) on the port's ``capture_trace`` at n = 2^9 on the CPU, under
both key-switch pipelines.  The workload streams themselves are held in
``tests/test_torch_planner.py``."""

import collections
import dataclasses
import importlib.util
import operator
import pathlib

import numpy as np
import pytest
import torch

from repro.core import cache as R_cache
from repro.core import hardware as R_H
from repro.core import planner as R_PL
from repro.core import simulator as R_S
from repro.fhe import params as R_P
from repro.obs import Tracer as R_Tracer
from repro.obs import dumps_chrome_trace as r_dumps
from repro_torch.core import cache as T_cache
from repro_torch.core import hardware as T_H
from repro_torch.core import planner as T_PL
from repro_torch.core import simulator as T_S
from repro_torch.fhe import keys as T_K
from repro_torch.fhe import linear as T_lin
from repro_torch.fhe import ops as T_ops
from repro_torch.fhe import params as T_P
from repro_torch.fhe import trace as T_trace
from repro_torch.fhe.context import ExecPolicy as T_Policy
from repro_torch.fhe.context import FheContext as T_Ctx
from repro_torch.obs import Tracer as T_Tracer
from repro_torch.obs import dumps_chrome_trace as t_dumps
from repro_torch.obs import to_chrome_trace, validate_chrome_trace

torch.set_num_threads(1)

CPU = "cpu"
PIPELINES = (("fused", True), ("staged", False))  # backend, planner's fused flag
ROTS = (1, 2, 3, 5)
MB = 1 << 20


def _sig(instrs):
    """Multiset signature of (op, n, limbs) triples (ignoring meta)."""
    return collections.Counter((i.op, i.n, i.limbs) for i in instrs)


def _same(ref, port) -> bool:
    return len(ref) == len(port) and all(map(operator.eq, map(vars, ref), map(vars, port)))


def _sim_eq(ref, port):
    assert type(ref).__name__ == type(port).__name__ == "SimResult"
    assert vars(ref) == vars(port)
    assert ref.time_s == port.time_s


# ---------------------------------------------------------------------------
# hardware, cache
# ---------------------------------------------------------------------------


def test_hardware_tables_equal():
    assert T_H.CHIPS.keys() == R_H.CHIPS.keys()
    for name, chip in T_H.CHIPS.items():
        ref = R_H.CHIPS[name]
        assert vars(chip) == vars(ref)
        for prop in ("n_bootstrappable", "n_swift", "l2_mb", "hbm_bytes_per_cycle"):
            assert getattr(chip, prop) == getattr(ref, prop), (name, prop)
    assert T_H.AREA_TABLE_MM2 == R_H.AREA_TABLE_MM2
    assert T_H.BASELINE_AREAS_MM2 == R_H.BASELINE_AREAS_MM2
    assert T_H.POWER_BREAKDOWN_W == R_H.POWER_BREAKDOWN_W
    assert (T_H.TOTAL_POWER_W, T_H.BASELINE_POWER_W) == (R_H.TOTAL_POWER_W, R_H.BASELINE_POWER_W)
    for node in ("7nm", "14nm"):
        assert T_H.area_total_mm2(node) == R_H.area_total_mm2(node)
        assert T_H.swift_logic_fraction(node) == R_H.swift_logic_fraction(node)
    # the TPU roofline constants are not the modelled accelerator's: not ported
    assert not any(k.startswith("TPU_") for k in vars(T_H))


def test_cache_models_equal():
    rng = np.random.default_rng(4)
    keys = [f"k{i}" for i in rng.integers(0, 12, size=400)]
    sizes = rng.uniform(0.5, 6.0, size=400) * MB
    rc, tc = R_cache.LruCache(10 * MB), T_cache.LruCache(10 * MB)
    rh, th = R_cache.HierarchicalCache(4, 6 * MB, 20 * MB), T_cache.HierarchicalCache(4, 6 * MB, 20 * MB)
    for i, (k, nb) in enumerate(zip(keys, sizes)):
        assert rc.access(k, nb) == tc.access(k, nb)
        assert rh.access(i % 4, k, nb) == th.access(i % 4, k, nb)
        if i % 50 == 0:
            assert rc.spill(nb) == tc.spill(nb)
    assert (rc.hits, rc.misses, rc.hbm_bytes, rc.used, rc.hit_ratio) == \
        (tc.hits, tc.misses, tc.hbm_bytes, tc.used, tc.hit_ratio)
    assert (rh.hbm_bytes, rh.hit_ratio()) == (th.hbm_bytes, th.hit_ratio())


# ---------------------------------------------------------------------------
# compound expansions, at n = 2^9 and at a preset
# ---------------------------------------------------------------------------


def _compounds(PL, pp, L, bootstrap_modes):
    """Every compound expansion, at two levels (the top and a ragged digit),
    both fused flags, both modes where a mode applies."""
    out = {}
    for level in (L, max(1, pp.alpha)):
        for fused in (True, False):
            f = dict(fused=fused)
            out[("hmul", level, fused)] = PL.hmul(pp, level, **f)
            out[("hmul_norescale", level, fused)] = PL.hmul(pp, level, rescale_after=False, **f)
            out[("rotate", level, fused)] = PL.rotate(pp, level, **f)
            out[("key_switch", level, fused)] = PL.key_switch(pp, level, **f)
            out[("hoisted_rotations", level, fused)] = PL.hoisted_rotations(pp, level, 4, **f)
            out[("bgv_hmul", level, fused)] = PL.bgv_hmul(pp, level, **f)
            for mode in ("exec", "hw"):
                for hoist in (False, True):
                    out[("bsgs_matvec", level, fused, mode, hoist)] = PL.bsgs_matvec(
                        pp, level, 16, 4, mode=mode, hoist=hoist, **f)
        out[("bgv_mod_switch", level)] = PL.bgv_mod_switch(pp, level)
        out[("mul_plain", level)] = PL.mul_plain(pp, level, mode="hw")
    for fused in (True, False):
        for mode in bootstrap_modes:
            for hoist in (False, True):
                out[("bootstrap", fused, mode, hoist)] = PL.bootstrap(pp, 15, mode=mode, hoist=hoist, fused=fused)
    return out


@pytest.mark.parametrize("shape", ("n=2^9", "lstm"))
def test_compound_expansions_equal(shape):
    if shape == "lstm":
        rp = R_PL.PlanParams.of(R_P.workload_params("lstm"))
        tp = T_PL.PlanParams.of(T_P.workload_params("lstm"))
    else:
        rp, tp = R_PL.PlanParams(n=1 << 9, L=6, alpha=2), T_PL.PlanParams(n=1 << 9, L=6, alpha=2)
    assert vars(rp) == vars(tp)
    # the preset's exec-mode bootstrap is part of its workload stream, which
    # tests/test_torch_planner.py holds
    modes = ("hw",) if shape == "lstm" else ("exec", "hw")
    ref, port = _compounds(R_PL, rp, rp.L, modes), _compounds(T_PL, tp, tp.L, modes)
    assert ref.keys() == port.keys()
    for key in ref:
        assert len(ref[key]) > 0
        assert _same(ref[key], port[key]), key
    assert _same(R_PL.add_hw_annotations(ref[("key_switch", rp.L, True)], rp),
                 T_PL.add_hw_annotations(port[("key_switch", tp.L, True)], tp))


# ---------------------------------------------------------------------------
# planner against the port's own execution traces (n = 2^9, CPU)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckks():
    p = T_P.make_params(1 << 9, 6, 2, check_security=False)
    rng = np.random.default_rng(3)
    mat = (rng.normal(size=(p.slots, p.slots)) + 1j * rng.normal(size=(p.slots, p.slots))) / p.slots
    plan = T_lin.plan_matrix(mat)
    rots = tuple(sorted(set(ROTS) | set(plan.rotations())))
    ks = T_K.full_keyset(p, seed=0, rotations=rots, conjugate=False, device=CPU)
    ctx = T_Ctx(params=p, keys=ks, policy=T_Policy(backend="staged"), device=CPU)
    z = rng.normal(size=p.slots) * 0.4
    a = ctx.encrypt(ctx.encode(z))
    b = ctx.encrypt(ctx.encode(z * 0.5), seed=31)
    return p, ctx, a, b, plan


@pytest.mark.parametrize("backend,fused", PIPELINES)
def test_planner_hmul_matches_execution(ckks, backend, fused):
    p, ctx, a, b, _ = ckks
    pp = T_PL.PlanParams.of(p)
    for level in (p.L, p.alpha - 1):
        x, y = ctx.level_drop(a, level), ctx.level_drop(b, level)
        with T_trace.capture_trace() as t:
            ctx.with_policy(backend=backend).mul(x, y)
        assert _sig(t) == _sig(T_PL.hmul(pp, level, fused=fused)), level


@pytest.mark.parametrize("backend,fused", PIPELINES)
def test_planner_rotate_matches_execution(ckks, backend, fused):
    p, ctx, a, _, _ = ckks
    with T_trace.capture_trace() as t:
        ctx.with_policy(backend=backend).rotate(a, 3)
    assert _sig(t) == _sig(T_PL.rotate(T_PL.PlanParams.of(p), a.level, fused=fused))


@pytest.mark.parametrize("backend,fused", PIPELINES)
def test_planner_mul_plain_matches_execution(ckks, backend, fused):
    p, ctx, a, _, _ = ckks
    c = ctx.with_policy(backend=backend)
    with T_trace.capture_trace() as t:  # the encode's NTT is part of the exec stream
        c.mul_plain(a, c.encode(np.ones(p.slots) * 0.5, level=a.level), rescale_after=True)
    want = T_PL.mul_plain(T_PL.PlanParams.of(p), a.level, rescale_after=True, mode="exec")
    assert _sig(t) == _sig(want)


@pytest.mark.parametrize("backend,fused", PIPELINES)
def test_planner_hoisted_group_matches_execution(ckks, backend, fused):
    p, ctx, a, _, _ = ckks
    pp = T_PL.PlanParams.of(p)
    for level in (p.L, max(1, p.alpha - 1)):
        c = T_ops.level_drop(a, level)
        with T_trace.capture_trace() as t:
            ctx.with_policy(backend=backend).rotate_hoisted_group(c, ROTS)
        assert _sig(t) == _sig(T_PL.hoisted_rotations(pp, level, len(ROTS), fused=fused)), level


@pytest.mark.parametrize("hoisting,hoist", (("always", True), ("never", False)))
@pytest.mark.parametrize("backend,fused", PIPELINES)
def test_planner_bsgs_matches_execution(ckks, backend, fused, hoisting, hoist):
    p, ctx, a, _, plan = ckks
    with T_trace.capture_trace() as t:  # a fresh copy of the plan: the exec stream encodes every diagonal
        ctx.with_policy(backend=backend, hoisting=hoisting).apply_bsgs(a, dataclasses.replace(plan))
    want = T_PL.bsgs_matvec(T_PL.PlanParams.of(p), a.level, len(plan.diags), plan.n1,
                            mode="exec", hoist=hoist, fused=fused)
    assert _sig(t) == _sig(want)


@pytest.fixture(scope="module")
def bgv():
    t = 1 << 16
    p = T_P.make_params(1 << 9, 5, 2, check_security=False, plain_modulus=t)
    ctx = T_Ctx(params=p, keys=T_K.full_keyset(p, seed=0, device=CPU), device=CPU)
    rng = np.random.default_rng(11)
    za, zb = (rng.integers(0, t, size=p.n) for _ in range(2))
    return p, ctx, ctx.encrypt(ctx.encode(za), seed=3), ctx.encrypt(ctx.encode(zb), seed=4)


@pytest.mark.parametrize("backend,fused", PIPELINES)
def test_planner_bgv_hmul_matches_execution(bgv, backend, fused):
    p, ctx, a, b = bgv
    with T_trace.capture_trace() as t:
        ctx.with_policy(backend=backend).mul(a, b)
    want = T_PL.bgv_hmul(T_PL.PlanParams.of(p), p.L, mod_switch_after=True, fused=fused)
    assert _sig(t) == _sig(want)


@pytest.mark.parametrize("backend,fused", PIPELINES)
def test_planner_bgv_mod_switch_matches_execution(bgv, backend, fused):
    p, ctx, a, _ = bgv
    with T_trace.capture_trace() as t:
        ctx.with_policy(backend=backend).mod_switch(a)
    assert _sig(t) == _sig(T_PL.bgv_mod_switch(T_PL.PlanParams.of(p), p.L))


# ---------------------------------------------------------------------------
# simulator
# ---------------------------------------------------------------------------

LANES = ("lanes_deep", "lanes_deep_coop", "lanes_shallow", "lanes_whole_chip")


@pytest.mark.parametrize("name", R_PL.available_workloads())
def test_simulate_stream_equal(name):
    rs = R_PL.workload_stream(name, R_P.workload_params(name), mode="hw")
    ts = T_PL.workload_stream(name, T_P.workload_params(name), mode="hw")
    for chip in R_H.CHIPS:
        rc, tc = R_H.CHIPS[chip], T_H.CHIPS[chip]
        for lanes in LANES:
            rl, tl = getattr(R_S, lanes)(rc), getattr(T_S, lanes)(tc)
            assert vars(rl) == vars(tl)
            _sim_eq(R_S.simulate_stream(rs, rc, rl), T_S.simulate_stream(ts, tc, tl))


def test_cache_sweep_equal():
    """The Fig-8 sweep of ``tests/test_core.py``: dnum = 1 key-switches at
    ``packed_bootstrap`` over four cache volumes."""
    rp = R_PL.PlanParams.of(R_P.workload_params("packed_bootstrap"))
    tp = T_PL.PlanParams.of(T_P.workload_params("packed_bootstrap"))
    rs = R_PL.add_hw_annotations(R_PL.key_switch(rp, rp.L) * 10, rp)
    ts = T_PL.add_hw_annotations(T_PL.key_switch(tp, tp.L) * 10, tp)
    cycles = {}
    for cap in (128, 256, 320, 512):
        r = R_S.simulate_stream(rs, R_H.FLASH_FHE, R_S.lanes_deep(R_H.FLASH_FHE), cache_bytes=cap * MB)
        t = T_S.simulate_stream(ts, T_H.FLASH_FHE, T_S.lanes_deep(T_H.FLASH_FHE), cache_bytes=cap * MB)
        _sim_eq(r, t)
        cycles[cap] = t.cycles
    assert cycles[128] > cycles[256] > cycles[320] == cycles[512]


def test_simulate_stream_traced_equal():
    name = "lola_mnist_plain"
    rs = R_PL.workload_stream(name, R_P.workload_params(name), mode="hw")
    ts = T_PL.workload_stream(name, T_P.workload_params(name), mode="hw")
    rt, tt = R_Tracer(), T_Tracer()
    r = R_S.simulate_stream(rs, R_H.FLASH_FHE, R_S.lanes_shallow(R_H.FLASH_FHE), tracer=rt)
    t = T_S.simulate_stream(ts, T_H.FLASH_FHE, T_S.lanes_shallow(T_H.FLASH_FHE), tracer=tt)
    _sim_eq(r, t)
    assert len(tt.events) > len(ts) // 2
    assert tt.events == rt.events
    blob = t_dumps(tt)
    assert blob == r_dumps(rt)
    assert validate_chrome_trace(to_chrome_trace(tt)) == []
    # tracing changes nothing it observes
    _sim_eq(t, T_S.simulate_stream(ts, T_H.FLASH_FHE, T_S.lanes_shallow(T_H.FLASH_FHE)))


# ---------------------------------------------------------------------------
# chip_smoke.py's phase-3h cases, here at n = 2^9 on the CPU
# ---------------------------------------------------------------------------


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _chip_smoke()
N_SMOKE_CASES = 24  # 8 ops × backends fused, staged, auto


@pytest.fixture(scope="module")
def smoke_cases(ckks, bgv):
    """``planner_cases`` over n = 2^9 stand-ins of the card's contexts: the
    ``lstm`` group context (Galois keys 1..4), the MLP's context and first
    plan, and BGV contexts at t = 2 (``psi``'s) and t = 2^16."""
    p, ctx, a, _, _ = ckks
    model = SMOKE.mlp_model(p)
    plan = T_lin.plan_matrix(model["m1"], tol=1e-12, params=p, level=p.L, hoisting=True)
    mlp_ks = T_K.full_keyset(p, seed=0, rotations=tuple(sorted(plan.rotations())), device=CPU)
    mlp_ctx = T_Ctx(params=p, keys=mlp_ks, device=CPU)
    mlp_ct = mlp_ctx.encrypt(mlp_ctx.encode(model["x_slots"]))
    bp = T_P.make_params(1 << 9, 5, 2, check_security=False, plain_modulus=2)
    bctx = T_Ctx(params=bp, keys=T_K.full_keyset(bp, seed=0, device=CPU), device=CPU)
    u, v = (np.random.default_rng(s).integers(0, 2, size=bp.n) for s in (1, 2))
    psi = (bctx, bctx.encrypt(bctx.encode(u), seed=1), bctx.encrypt(bctx.encode(v), seed=2))
    _, ectx, ea, _ = bgv
    return SMOKE.planner_cases(T_PL, (ctx, a), (mlp_ctx, mlp_ct, plan), psi, (ectx, ea), levels=(p.L, p.alpha))


@pytest.mark.parametrize("i", range(N_SMOKE_CASES))
def test_chip_smoke_planner_cases_on_cpu(smoke_cases, i):
    """Each case's op, run on the CPU, traces exactly its planner stream; "auto"
    resolves to the staged pipeline here, as it must on a CPU device."""
    assert len(smoke_cases) == N_SMOKE_CASES
    label, fn, want = smoke_cases[i]
    with T_trace.capture_trace() as got:
        fn()
    assert SMOKE.sig(got) == SMOKE.sig(want) == dict(_sig(want)), label
    if label.startswith("auto") and any(ins.op == "LOAD_KSK" for ins in want):
        assert any(ins.op == "STORE_WS" for ins in want), label
