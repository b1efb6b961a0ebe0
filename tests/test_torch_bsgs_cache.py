"""The BSGS plan's plaintexts on the CPU at n = 2^9, against the reference package.

``BsgsPlan.stack`` encodes every diagonal, pre-rotated by its giant step, into
its row of one stack the first time the plan is applied at a level and scale,
and hands the same stack back on every later application (one
``fhe.bsgs.diag_hit`` span a matvec); ``BsgsPlan.plaintext`` is a diagonal's
row.  A kept plaintext is the fresh encoding bit for bit, so every answer stays
the reference's bytes.  The streams follow the contracts of ``ROADMAP.md``
Queue 3: a matvec's products and sums are one ``bsgsmac`` dispatch in place of
the reference's ``mulmod``s and ``addmod``s (``reference_bsgs``), and on a hit
the port's ``fhe.trace`` stream and dispatch counts are, besides, the
reference's less the ``NTT`` (n, ℓ+1) instruction and the ``ntt`` dispatch of
each kept diagonal, at the position where the reference encodes it.
"""

import dataclasses
import gc
import json
import weakref

import numpy as np
import pytest
import reference_bsgs
import torch
from torch.profiler import ProfilerActivity, profile

from repro.fhe import keys as R_K
from repro.fhe import linear as R_lin
from repro.fhe import ops as R_ops
from repro.fhe import params as R_P
from repro.fhe import trace as R_trace
from repro.fhe.context import ExecPolicy as R_Policy
from repro.fhe.context import FheContext as R_Ctx
from repro.kernels import dispatch as R_dispatch
from repro_torch.fhe import keys as T_K
from repro_torch.fhe import linear as T_lin
from repro_torch.fhe import ops as T_ops
from repro_torch.fhe import params as T_P
from repro_torch.fhe import trace as T_trace
from repro_torch.fhe.context import ExecPolicy as T_Policy
from repro_torch.fhe.context import FheContext as T_Ctx
from repro_torch.kernels import dispatch as T_dispatch

torch.set_num_threads(1)

CPU = "cpu"
# 9 diagonals at n1 = 4: babies {1, 2, 3}, giants {4, 8, 16}, so most diagonals are rolled
DIAGS = (0, 1, 3, 4, 6, 9, 10, 16, 19)
N1 = 4


def _np(x):
    return np.asarray(x).astype(np.int64)


def _ct_eq(port, ref):
    np.testing.assert_array_equal(port.c0.numpy().astype(np.int64), _np(ref.c0))
    np.testing.assert_array_equal(port.c1.numpy().astype(np.int64), _np(ref.c1))
    assert (port.level, port.scale) == (ref.level, ref.scale)


def _same(a, b):
    return torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1) and (a.level, a.scale) == (b.level, b.scale)


def _stream(instrs):
    return [(i.op, i.n, i.limbs, i.meta) for i in instrs]


@dataclasses.dataclass
class Setup:
    tp: object
    tctx: object
    tct: object
    rctx: object
    rct: object
    diags: dict
    z: np.ndarray

    def tplan(self):
        return T_lin.plan_diags(self.diags, self.tp, n1=N1)

    def rplan(self):
        return R_lin.plan_diags(self.diags, self.rctx.params, n1=N1)


@pytest.fixture(scope="module")
def setup():
    rp = R_P.make_params(1 << 9, 5, 2, check_security=False)
    tp = T_P.make_params(1 << 9, 5, 2, check_security=False)
    rng = np.random.default_rng(31)
    diags = {d: (rng.normal(size=tp.slots) + 1j * rng.normal(size=tp.slots)) * 0.05 for d in DIAGS}
    rots = tuple(sorted(T_lin.plan_diags(diags, tp, n1=N1).rotations()))
    rctx = R_Ctx(params=rp, keys=R_K.full_keyset(rp, seed=2, rotations=rots, conjugate=False),
                 policy=R_Policy(backend="ref"))
    tctx = T_Ctx(params=tp, keys=T_K.full_keyset(tp, seed=2, rotations=rots, conjugate=False, device=CPU),
                 policy=T_Policy(backend="ref"), device=CPU)
    z = rng.uniform(-0.9, 0.9, size=tp.slots)
    return Setup(tp, tctx, tctx.encrypt(tctx.encode(z)), rctx, rctx.encrypt(rctx.encode(z)), diags, z)


def _spans(fn, path):
    """(result, names of the user spans) of ``fn()`` under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, [e["name"] for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


@pytest.fixture
def diagonal_ntts(monkeypatch):
    """Indices, in the reference's captured trace, of each diagonal's encode:
    one ``NTT`` instruction, recorded where ``ops._encode`` is called."""
    marks = []
    encode = R_ops._encode

    def wrapped(ctx, z, level=None, scale=None):
        t = R_trace._TRACE.get()
        start = len(t)
        out = encode(ctx, z, level=level, scale=scale)
        assert [i.op for i in t[start:]] == ["NTT"]
        marks.append(start)
        return out

    monkeypatch.setattr(R_ops, "_encode", wrapped)
    return marks


def test_kept_plaintext_is_the_fresh_encoding(setup):
    s = setup
    plan = s.tplan()
    lv, scale = s.tp.L, s.tp.scale
    s.tctx.apply_bsgs(s.tct, plan)
    for d in DIAGS:
        kept = plan.plaintext(s.tctx, d, lv, scale)
        fresh = T_ops._encode(s.tctx, np.roll(s.diags[d], (d // N1) * N1), level=lv, scale=scale)
        assert torch.equal(kept.data, fresh.data) and (kept.level, kept.scale) == (lv, scale)
        assert plan.plaintext(s.tctx, d, lv, scale) is kept


@pytest.mark.parametrize("hoisting", ["never", "auto", "always"])
def test_second_application_encodes_nothing_and_gives_the_same_bytes(setup, tmp_path, hoisting):
    s = setup
    tctx, rctx = s.tctx.with_policy(hoisting=hoisting), s.rctx.with_policy(hoisting=hoisting)
    plan = s.tplan()
    first, cold = _spans(lambda: tctx.apply_bsgs(s.tct, plan), tmp_path / "cold.json")
    second, warm = _spans(lambda: tctx.apply_bsgs(s.tct, plan), tmp_path / "warm.json")
    want = rctx.apply_bsgs(s.rct, s.rplan())
    _ct_eq(first, want)
    _ct_eq(second, want)
    assert _same(first, second)
    assert cold.count("fhe.encode") == len(DIAGS) and "fhe.bsgs.diag_hit" not in cold
    assert "fhe.encode" not in warm and "fhe.encode.upload" not in warm
    assert warm.count("fhe.bsgs.diag_hit") == 1 and warm.count("fhe.bsgs") == 1
    assert cold.count("fhe.bsgs.mac") == warm.count("fhe.bsgs.mac") == 1
    np.testing.assert_allclose(tctx.decrypt_decode(second),
                               sum(s.diags[d] * np.roll(s.z, -d) for d in DIAGS), atol=2e-2)


@pytest.mark.parametrize("hoisting", ["never", "auto", "always"])
def test_a_hit_drops_one_ntt_a_diagonal_where_the_reference_encodes_it(setup, diagonal_ntts, hoisting):
    """The port's stream on a fresh plan is the reference's whole; on a second
    application it is the reference's with the NTT of each diagonal taken out at
    that diagonal's position, and one ``ntt`` dispatch fewer a diagonal."""
    s = setup
    tctx, rctx = s.tctx.with_policy(hoisting=hoisting), s.rctx.with_policy(hoisting=hoisting)
    plan = s.tplan()
    with T_trace.capture_trace() as miss, T_dispatch.count_dispatches() as miss_counts:
        tctx.apply_bsgs(s.tct, plan)
    with T_trace.capture_trace() as hit, T_dispatch.count_dispatches() as hit_counts:
        got = tctx.apply_bsgs(s.tct, plan)
    with R_trace.capture_trace() as rt, R_dispatch.count_dispatches() as rc:
        want = rctx.apply_bsgs(s.rct, s.rplan())
    _ct_eq(got, want)
    port = reference_bsgs.port_counts(rc, [plan])
    assert _stream(miss) == _stream(rt) and miss_counts == port
    assert len(diagonal_ntts) == len(DIAGS)
    for i in diagonal_ntts:
        assert (rt[i].op, rt[i].n, rt[i].limbs) == ("NTT", s.tp.n, s.tp.L + 1)
    dropped = set(diagonal_ntts)
    assert _stream(hit) == _stream([ins for i, ins in enumerate(rt) if i not in dropped])
    assert hit_counts == {**port, "ntt": rc["ntt"] - len(DIAGS)}


def test_hit_drops_the_ntt_dispatches_under_the_fused_pipeline(setup):
    s = setup
    tctx = s.tctx.with_policy(backend="fused", hoisting="always")
    plan = s.tplan()
    with T_dispatch.count_dispatches() as miss:
        first = tctx.apply_bsgs(s.tct, plan)
    with T_dispatch.count_dispatches() as hit:
        second = tctx.apply_bsgs(s.tct, plan)
    assert _same(first, second)
    want = {**miss, "ntt": miss["ntt"] - len(DIAGS)}
    assert "hoistmac" in miss and hit == {k: v for k, v in want.items() if v}


def test_other_levels_and_scales_keep_plaintexts_of_their_own(setup):
    s = setup
    plan = s.tplan()
    low = T_ops.level_drop(s.tct, 3)
    runs = [(s.tct, None), (low, None), (s.tct, 2.0 ** 26), (low, 2.0 ** 26)]
    outs = [s.tctx.apply_bsgs(ct, plan, scale=scale) for ct, scale in runs]
    assert len(plan._stacks) == len(runs)
    for (level, scale, device, params), st in plan._stacks.items():
        assert tuple(st.data.shape) == (len(DIAGS), level + 1, s.tp.n) and sorted(st.plaintexts) == sorted(DIAGS)
        for pt in st.plaintexts.values():
            assert pt.level == level and pt.scale == scale and tuple(pt.data.shape) == (level + 1, s.tp.n)
            assert pt.data.data_ptr() in {row.data_ptr() for row in st.data}  # a row of the stack, no copy
        assert device == s.tctx.device and params is s.tp
    # applied again, in another order, each answer is that of a plan fresh at its level and scale
    for (ct, scale), out in reversed(list(zip(runs, outs))):
        again = s.tctx.apply_bsgs(ct, plan, scale=scale)
        assert _same(again, out) and _same(again, s.tctx.apply_bsgs(ct, s.tplan(), scale=scale))
        assert again.level == ct.level - 1
    assert len(plan._stacks) == len(runs)
    rlow = R_ops.level_drop(s.rct, 3)
    _ct_eq(s.tctx.apply_bsgs(low, plan, scale=2.0 ** 26), s.rctx.apply_bsgs(rlow, s.rplan(), scale=2.0 ** 26))


def test_plan_equality_rotations_and_repr_are_unchanged(setup):
    s = setup
    plan, rplan = s.tplan(), s.rplan()
    before = (plan.rotations(), plan.baby_steps(), plan.giant_steps(), repr(plan))
    s.tctx.apply_bsgs(s.tct, plan)
    assert plan._stacks and plan == s.tplan() and dataclasses.replace(plan) == plan
    assert not dataclasses.replace(plan)._stacks
    assert (plan.rotations(), plan.baby_steps(), plan.giant_steps(), repr(plan)) == before
    assert plan.rotations() == rplan.rotations() and plan.n1 == rplan.n1 == N1
    assert plan.baby_steps() == rplan.baby_steps() == (1, 2, 3)
    assert plan.giant_steps() == rplan.giant_steps() == (4, 8, 16)


def test_plaintexts_are_freed_with_the_plan(setup):
    s = setup
    plan = s.tplan()
    s.tctx.apply_bsgs(s.tct, plan)
    (st,) = plan._stacks.values()
    kept = [weakref.ref(st.data), weakref.ref(st.baby_idx), weakref.ref(st.offsets)]
    kept += [weakref.ref(pt.data) for pt in st.plaintexts.values()]
    assert len(kept) == 3 + len(DIAGS) and all(r() is not None for r in kept)
    del st
    del plan
    gc.collect()
    assert all(r() is None for r in kept)
