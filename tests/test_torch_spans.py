"""The port's profiler-clock spans (``repro_torch.obs.span``) on the CPU at n = 2^9.

Under ``torch.profiler`` each span is a ``user_annotation`` event of the Chrome
trace, the events the benchmark's readers take: ``apply_bsgs`` of a fresh plan
encodes one diagonal per ``fhe.encode`` inside its ``fhe.bsgs``, key-switches once per
baby group (or baby rotation) and giant rotation, and runs its products and
sums in one ``fhe.bsgs.mac``; a Chebyshev evaluation shows
one ``fhe.encode_const`` per ``_encode_const`` call under ``fhe.cheb.basis`` or
``fhe.cheb.combine``, each holding one ``fhe.encode.const_column``; a cold
table cache shows ``fhe.table.*`` spans and a warm one none.  With the profiler off ``span`` is one shared no-op, and on or off the
ciphertexts, the ``fhe.trace`` streams and the kernel-dispatch counts are the
same."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.fhe import keys as K
from repro_torch.fhe import ops, polyeval
from repro_torch.fhe import linear as lin
from repro_torch.fhe import params as P
from repro_torch.fhe import trace as fhe_trace
from repro_torch.fhe.context import ExecPolicy, FheContext
from repro_torch.kernels import dispatch, tables
from repro_torch.obs import span

torch.set_num_threads(1)

CPU = "cpu"
PARAMS = P.make_params(1 << 9, 6, 2, check_security=False)
# 11 diagonals at n1 = 4: babies {1, 2, 3}, giants {4, 8, 16}
DIAGS = (0, 1, 2, 3, 4, 5, 9, 10, 16, 17, 19)
N1 = 4


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    plan = lin.plan_diags({d: rng.normal(size=PARAMS.slots) * 0.1 for d in DIAGS}, PARAMS, hoisting=True, n1=N1)
    keys = K.full_keyset(PARAMS, seed=0, rotations=tuple(sorted(plan.rotations())), conjugate=False, device=CPU)
    ctx = FheContext(params=PARAMS, keys=keys, device=CPU)
    z = rng.uniform(-0.9, 0.9, size=PARAMS.slots)
    return ctx, plan, ctx.encrypt(ctx.encode(z))


def _spans(fn, path):
    """(result, [(start, end, name)]) of ``fn()`` under a CPU profiler, from its Chrome trace."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _named(spans, name):
    return [s for s in spans if s[2] == name]


def _inside(inner, outers):
    return any(o[0] <= inner[0] and inner[1] <= o[1] for o in outers)


def _fresh(plan):
    """A copy of ``plan`` that holds no encoded diagonal yet, so that its
    application encodes every diagonal."""
    return dataclasses.replace(plan)


def _ops(ctx, plan, ct):
    ctx_never = ctx.with_policy(ExecPolicy(hoisting="never"))
    coeffs = polyeval.chebyshev_fit(np.sin, 6)
    return {
        "bsgs.auto": lambda: ctx.apply_bsgs(ct, _fresh(plan)),
        "bsgs.never": lambda: ctx_never.apply_bsgs(ct, _fresh(plan)),
        "eval_poly": lambda: ctx.eval_poly(ct, coeffs),
        "mul": lambda: ctx.mul(ct, ct),
        "rotate": lambda: ctx.rotate(ct, 3),
    }


@pytest.mark.parametrize("hoisting,baby_switches", [("auto", 1), ("never", 3)])
def test_bsgs_encodes_each_diagonal_inside_its_span(setup, tmp_path, hoisting, baby_switches):
    ctx, plan, ct = setup
    ctx = ctx.with_policy(ExecPolicy(hoisting=hoisting))
    _, spans = _spans(lambda: ctx.apply_bsgs(ct, _fresh(plan)), tmp_path / "t.json")
    bsgs = _named(spans, "fhe.bsgs")
    encodes = _named(spans, "fhe.encode")
    assert len(bsgs) == 1 and len(encodes) == len(DIAGS)
    assert all(_inside(e, bsgs) for e in encodes)
    for part in ("fhe.encode.coeffs", "fhe.encode.upload"):
        assert len(_named(spans, part)) == len(DIAGS) and all(_inside(s, encodes) for s in _named(spans, part))
    switches = _named(spans, "fhe.keyswitch")
    assert len(switches) == baby_switches + len(plan.giant_steps()) and all(_inside(s, bsgs) for s in switches)
    # the products and sums of every giant group: one span inside the matvec's, around no encode or key-switch
    macs = _named(spans, "fhe.bsgs.mac")
    assert len(macs) == 1 and _inside(macs[0], bsgs)
    assert not any(_inside(s, macs) for s in encodes + switches)
    assert len(_named(spans, "fhe.rescale")) == 1
    assert all(s[2].startswith("fhe.") for s in spans)


def test_chebyshev_encodes_each_constant_inside_its_span(setup, tmp_path, monkeypatch):
    ctx, _, ct = setup
    calls = []
    encode_const = ops._encode_const
    monkeypatch.setattr(ops, "_encode_const", lambda *a, **k: calls.append(a[2]) or encode_const(*a, **k))
    degree = 6
    _, spans = _spans(lambda: ctx.eval_poly(ct, polyeval.chebyshev_fit(np.sin, degree)), tmp_path / "t.json")
    consts = _named(spans, "fhe.encode_const")
    parts = _named(spans, "fhe.cheb.basis") + _named(spans, "fhe.cheb.combine")
    assert len(consts) == len(calls) > 0 and len(parts) == 2
    assert all(_inside(c, parts) for c in consts) and not _named(spans, "fhe.encode")
    # every constant is real: built as a residue column, never encoded on the host
    columns = _named(spans, "fhe.encode.const_column")
    assert len(columns) == len(consts) and all(_inside(c, consts) for c in columns)
    assert not _named(spans, "fhe.encode.coeffs") and not _named(spans, "fhe.encode.upload")
    assert len(_named(spans, "fhe.keyswitch")) == degree - 1  # one relinearisation per T_2..T_degree


def test_span_is_one_shared_noop_with_the_profiler_off():
    assert not torch.autograd._profiler_enabled()
    first = span("fhe.encode")
    assert span("fhe.keyswitch") is first and span("fhe.encode") is first
    with first as entered:
        assert entered is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert span("fhe.encode") is not first


@pytest.mark.parametrize("name", ["bsgs.auto", "bsgs.never", "eval_poly", "mul", "rotate"])
def test_profiler_changes_no_output_trace_or_dispatch(setup, tmp_path, name):
    ctx, plan, ct = setup
    fn = _ops(ctx, plan, ct)[name]

    def run():
        with fhe_trace.capture_trace() as instrs, dispatch.count_dispatches() as counts:
            out = fn()
        return out, [(i.op, i.n, i.limbs, i.meta) for i in instrs], dict(counts)

    off = run()
    on, spans = _spans(run, tmp_path / "t.json")
    assert spans
    for a, b in ((off[0].c0, on[0].c0), (off[0].c1, on[0].c1)):
        assert torch.equal(a, b)
    assert (off[0].level, off[0].scale) == (on[0].level, on[0].scale)
    assert off[1] == on[1] and off[2] == on[2]


@pytest.mark.parametrize("name", ["bsgs.auto", "mul", "rotate", "eval_poly"])
def test_table_spans_show_a_cold_cache_only(setup, tmp_path, name):
    ctx, plan, ct = setup
    fn = _ops(ctx, plan, ct)[name]
    tables.clear()
    ctx.keys.hoist_cache.clear()
    _, cold = _spans(fn, tmp_path / "cold.json")
    _, warm = _spans(fn, tmp_path / "warm.json")
    built = {s[2] for s in cold if s[2].startswith("fhe.table.")}
    assert {"fhe.table.plan_for", "fhe.table.build_plan", "fhe.table.limb_column"} <= built
    # the rescale's constants serve every rescale, and a rotation has none
    assert ("fhe.table.rescale_tables" in built) == (name != "rotate")
    assert [s for s in warm if s[2].startswith("fhe.table.")] == []
