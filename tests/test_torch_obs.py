"""The port's observability package against the reference's.

``tools/obs_smoke.py``'s scenario (48 jobs on a 4-chip fleet with a crash, a
straggler window, flaky failures, retries and cross-chip gangs), through
``chip_smoke.py``'s copy of its builders, runs in both packages: the
Chrome-trace exports are byte-identical (and hash to the digest the smoke
holds on the card), valid, and a run with the tracer off gives the same
timeline.  Then the semantics of the tracer and the metrics registry, and
``ExecPolicy.traced`` on a real multiply: one slice per kernel dispatch, in
the order and with the names the reference's traced multiply records."""

import hashlib
import importlib.util
import json
import pathlib
import types

import numpy as np
import pytest
import reference_rescale
import torch

from repro import obs as R_obs
from repro import serve as R_serve
from repro.core import hardware as R_H
from repro.core import jobs as R_J
from repro.fhe import keys as R_K
from repro.fhe import params as R_P
from repro.fhe.context import ExecPolicy as R_Policy
from repro.fhe.context import FheContext as R_Ctx
from repro_torch import obs as T_obs
from repro_torch import serve as T_serve
from repro_torch.core import hardware as T_H
from repro_torch.core import jobs as T_J
from repro_torch.fhe import convert
from repro_torch.fhe import keys as T_K
from repro_torch.fhe import params as T_P
from repro_torch.fhe.context import ExecPolicy as T_Policy
from repro_torch.fhe.context import FheContext as T_Ctx
from repro_torch.kernels import dispatch as T_dispatch
from repro_torch.obs import (
    MetricsRegistry,
    Tracer,
    dumps_chrome_trace,
    to_chrome_trace,
    validate_chrome_trace,
)

torch.set_num_threads(1)

CPU = "cpu"
REF = types.SimpleNamespace(serve=R_serve, H=R_H, J=R_J, obs=R_obs)
PORT = types.SimpleNamespace(serve=T_serve, H=T_H, J=T_J, obs=T_obs)

# -- the obs smoke scenario --------------------------------------------------------
# chip_smoke.py's copy of tools/obs_smoke.py's builders, which take a namespace
# of one package's modules; the smoke runs the same scenario on the card's host
# against the reference digest of its SCHEDULING table.


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _chip_smoke()
smoke_fleet = SMOKE.obs_smoke_fleet


def _done(res):
    return sorted((je.job.job_id, je.completion) for je in res.jobs if je.completion is not None)


@pytest.fixture(scope="module")
def smoke():
    rt, tt = R_obs.Tracer(), T_obs.Tracer()
    rres, tres = smoke_fleet(REF, rt), smoke_fleet(PORT, tt)
    return rt, tt, rres, tres


def test_smoke_trace_bytes_equal(smoke):
    rt, tt, rres, tres = smoke
    blob = dumps_chrome_trace(tt)
    assert blob == R_obs.dumps_chrome_trace(rt)
    assert hashlib.sha256(blob.encode()).hexdigest() == SMOKE.SCHEDULING["obs_trace"]
    assert len(tt.events) > 300
    # the scenario exercised every seam it claims to
    assert all(tres.fault_counts.get(k, 0) >= 1 for k in ("crashes", "transients", "retries"))
    assert tres.gangs
    assert len(tres.jobs) == 48
    assert json.dumps(T_serve.metrics.summarize_cluster(tres), sort_keys=True) == \
        json.dumps(R_serve.metrics.summarize_cluster(rres), sort_keys=True)
    assert tres.metrics == rres.metrics


def test_smoke_trace_deterministic_and_valid(smoke):
    _, tt, _, _ = smoke
    again = Tracer()
    smoke_fleet(PORT, again)
    assert dumps_chrome_trace(again) == dumps_chrome_trace(tt)
    assert validate_chrome_trace(to_chrome_trace(tt)) == []


def test_smoke_disabled_tracer_same_timeline(smoke):
    _, _, _, tres = smoke
    for tracer in (None, Tracer(enabled=False)):
        bare = smoke_fleet(PORT, tracer)
        assert bare.makespan == tres.makespan
        assert _done(bare) == _done(tres)


# -- tracer, exporter, validator ---------------------------------------------


def _drive_tracer(tr):
    tr.name_process(1, "chip0")
    tid = tr.track(1, "chip")
    assert tr.track(1, "affiliation-0") == tid + 1
    assert tr.track(2, "chip") == 0
    t = {"now": 0.0}
    tr.bind_clock(lambda: t["now"])
    tr.complete("seg", 10.0, 20.0, pid=1, tid=tid, job=3)
    tr.instant("a")
    t["now"] = 42.0
    tr.instant("b", pid=1, tid=tid)
    tr.counter("backlog", {"total": 1.0}, pid=1)
    tr.job_begin(7, "matmul", ts=5.0, pid=1, kind="shallow")
    tr.job_end(7, "matmul", "DONE", ts=50.0, pid=1)
    with tr.span("route", pid=0, tid=0):
        pass
    hook = tr.dispatch_hook(pid=5)
    for op in ("NTT", "BCONV", "NTT"):
        hook(op)
    return tr


def test_tracer_semantics_equal():
    tr, rr = _drive_tracer(Tracer()), _drive_tracer(R_obs.Tracer())
    assert tr.events == rr.events
    assert tr.n_dispatches == 3
    assert [(e["name"], e["ts"], e["dur"]) for e in tr.events if e["pid"] == 5] == [
        ("NTT", 0.0, 1.0), ("BCONV", 1.0, 1.0), ("NTT", 2.0, 1.0)]
    assert dumps_chrome_trace(tr) == R_obs.dumps_chrome_trace(rr)
    assert validate_chrome_trace(to_chrome_trace(tr)) == []
    off = _drive_tracer(Tracer(enabled=False))
    assert not off and off.events == [] and off.n_dispatches == 0


def test_validator_flags_what_the_reference_flags():
    cases = []
    bad = Tracer()
    bad.begin("down", ts=1.0, pid=1)
    cases.append(to_chrome_trace(bad))
    neg = Tracer()
    neg.complete("seg", 10.0, 5.0, pid=1)
    cases.append(to_chrome_trace(neg))
    ev = lambda name, ts, tid: {"name": name, "ph": "i", "ts": ts, "pid": 1, "tid": tid, "s": "t", "args": {}}
    cases.append({"traceEvents": [ev("late", 10.0, 0), ev("early", 5.0, 0)]})
    cases.append({"traceEvents": [ev("late", 10.0, 0), ev("early", 5.0, 1)]})
    cases.append({"traceEvents": [{"name": "x", "ph": "Q", "ts": 0.0, "pid": 0, "tid": 0}]})
    got = [validate_chrome_trace(c) for c in cases]
    assert got == [R_obs.validate_chrome_trace(c) for c in cases]
    assert all(got[:3]) and got[3] == [] and got[4]


# -- metrics registry ------------------------------------------------------------


def _drive_registry(reg, errors):
    c = reg.counter("serve.shed", labels=("reason", "chip"))
    c.inc(reason="timeout", chip=1)
    c.inc(2, reason="timeout", chip=2)
    c.inc(reason="token_bucket", chip=-1)
    for bad in (lambda: c.inc(reason="timeout"), lambda: c.inc(-1.0, reason="timeout", chip=1),
                lambda: reg.counter("serve.shed", labels=("reason",))):
        try:
            bad()
        except ValueError:
            errors.append("ValueError")
    assert reg.counter("serve.shed", labels=("reason", "chip")) is c
    g = reg.gauge("backlog")
    g.set(5.0)
    g.max(3.0)
    g.max(9.0)
    g.add(1.0)
    h = reg.histogram("lat", buckets=(10.0, 100.0))
    for v in (5.0, 50.0, 500.0):
        h.observe(v)
    return (c.total(), c.group_sum("reason"), c.by_label("chip"), g.value(), h.snapshot(), h.mean,
            reg.snapshot())


def test_metrics_registry_semantics_equal():
    terr, rerr = [], []
    port = _drive_registry(MetricsRegistry(), terr)
    ref = _drive_registry(R_obs.MetricsRegistry(), rerr)
    assert port == ref
    assert terr == rerr == ["ValueError"] * 3
    total, by_reason, by_chip, gauge, hist, mean, _ = port
    assert total == 4.0 and by_reason == {"timeout": 3.0, "token_bucket": 1.0}
    assert by_chip["1"] == {("timeout",): 1.0}
    assert gauge == 10.0 and hist["count"] == 3 and hist["sum"] == 555.0 and mean == 185.0


# -- ExecPolicy.traced -------------------------------------------------------------


def test_exec_policy_traced_composes_and_preserves_identity():
    seen = []
    base = T_Policy(dispatch_hook=seen.append)
    tr = Tracer()
    traced = base.traced(tr)
    assert traced.policy_key() == base.policy_key()
    assert traced == base  # hooks are not part of equality either
    traced.dispatch_hook("NTT")
    traced.dispatch_hook("BCONV")
    assert seen == ["NTT", "BCONV"]
    assert [e["name"] for e in tr.events] == ["NTT", "BCONV"]
    assert base.traced(None) is base
    assert base.traced(Tracer(enabled=False)) is base
    bare = T_Policy(backend="fused")
    assert bare.traced(tr).dispatch_hook is not None


@pytest.fixture(scope="module")
def mul_pair():
    """One n = 2^9 ciphertext, encrypted by the reference and carried into the port."""
    rp = R_P.make_params(1 << 9, 6, 2, check_security=False)
    tp = T_P.make_params(1 << 9, 6, 2, check_security=False)
    rks = R_K.full_keyset(rp, seed=0)
    tks = T_K.full_keyset(tp, seed=0, device=CPU)
    rctx = R_Ctx(params=rp, keys=rks, policy=R_Policy(backend="ref"))
    z = np.random.default_rng(0).normal(size=rp.slots) * 0.4
    rct = rctx.encrypt(rctx.encode(z))
    tct = convert.ciphertext_from_arrays(np.asarray(rct.c0), np.asarray(rct.c1), rct.level, rct.scale, device=CPU)
    return rctx, rct, tp, tks, tct


@pytest.mark.parametrize("backend", ["fused", "staged"])
def test_traced_mul_slices_are_the_dispatches(mul_pair, backend):
    rctx, rct, tp, tks, tct = mul_pair
    seen = []
    ctx = T_Ctx(params=tp, keys=tks, policy=T_Policy(backend=backend, dispatch_hook=seen.append), device=CPU)
    tr = Tracer()
    with T_dispatch.count_dispatches() as counts:
        ctx.with_policy(ctx.policy.traced(tr)).mul(tct, tct)
    names = [e["name"] for e in tr.events]
    assert len(names) == T_dispatch.total(counts) == tr.n_dispatches
    assert names == seen  # the prior hook saw the same launches, in order
    assert {op: names.count(op) for op in counts} == counts
    assert [e["ts"] for e in tr.events] == [float(i) for i in range(len(names))]
    assert validate_chrome_trace(to_chrome_trace(tr)) == []
    # the reference's traced multiply at the same backend; under the fused
    # pipeline the port's rescale is one dispatch (reference_rescale)
    rtr = R_obs.Tracer()
    with reference_rescale.track() as marks:
        rctx.with_policy(rctx.policy.replace(backend=backend).traced(rtr)).mul(rct, rct)
    rnames = [e["name"] for e in rtr.events]
    want = marks.names(rnames) if backend == "fused" else rnames
    assert marks.count == 1 and names == want
    assert hashlib.sha256("\n".join(names).encode()).hexdigest() == hashlib.sha256("\n".join(want).encode()).hexdigest()
    if backend == "fused":
        # the slice names do not depend on the ring: chip_smoke.py's digest of the
        # reference's, taken at lstm, holds here at n = 2^9, and so do the port's
        assert len(rnames) == SMOKE.TRACED_MUL["slices"] == 19
        assert SMOKE.names_sha256(rnames) == SMOKE.TRACED_MUL["names_sha256"]
        assert names == SMOKE.traced_mul_port_names()
