"""The port's serving stack and scheduler against the reference's.

Each scenario runs in both packages on the same seeds and must give the same
``summarize`` / ``summarize_cluster`` dict (compared as sorted JSON, which also
holds NaN entries) and the same per-job fields.  The packages run the same
Python expressions, so floats agree bit for bit.  The last tests hold the
"auto" rule: an ``ExecPolicy(hoisting="always")`` (backend "auto") priced at
``device="cpu"`` is the reference's price on the CPU, priced at
``device="cuda"`` it is the reference's ``backend="fused"`` price, and the
service memo never hands one to the other."""

import hashlib
import importlib.util
import json
import pathlib
import types

import pytest
import torch

from repro import serve as R_serve
from repro.core import hardware as R_H
from repro.core import jobs as R_J
from repro.core import planner as R_PL
from repro.core import scheduler as R_S
from repro.core import simulator as R_SIM
from repro.fhe import params as R_P
from repro.fhe.context import ExecPolicy as R_Policy
from repro_torch import serve as T_serve
from repro_torch.core import hardware as T_H
from repro_torch.core import jobs as T_J
from repro_torch.core import planner as T_PL
from repro_torch.core import scheduler as T_S
from repro_torch.core import simulator as T_SIM
from repro_torch.fhe import params as T_P
from repro_torch.fhe.context import ExecPolicy as T_Policy
from repro_torch.serve import policy as T_SP

torch.set_num_threads(1)

# module namespaces in the shape chip_smoke.py's builders take (S = simulator)
REF = types.SimpleNamespace(serve=R_serve, H=R_H, J=R_J, PL=R_PL, S=R_SIM, P=R_P)
PORT = types.SimpleNamespace(serve=T_serve, H=T_H, J=T_J, PL=T_PL, S=T_SIM, P=T_P)
CHIP_NAMES = ("flash-fhe", "craterlake", "f1plus", "flash-fhe-fmac")


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _chip_smoke()


def _blob(summary: dict) -> str:
    return json.dumps(summary, sort_keys=True)


def _job_rows(jobs):
    return [(je.job.job_id, je.job.workload, je.first_start, je.completion, je.lanes, je.chip_index,
             je.state.name, je.preempted_cycles, je.service_cycles) for je in jobs]


# The scenarios are chip_smoke.py's, which runs them on the card's host against
# the reference digests of its SCHEDULING table: each takes a namespace of one
# package's modules and returns (summary, result).
SCENARIOS = SMOKE.SERVING_SCENARIOS


def _extra_checks(name, res):
    """What each scenario must exercise."""
    if name == "hetero":
        assert res.gangs
    if name == "overload":
        assert sum(je.state.name == "SHED" for je in res.jobs) > 0
    if name == "mixed_schemes":
        assert {je.job.scheme for je in res.jobs} == {"ckks", "bgv"}


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_equal(name):
    r_sum, r_res = SCENARIOS[name](REF)
    t_sum, t_res = SCENARIOS[name](PORT)
    assert _blob(t_sum) == _blob(r_sum)
    assert _job_rows(t_res.jobs) == _job_rows(r_res.jobs)
    assert len(t_res.jobs) > 40
    _extra_checks(name, t_res)
    # chip_smoke.py holds the card's run of this scenario against this digest
    assert SMOKE.summary_sha256(t_sum) == SMOKE.summary_sha256(r_sum) == SMOKE.SCHEDULING["summaries"][name]


def test_plan_and_price_digest():
    """chip_smoke.py's planner + simulator digest over every preset."""
    blobs = [SMOKE.plan_and_price_blob({n: SMOKE.plan_and_price(pkg, n) for n in R_PL.available_workloads()})
             for pkg in (REF, PORT)]
    assert blobs[0] == blobs[1]
    assert hashlib.sha256(blobs[1].encode()).hexdigest() == SMOKE.SCHEDULING["plan_and_price"]


@pytest.mark.parametrize("chip", CHIP_NAMES)
def test_schedule_equal(chip):
    def run(pkg, sched):
        jobs = [pkg.J.make_job(w, priority=i % 3, arrival_cycle=i * 150_000, job_id=i)
                for i, w in enumerate(["matmul", "lstm", "lola_mnist_plain", "psi", "dblookup",
                                       "logreg", "exact_count", "matmul", "lola_cifar_plain", "lstm"])]
        return sched.schedule(jobs, pkg.H.CHIPS[chip])

    ref, port = run(REF, R_S), run(PORT, T_S)
    assert len(port) == len(ref) == 10
    for r, t in zip(ref, port):
        assert (t.job.job_id, t.start_cycle, t.end_cycle, t.lanes, t.preempted_cycles, t.chip_index) == \
            (r.job.job_id, r.start_cycle, r.end_cycle, r.lanes, r.preempted_cycles, r.chip_index)
        assert vars(t.sim) == vars(r.sim)
    assert T_S.makespan(port) == R_S.makespan(ref)
    assert T_S.avg_completion_cycles(port) == R_S.avg_completion_cycles(ref)


def test_schedule_fleet_equal():
    def run(pkg, sched):
        jobs = [pkg.J.make_job(w, arrival_cycle=i * 80_000, job_id=i)
                for i, w in enumerate(["lstm", "matmul", "logreg", "psi", "lstm", "lola_mnist_plain"])]
        return sched.schedule(jobs, pkg.H.FLASH_FHE, n_chips=3, router="round_robin", gang_max_chips=2)

    ref, port = run(REF, R_S), run(PORT, T_S)
    assert [(s.job.job_id, s.start_cycle, s.end_cycle, s.lanes, s.chip_index) for s in port] == \
        [(s.job.job_id, s.start_cycle, s.end_cycle, s.lanes, s.chip_index) for s in ref]


# -- the "auto" rule ------------------------------------------------------------


def _prices(pkg, policy, device=None):
    """{(chip, workload): SimResult fields} for every preset on every chip."""
    kw = {} if device is None else {"device": device}
    out = {}
    for chip in CHIP_NAMES:
        for w in pkg.serve.traffic.MULTISCHEME_MIX:
            sim = pkg.serve.job_service_sim(pkg.J.make_job(w), pkg.H.CHIPS[chip], policy=policy, **kw)
            out[(chip, w)] = dict(vars(sim))
    return out


def test_auto_policy_prices_by_device():
    """``ExecPolicy(hoisting="always")`` as ``tests/test_cluster.py`` prices
    it: on "cpu" the reference's CPU price, on "cuda" the reference's fused
    price, both in one process in either order, with no alias between them."""
    auto = T_Policy(hoisting="always")
    assert auto.backend == "auto"
    ref_cpu = _prices(REF, R_Policy(hoisting="always"))
    ref_fused = _prices(REF, R_Policy(backend="fused", hoisting="always"))
    assert ref_cpu != ref_fused  # the two resolutions price differently
    T_SP._SERVICE_MEMO.clear()
    assert _prices(PORT, auto, "cpu") == ref_cpu
    assert _prices(PORT, auto, "cuda") == ref_fused
    assert _prices(PORT, auto, "cpu") == ref_cpu  # memo hits keep their resolution
    T_SP._SERVICE_MEMO.clear()
    assert _prices(PORT, auto, "cuda") == ref_fused
    assert _prices(PORT, auto, "cpu") == ref_cpu
    assert _prices(PORT, auto) == ref_fused  # the port's default device is "cuda"
    # explicit backends never depend on the device
    fused = T_Policy(backend="fused", hoisting="always")
    assert _prices(PORT, fused, "cpu") == _prices(PORT, fused, "cuda") == ref_fused


def test_auto_policy_fleet_by_device():
    """The same rule through ``serve_cluster`` / ``ClusterConfig`` and
    ``schedule``: a whole fleet run under the "auto" policy."""
    def fleet(pkg, policy, **kw):
        cfg = pkg.serve.traffic.PoissonConfig(rate_per_mcycle=10.0, n_jobs=40, seed=2)
        res = pkg.serve.serve_cluster(pkg.serve.traffic.poisson_jobs(cfg), pkg.H.FLASH_FHE, n_chips=2,
                                      exec_policy=policy, **kw)
        return _blob(pkg.serve.metrics.summarize_cluster(res))

    ref_cpu = fleet(REF, R_Policy(hoisting="always"))
    ref_fused = fleet(REF, R_Policy(backend="fused", hoisting="always"))
    assert ref_cpu != ref_fused
    auto = T_Policy(hoisting="always")
    assert fleet(PORT, auto, device="cpu") == ref_cpu
    assert fleet(PORT, auto, device="cuda") == ref_fused
    assert T_serve.ClusterConfig(n_chips=2).device == "cuda"

    jobs = lambda pkg: [pkg.J.make_job(w, arrival_cycle=i * 50_000, job_id=i)
                        for i, w in enumerate(["lstm", "matmul", "logreg"])]
    rows = lambda s: [(x.start_cycle, x.end_cycle, x.lanes) for x in s]
    assert rows(T_S.schedule(jobs(PORT), T_H.FLASH_FHE, exec_policy=auto, device="cpu")) == \
        rows(R_S.schedule(jobs(REF), R_H.FLASH_FHE, exec_policy=R_Policy(hoisting="always")))
    assert rows(T_S.schedule(jobs(PORT), T_H.FLASH_FHE, exec_policy=auto, device="cuda")) == \
        rows(R_S.schedule(jobs(REF), R_H.FLASH_FHE, exec_policy=R_Policy(backend="fused", hoisting="always")))


def test_capacity_estimators_equal():
    mix = T_serve.traffic.MULTISCHEME_MIX
    for chip in CHIP_NAMES:
        assert T_serve.mix_capacity_jobs_per_mcycle(mix, T_H.CHIPS[chip]) == \
            R_serve.mix_capacity_jobs_per_mcycle(mix, R_H.CHIPS[chip])
    pairs_t = [T_H.FLASH_FHE, (T_H.CRATERLAKE, T_Policy(hoisting="always"))]
    pairs_r = [R_H.FLASH_FHE, (R_H.CRATERLAKE, R_Policy(hoisting="always"))]
    assert T_serve.fleet_capacity_jobs_per_mcycle(mix, pairs_t, device="cpu") == \
        R_serve.fleet_capacity_jobs_per_mcycle(mix, pairs_r)
