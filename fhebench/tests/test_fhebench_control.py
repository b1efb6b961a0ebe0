"""``correct`` at a size a test run holds, on the CPU: a sound run passes; each
control (the reference's own answers: with float64 residue products, at
Δ = 2^24, and at Δ = 2^24 labelled with the stated scale) and each planted
fault fail the cell's own limits.

Each case skips the harness's look for a card and drives the rest of a run
(keys, the client's pool, the warm-up, a window of jobs, the comparison) with
the timed path broken underneath: a job that returns its input unchanged, one
that leaves out half of the work (half the last layer's diagonals, half the
sine's terms), and one whose answer has one residue altered where it is produced.
"""

import json
import time

import numpy as np
import pytest

from fhebench import check, harness, inputs

ROOT = harness.HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SMALL = {
    "lola_mnist.infer": dict(  # the network cut to n = 2^9: an 8 × 8 image, conv 3 × 3 stride 2, 2 maps
        n=512, check_security=False, packing={"conv_n1": 4, "dense_n1": [4, 2]},
        network={"image": 8, "pad": 1, "conv": {"maps": 2, "kernel": 3, "stride": 2}, "dense": [10, 4]},
        weights=[{"name": "conv", "shape": [2, 3, 3], "sigma": 0.3}, {"name": "conv.bias", "shape": [2], "sigma": 0.1},
                 {"name": "dense.1", "shape": [10, 32], "sigma": 0.2},
                 {"name": "dense.1.bias", "shape": [10], "sigma": 0.1},
                 {"name": "dense.2", "shape": [4, 10], "sigma": 0.3},
                 {"name": "dense.2.bias", "shape": [4], "sigma": 0.1}]),
    "packed_bootstrap.evalmod": dict(n=512, L=14, eval_mod={"K": 2, "degree": 32}),
}
SEED = 2**31 + 12345  # past 32 signed bits, as the driver's are


def parts(name):
    entry, cfg, mix, limits = harness.cell(name, BENCH)
    return entry, {**cfg, **SMALL[name]}, {**mix, "trace_jobs": 2}, limits


def run(name, job_factory=None):
    return harness.run_cell(name, BENCH, SEED, 0.5, False, time.perf_counter(), device="cpu",
                            parts=parts(name), job_factory=job_factory)


def broken(name, fault):
    real = __import__(f"fhebench.jobs.{parts(name)[2]['job']}", fromlist=["Job"]).Job

    def make(cfg, mix, ins, device):
        job = real(cfg, mix, ins, device)
        if fault == "half":
            if hasattr(job, "plans"):
                plan = job.plans[-1]
                keep = dict(list(plan.diags.items())[: len(plan.diags) // 2])
                job.plans[-1] = type(plan)(n1=plan.n1, diags=keep)
            else:
                c = job.bctx.sine_coeffs.copy()
                c[1::4] = 0.0  # half of the sine's (odd) terms
                job.bctx.sine_coeffs = c
        run_ = job.run

        def faulty(host, span):
            if fault == "unchanged":
                return host
            out = run_(host, span)
            if fault == "altered":
                c0 = out.c0.clone()
                c0[out.level, 7] = (c0[out.level, 7] + 1) % int(job.ctx.params.q_primes[out.level])
                out.c0 = c0
            return out

        job.run = faulty
        return job

    return make


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks" and set(r["metrics"]) >= {"jobs_per_s", "setup_s"}


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_planted_fault_is_not_correct(name, fault):
    r = run(name, broken(name, fault))
    assert not r["correct"] and r["failed"] == r["attempted"]


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("kind", check.CONTROLS)
def test_control_is_not_correct(name, kind):
    _, cfg, mix, limits = parts(name)
    for seed in (SEED, SEED + 1, SEED + 2):
        ins = inputs.make(cfg, mix, seed)
        answers = check.control_answers(cfg, mix, ins, np.random.default_rng(seed), kind)
        v = check.judge(cfg, mix, ins, answers, limits["max_err"])
        assert len(v["bad"]) == len(answers)
        if kind == "residue":
            assert v["max_err"] > 1e6 * limits["max_err"] and v["meta_mismatch"] == 0
        elif kind == "scale24":  # its own scale decodes it well: the exact bookkeeping is what fails it
            assert v["meta_mismatch"] == len(answers) and v["max_err"] < limits["max_err"]
        else:
            assert v["max_err"] > limits["max_err"] and v["meta_mismatch"] == 0


def test_same_seed_same_inputs():
    _, cfg, mix, _ = parts("lola_mnist.infer")
    a, b = inputs.make(cfg, mix, SEED), inputs.make(cfg, mix, SEED)
    assert np.array_equal(a["s"], b["s"]) and np.array_equal(a["pool"], b["pool"])
    assert a["weights"].keys() == b["weights"].keys()
    assert all(np.array_equal(a["weights"][k], b["weights"][k]) for k in a["weights"])
