"""The ``lstm.unit`` cell at a size a test run holds, on the CPU: a sound run is
correct; the controls and two planted faults (half of the candidate gate's
diagonals dropped; tanh3(c_t) left out, so h_t = o⊙c_t) are not; the work count
issues what the program issues; the cell's three readers on a hand-written
trace.  One ``gpu``-marked case runs the cell at full width on the card."""

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import pytest

from fhebench import check, cost, harness, inputs, tracing
from fhebench.cost import lstm as lstm_cost

ROOT = harness.HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = "lstm.unit"
WIDTH = 16
# The step cut to n = 2^11 and hidden 16 on the cell's chain (L = 13, dnum = 2); sigma 0.2 at
# width 16 moves h_t by as much when half a gate's diagonals go as 0.05 does at width 128.
SMALL = dict(
    n=2048, check_security=False, packing={"n1": 4},
    network={"input": WIDTH, "hidden": WIDTH},
    weights=[{"name": "W", "shape": [4, WIDTH, WIDTH], "sigma": 0.2},
             {"name": "U", "shape": [4, WIDTH, WIDTH], "sigma": 0.2},
             {"name": "b", "shape": [4, WIDTH], "sigma": 0.1}])
SEED = 2**31 + 4321  # past 32 signed bits, as the driver's are


def parts():
    entry, cfg, mix, limits = harness.cell(NAME, BENCH)
    return entry, {**cfg, **SMALL}, mix, limits


def run(job_factory=None, trace=False, tmp_path=None):
    return harness.run_cell(NAME, BENCH, SEED, 0.2, trace, time.perf_counter(), device="cpu", parts=parts(),
                            job_factory=job_factory, trace_path=tmp_path / "trace.json" if tmp_path else None)


def broken(fault):
    from fhebench.jobs.lstm import Job

    def make(cfg, mix, ins, device):
        job = Job(cfg, mix, ins, device)
        plan = job.plan
        if fault == "half_gate":
            cand = plan.w[3]
            keep = dict(list(cand.diags.items())[::2])
            plan.w = plan.w[:3] + (type(cand)(n1=cand.n1, diags=keep),)
        else:  # tanh3(c_t) left out: the series of 4t on c_t/4 is c_t itself
            plan.cell_coeffs = np.array([0.0, 4.0, 0.0, 0.0])
        return job

    return make


def test_sound_run_is_correct(tmp_path):
    r = run(trace=True, tmp_path=tmp_path)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    m = r["metrics"]
    assert m["lstm.gates_encodes_per_job"]["value"] == 2 * 4 * WIDTH  # the diagonals alone
    assert m["lstm.gates_ms_per_job"]["value"] > 0 and m["lstm.act_ms_per_job"]["value"] > 0
    assert m["ops.encodes_per_job"]["value"] == 2 * 4 * WIDTH + 3 * 6 + 2 * 5  # and the series' constants


@pytest.mark.parametrize("fault", ["half_gate", "no_tanh"])
def test_planted_fault_is_not_correct(fault):
    r = run(broken(fault))
    assert not r["correct"] and r["failed"] == r["attempted"]


@pytest.mark.parametrize("kind", check.CONTROLS)
def test_control_is_not_correct(kind):
    _, cfg, mix, limits = parts()
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


def test_work_count_is_what_the_program_issues(monkeypatch):
    """Rotations (a hoisted group counts its size), relinearisations, plaintext
    products and rescales of one step, counted where the program issues them."""
    from fhebench.jobs.lstm import Job
    from repro_torch.fhe import ops

    _, cfg, mix, _ = parts()
    job = Job(cfg, mix, inputs.make(cfg, mix, SEED), "cpu")
    quiet = lambda _name: contextlib.nullcontext()
    job.run(job.pool[0], quiet)  # the biases' encodes, once
    seen = {"rotate": 0, "relin": 0, "plain": 0, "rescale": 0}

    def spy(name, fn, size=lambda *a: 1):
        def wrapped(*args, **kwargs):
            seen[name] += size(*args)
            return fn(*args, **kwargs)
        monkeypatch.setattr(ops, fn.__name__, wrapped)

    spy("rotate", ops._rotate_standard)
    spy("rotate", ops._rotate_hoisted_group, size=lambda ctx, ct, rots, keys: len(set(rots)))
    spy("relin", ops._mul)
    spy("plain", ops._mul_plain)
    spy("rescale", ops._rescale)
    job.run(job.pool[1], quiet)
    counted = lstm_cost.ops(cfg, mix)
    per = lambda names: sum((o[2] if o[0] == "rotate_group" else 1) for o in counted if o[0] in names)
    assert seen["rotate"] == per(("rotate", "rotate_group")) == 8 * 3 + 8 * 3  # n1 = 4: babies 1-3, giants 4-12
    assert seen["relin"] == per(("mul", "square")) == 13
    assert seen["plain"] == per(("mul_plain", "mul_plain_rescale")) == 8 * WIDTH + 5 * 4
    assert seen["rescale"] == per(("mul", "square", "mul_plain_rescale", "rescale"))


def test_work_count_at_the_cell():
    _, cfg, mix, _ = harness.cell(NAME, BENCH)
    counted = lstm_cost.ops(cfg, mix)
    assert sum(o[2] for o in counted if o[0] == "rotate_group") == 56
    assert sum(1 for o in counted if o[0] == "rotate") == 120
    assert sum(1 for o in counted if o[0] == "mul_plain") == 1024
    assert {o[1] for o in counted if o[0] == "mul_plain"} == {13}
    assert min(o[1] for o in counted) == 5  # h_t's product, the last one, at L − 8
    assert 0 < harness.least_s_per_job(cfg, mix) == cost.least_seconds(counted, cfg["n"], 7)


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


EVENTS = [
    _x("user_annotation", "window", 0, 1000),
    _x("user_annotation", "job", 0, 500),
    _x("user_annotation", "job", 500, 500),
    _x("user_annotation", "fhe.lstm.gates", 10, 200),
    _x("user_annotation", "fhe.bsgs", 20, 100),
    _x("user_annotation", "fhe.encode", 30, 10),
    _x("user_annotation", "fhe.encode", 50, 10),
    _x("user_annotation", "fhe.encode.coeffs", 50, 5),
    _x("user_annotation", "fhe.encode", 150, 20),
    _x("user_annotation", "fhe.lstm.act", 220, 100),
    _x("user_annotation", "fhe.encode", 230, 10),  # an encode outside the gates
    _x("user_annotation", "fhe.lstm.gates", 510, 100),
    _x("user_annotation", "fhe.encode", 520, 10),
    _x("user_annotation", "fhe.lstm.act", 620, 50),
    _x("user_annotation", "fhe.lstm.act", 640, 80),  # overlaps the one before: the union counts
    _x("user_annotation", "fhe.lstm.gates", 1100, 50),  # after the window
    _x("user_annotation", "fhe.encode", 1110, 10),
    _x("kernel", "ntt_pass1", 40, 5, stream=7),
]


@pytest.fixture
def trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return tracing.load(path, 1e-6)


@pytest.mark.parametrize("metric, want", [("lstm.gates_ms_per_job", 0.15), ("lstm.gates_encodes_per_job", 2.0),
                                          ("lstm.act_ms_per_job", 0.1)])
def test_readers(trace, metric, want):
    assert harness.reader("metrics", metric)(trace) == pytest.approx(want)  # 300 us, 4 encodes, 200 us over 2 jobs


@pytest.mark.parametrize("metric", ["lstm.gates_ms_per_job", "lstm.gates_encodes_per_job", "lstm.act_ms_per_job"])
def test_readers_find_nothing_in_another_cell(tmp_path, metric):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [e for e in EVENTS if not e["name"].startswith("fhe.lstm")]}))
    assert harness.reader("metrics", metric)(tracing.load(path, 1e-6)) is None


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_cell_runs_correct_on_the_card(card):
    out = subprocess.run([sys.executable, "fhebench/run.py", "--workload", NAME, "--seed", "2147483711",
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
