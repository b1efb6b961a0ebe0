"""The ``logreg.train`` cell at a size a test run holds, on the CPU: a sound run is
correct; the controls and two planted faults (one rotation of the row sum left
out; σ3's cubic term left out) are not; the work count issues what the program
issues; the cell's three readers on a hand-written trace.  One ``gpu``-marked
case runs the cell at full width on the card."""

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import pytest

from fhebench import check, cost, harness, inputs, spans, tracing
from fhebench.cost import logreg as logreg_cost

ROOT = harness.HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = "logreg.train"
FEATURES, BATCH = 16, 128
# The period cut to n = 2^11, 16 features and two ciphertexts of 64 rows on the cell's chain
# (L = 33, dnum = 2).  With 16 features in place of 256, z·v is 4× smaller; γ_t = 40/(t + 1) in
# place of 10/(t + 1) brings it back towards the cell's range (|z·v| up to 4.3 at SEED), where
# σ3's cubic term moves w_4 by more than the cell's limit, as it does at the cell.
SMALL = dict(n=2048, check_security=False, network={"batch": BATCH, "features": FEATURES},
             weights=[{"name": "w0", "shape": [FEATURES], "sigma": 0.1}])
SEED = 2**31 + 4321  # past 32 signed bits, as a run's seed may be


def parts():
    entry, cfg, mix, limits = harness.cell(NAME, BENCH)
    rates = [40 / (t + 1) for t in range(1, cfg["iterations"] + 1)]
    return entry, {**cfg, **SMALL, "schedule": {**cfg["schedule"], "learning_rate": rates}}, mix, limits


def run(job_factory=None, trace=False, tmp_path=None):
    return harness.run_cell(NAME, BENCH, SEED, 0.2, trace, time.perf_counter(), device="cpu", parts=parts(),
                            job_factory=job_factory, trace_path=tmp_path / "trace.json" if tmp_path else None)


def broken(fault):
    from fhebench.jobs.logreg import Job
    from repro_torch.fhe import logreg, polyeval

    class Broken(Job):
        def __init__(self, cfg, mix, ins, device):
            super().__init__(cfg, mix, ins, device)
            plan = self.plan
            if fault == "no_cubic":  # σ3 less its cubic term, γ_t/m and the sign folded in, still a degree-3 series
                linear = np.zeros(4)
                linear[:2] = polyeval.chebyshev_on_unit([polyeval.SIGMOID3[0], -polyeval.SIGMOID3[1]], logreg.BOUND)
                plan.sigmoid_coeffs = tuple(linear * (g / plan.batch) for g in cfg["schedule"]["learning_rate"])

        def run(self, host, span):
            if fault != "short_rowsum":
                return super().run(host, span)
            whole = logreg._rotsum

            def short(ctx, cts, steps):  # the row sum's last rotation left out
                return whole(ctx, cts, steps[:-1] if tuple(steps) == self.plan.feature_steps else steps)

            logreg._rotsum = short
            try:
                return super().run(host, span)
            finally:
                logreg._rotsum = whole

    return Broken


def test_sound_run_is_correct(tmp_path):
    r = run(trace=True, tmp_path=tmp_path)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    m = r["metrics"]
    rotations = 4 * (2 * (4 + 4) + 6)  # 4 iterations: two ciphertexts' row sums and copies, 6 row steps
    assert m["logreg.rotsum_keyswitches_per_job"]["value"] == rotations == 88
    switches = len(spans.outermost(tracing.load(tmp_path / "trace.json", 1e-6), spans.KEYSWITCH))
    assert switches == rotations + 4 * 2 * 4  # and 4 relinearisations a ciphertext an iteration
    assert m["logreg.rotsum_ms_per_job"]["value"] > 0 and m["logreg.sigmoid_ms_per_job"]["value"] > 0
    assert m["ops.const_on_card_share"]["value"] == 100.0


def test_small_cell_reaches_into_the_fit():
    """At SEED some |z·v| passes 3, where σ3's cubic term counts, and every one stays inside [−8, 8]."""
    from fhebench.reference import logreg as ref

    _, cfg, mix, _ = parts()
    ins = inputs.make(cfg, mix, SEED)
    w0 = ins["weights"]["w0"]
    cut = lambda k: {**cfg, "schedule": {key: vals[:k] for key, vals in cfg["schedule"].items()}}
    biggest = max(np.abs(z @ (w0 if k == 0 else ref.train(cut(k), w0, z)[1])).max()
                  for z in ins["pool"] for k in range(cfg["iterations"]))
    assert 3.0 < biggest < 8.0


@pytest.mark.parametrize("fault", ["short_rowsum", "no_cubic"])
def test_planted_fault_is_not_correct(fault):
    r = run(broken(fault))
    assert not r["correct"] and r["failed"] == r["attempted"]
    assert r["checks"]["meta_mismatch"]["value"] == 0  # the level and scale are sound: the values fail


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


def test_configuration_is_consistent():
    from repro_torch.fhe import params as P

    _, cfg, _, _ = harness.cell(NAME, BENCH)
    lam = [0.0, 1.0]
    while len(lam) < cfg["iterations"] + 2:
        lam.append((1 + np.sqrt(1 + 4 * lam[-1] ** 2)) / 2)
    ts = range(1, cfg["iterations"] + 1)
    assert cfg["schedule"]["learning_rate"] == [10 / (t + 1) for t in ts]
    assert cfg["schedule"]["momentum"] == [(1 - lam[t]) / lam[t + 1] for t in ts]
    p = P.workload_params(cfg["preset"])
    assert (p.n, p.L, p.num_digits, p.scale) == (cfg["n"], cfg["L"], cfg["dnum"], 2.0 ** cfg["scale_bits"])
    assert cfg["network"] == {"batch": 256, "features": 256} and cfg["check_security"]
    assert cfg["L"] - 7 * cfg["iterations"] >= 5 > cfg["L"] - 7 * (cfg["iterations"] + 1)  # a fifth would not fit


def test_work_count_is_what_the_program_issues(monkeypatch):
    """Rotations, relinearisations, plaintext products and rescales of one period,
    counted where the program issues them."""
    from fhebench.jobs.logreg import Job
    from repro_torch.fhe import ops

    _, cfg, mix, _ = parts()
    job = Job(cfg, mix, inputs.make(cfg, mix, SEED), "cpu")
    quiet = lambda _name: contextlib.nullcontext()
    job.run(job.pool[0], quiet)  # the masks' encodes, once
    seen = {"rotate": 0, "relin": 0, "plain": 0, "rescale": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            seen[name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(ops, fn.__name__, wrapped)

    spy("rotate", ops._apply_galois)
    spy("relin", ops._mul)
    spy("plain", ops._mul_plain)
    spy("rescale", ops._rescale)
    job.run(job.pool[1], quiet)
    counted = logreg_cost.ops(cfg, mix)
    per = lambda names: sum(1 for o in counted if o[0] in names)
    assert seen["rotate"] == per(("rotate",)) == 88
    assert seen["relin"] == per(("mul", "square")) == 32
    assert seen["plain"] == per(("mul_plain", "mul_plain_rescale"))
    extra = cfg["iterations"] * (BATCH // (cfg["n"] // 2 // FEATURES) - 1)  # the g⊙Z products rescale once, summed
    assert seen["rescale"] == per(("mul", "square", "mul_plain_rescale", "rescale")) - extra == 80


def test_work_count_at_the_cell():
    _, cfg, mix, _ = harness.cell(NAME, BENCH)
    counted = logreg_cost.ops(cfg, mix)
    rotations = [o for o in counted if o[0] == "rotate"]
    relins = [o for o in counted if o[0] in ("mul", "square")]
    assert len(rotations) == 156 and len(relins) == 32
    assert len(rotations) / (len(rotations) + len(relins)) > 0.82
    assert max(o[1] for o in counted) == 33 and min(o[1] for o in counted) == 5  # v_4's add, at L − 28
    assert 0 < harness.least_s_per_job(cfg, mix) == cost.least_seconds(counted, cfg["n"], 17)
    surplus = sum(cost.op("rescale", cfg["n"], 33 - 7 * t - 5, 17).seconds for t in range(4))  # cost/logreg.py
    assert surplus < 0.005 * harness.least_s_per_job(cfg, mix)


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


EVENTS = [
    _x("user_annotation", "window", 0, 1000),
    _x("user_annotation", "job", 0, 500),
    _x("user_annotation", "job", 500, 500),
    _x("user_annotation", "fhe.logreg.rotsum", 10, 200),
    _x("user_annotation", "fhe.keyswitch", 20, 50),
    _x("user_annotation", "fhe.keyswitch", 80, 50),
    _x("user_annotation", "fhe.keyswitch", 90, 10),  # nested in the one before: counted once
    _x("user_annotation", "fhe.logreg.sigmoid", 220, 100),
    _x("user_annotation", "fhe.keyswitch", 230, 10),  # a relinearisation outside the chains
    _x("user_annotation", "fhe.logreg.rotsum", 510, 100),
    _x("user_annotation", "fhe.keyswitch", 520, 10),
    _x("user_annotation", "fhe.logreg.sigmoid", 620, 50),
    _x("user_annotation", "fhe.logreg.sigmoid", 640, 80),  # overlaps the one before: the union counts
    _x("user_annotation", "fhe.logreg.rotsum", 1100, 50),  # after the window
    _x("user_annotation", "fhe.keyswitch", 1110, 10),
    _x("kernel", "ntt_pass1", 40, 5, stream=7),
]


@pytest.fixture
def trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return tracing.load(path, 1e-6)


@pytest.mark.parametrize("metric, want", [("logreg.rotsum_ms_per_job", 0.15),
                                          ("logreg.rotsum_keyswitches_per_job", 1.5),
                                          ("logreg.sigmoid_ms_per_job", 0.1)])
def test_readers(trace, metric, want):
    assert harness.reader("metrics", metric)(trace) == pytest.approx(want)  # 300 us, 3 switches, 200 us over 2 jobs


@pytest.mark.parametrize("metric", ["logreg.rotsum_ms_per_job", "logreg.rotsum_keyswitches_per_job",
                                    "logreg.sigmoid_ms_per_job"])
def test_readers_find_nothing_in_another_cell(tmp_path, metric):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [e for e in EVENTS if not e["name"].startswith("fhe.logreg")]}))
    assert harness.reader("metrics", metric)(tracing.load(path, 1e-6)) is None


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_cell_runs_correct_on_the_card(card):
    out = subprocess.run([sys.executable, "fhebench/run.py", "--workload", NAME, "--seed", "2147483713",
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
