"""The ``resnet20.block`` cell at a size a test run holds, on the CPU: a sound run is
correct; the controls and a planted fault (one composite stage left out) are
not; the work count issues what the program issues; the cell's three readers
on a hand-written trace.  ``broken`` also plants the two other faults the
cell's limit was set against on the card, half of conv₂'s diagonals left out
and the convolutions rotated at Δ (which reads wrong only at the cell's N).
One ``gpu``-marked case runs the cell at full width on the card."""

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import pytest

from fhebench import check, cost, harness, inputs, spans, tracing
from fhebench.cost import resnet as resnet_cost

ROOT = harness.HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = "resnet20.block"
C, H, W = 4, 8, 8
# The block cut to n = 2^10 and 4 channels on an 8 × 8 map (period 256, two copies
# over the 512 slots) on the cell's chain (L = 41, dnum = 1), He-initialised over
# the smaller fan-in, with the baby-step counts the cost model picks there.
SMALL = dict(n=1024, network={"channels": C, "height": H, "width": W},
             weights=[{"name": k, "shape": [C, C, 3, 3] if k.startswith("conv") else [C],
                       "sigma": math.sqrt(2 / (9 * C)) if k.startswith("conv") else 0.1}
                      for k in ("conv1", "b1", "conv2", "b2")],
             packing={"n1": [64, 64]})
SEED = 2**31 + 4321  # past 32 signed bits, as a run's seed may be


def parts(**mix_changes):
    entry, cfg, mix, limits = harness.cell(NAME, BENCH)
    return entry, {**cfg, **SMALL}, {**mix, **mix_changes}, limits


def run(job_factory=None, trace=False, tmp_path=None, **mix_changes):
    return harness.run_cell(NAME, BENCH, SEED, 0.01, trace, time.perf_counter(), device="cpu",
                            parts=parts(**mix_changes), job_factory=job_factory,
                            trace_path=tmp_path / "trace.json" if tmp_path else None)


def broken(fault):
    """The cell's job with a fault planted: ``no_stage`` (the ReLU's composite less
    one f₃), ``half_conv2`` (every other of conv₂'s diagonals left out) or
    ``rotate_at_delta`` (each convolution's matvec on its input at Δ, its second
    level a constant product by one: the level and scale are sound)."""
    from fhebench.jobs.resnet import Job
    from repro_torch.fhe import linear, ops, resnet

    class Broken(Job):
        def __init__(self, cfg, mix, ins, device):
            super().__init__(cfg, mix, ins, device)
            plan = self.plan
            if fault == "no_stage":
                plan.relu_coeffs = plan.relu_coeffs[:2] + plan.relu_coeffs[3:]
            elif fault == "half_conv2":
                conv2 = plan.convs[1]
                kept = {d: v for k, (d, v) in enumerate(sorted(conv2.diags.items())) if k % 2 == 0}
                plan.convs = (plan.convs[0], linear.BsgsPlan(n1=conv2.n1, diags=kept))

        def run(self, host, span):
            if fault != "rotate_at_delta":
                return super().run(host, span)
            whole = resnet._conv

            def at_delta(ctx, plan, k, ct):
                y = ops._mul_const_exact(ctx, linear._apply_bsgs(ctx, ct, plan.convs[k]), 1.0, ctx.params.scale)
                return ops._add_plain(ctx, y, plan.bias_plaintext(ctx, k, y.level, y.scale))

            resnet._conv = at_delta
            try:
                return super().run(host, span)
            finally:
                resnet._conv = whole

    return Broken


def test_sound_run_is_correct(tmp_path):
    r = run(trace=True, tmp_path=tmp_path, trace_jobs=1)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    m = r["metrics"]
    _, cfg, _, _ = parts()
    giants = 2 * len({(d // 64) * 64 for d in resnet_cost.diagonals(cfg)} - {0})
    assert m["resnet.conv_keyswitches_per_job"]["value"] == 2 + giants == 8  # a hoisted baby group and 3 giants each
    switches = len(spans.outermost(tracing.load(tmp_path / "trace.json", 1e-6), spans.KEYSWITCH))
    assert switches == 8 + 50  # and 50 relinearisations in the two ReLUs
    assert m["resnet.conv_ms_per_job"]["value"] > 0 and m["resnet.relu_ms_per_job"]["value"] > 0
    assert m["ops.const_on_card_share"]["value"] == 100.0
    assert m["bsgs.diag_hit_share"]["value"] == 100.0 and m["bsgs.mac_share"]["value"] == 100.0
    assert m["ops.encodes_per_job"]["value"] > 0 and m["ops.encode_ms_per_job"]["value"] > 0


def test_planted_fault_is_not_correct():
    r = run(broken("no_stage"), warmup_jobs=0)
    assert not r["correct"] and r["failed"] == r["attempted"] >= 1
    assert r["checks"]["max_err"]["value"] > r["checks"]["max_err"]["limit"]  # the values fail, not only the level


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

    _, cfg, mix, _ = harness.cell(NAME, BENCH)
    p = P.workload_params(cfg["preset"])
    assert (p.n, p.L, p.num_digits, p.scale) == (cfg["n"], cfg["L"], cfg["dnum"], 2.0 ** cfg["scale_bits"])
    assert cfg["check_security"] is False and not p.check_security()  # the preset's own check=False
    assert cfg["network"] == {"channels": 16, "height": 32, "width": 32, "kernel": 3, "stride": 1, "padding": 1,
                              "shortcut": "identity"}
    assert cfg["reduced"] == ["blocks"] and cfg["blocks"] == 1
    assert mix["message"] == {"shape": ["channels", "height", "width"], "low": 0.0, "high": 1.0}
    assert cfg["L"] - 38 == 3  # two convolutions of 2 levels and two ReLUs of 17


@pytest.mark.parametrize("seed", [SEED, 2**31 + 77, 12345])
def test_pre_activations_fit_at_the_cell(seed):
    """At the cell's size every pre-activation of the seeded inputs lies well inside [−B, B]."""
    from fhebench.reference import resnet as ref

    _, cfg, mix, _ = harness.cell(NAME, BENCH)
    ins = inputs.make(cfg, mix, seed)
    w, bound = ins["weights"], cfg["activations"]["relu"]["bound"]
    for x in ins["pool"]:
        a1 = ref.conv3x3(x, w["conv1"], w["b1"])
        a2 = x + ref.conv3x3(ref.relu(cfg, a1), w["conv2"], w["b2"])
        assert max(np.abs(a1).max(), np.abs(a2).max()) < 0.8 * bound


def test_work_count_is_what_the_program_issues(monkeypatch):
    """Rotations, relinearisations, plaintext products and rescales of one block,
    counted where the program issues them."""
    from fhebench.jobs.resnet import Job
    from repro_torch.fhe import linear, ops
    from repro_torch.kernels.bsgsmac import ops as bsgsmac

    _, cfg, mix, _ = parts()
    job = Job(cfg, mix, inputs.make(cfg, mix, SEED), "cpu")
    seen = {"rotate": 0, "group": 0, "relin": 0, "plain": 0, "rescale": 0}

    def spy(module, name, key, count=lambda *a: 1):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            seen[key] += count(*args)
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)

    spy(ops, "_apply_galois", "rotate")
    spy(ops, "_rotate_hoisted_group", "group")
    spy(ops, "_mul", "relin")
    spy(ops, "_mul_plain", "plain")
    spy(ops, "_rescale", "rescale")
    spy(bsgsmac, "bsgs_mac", "plain", lambda data, *a: data.shape[0])  # a matvec's products: one a diagonal
    assert linear.bsgsmac is bsgsmac
    job.run(job.pool[0], lambda _name: contextlib.nullcontext())
    counted = resnet_cost.ops(cfg, mix)
    per = lambda names: sum(1 for o in counted if o[0] in names)
    assert seen["rotate"] == per(("rotate",)) == 6
    assert seen["group"] == per(("rotate_group",)) == 2
    assert seen["relin"] == per(("mul", "square")) == 50
    # each convolution's lift and 36 diagonals, the shortcut's constant, and each of the 8 series'
    # nine: its basis's three alignments, its four terms and two of them brought down
    assert seen["plain"] == per(("mul_plain", "mul_plain_rescale")) == 2 * (1 + 36) + 1 + 8 * 9
    assert seen["rescale"] == per(("mul", "square", "mul_plain_rescale", "rescale"))


def test_work_count_at_the_cell():
    _, cfg, mix, _ = harness.cell(NAME, BENCH)
    counted = resnet_cost.ops(cfg, mix)
    assert [o for o in counted if o[0] == "rotate_group"] == [("rotate_group", 41, 17), ("rotate_group", 22, 17)]
    assert sum(1 for o in counted if o[0] == "rotate") == 14
    assert sum(1 for o in counted if o[0] in ("mul", "square")) == 50
    assert sum(1 for o in counted if o[0] == "mul_plain") == 2 * (144 + 1)
    assert max(o[1] for o in counted) == 41 and min(o[1] for o in counted) == 4  # the last product, at L − 37
    assert 0 < harness.least_s_per_job(cfg, mix) == cost.least_seconds(counted, cfg["n"], 42)


def test_degree_seven_series_counts_as_the_degree_three_one():
    """``series`` counts a degree-3 series as the LSTM's ``activation`` does."""
    from fhebench.cost import lstm as lstm_cost

    c = lstm_cost.chebyshev([0.5, 0.15012, 0.0, -0.001593], 8.0)
    assert resnet_cost.series(c, 10) == lstm_cost.activation(c, 10)
    stage = resnet_cost.series(resnet_cost.stages(harness.cell(NAME, BENCH)[1])[0], 30)
    assert sum(1 for o in stage if o[0] in ("mul", "square")) == 6 and min(o[1] for o in stage) == 26


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


EVENTS = [
    _x("user_annotation", "window", 0, 1000),
    _x("user_annotation", "job", 0, 500),
    _x("user_annotation", "job", 500, 500),
    _x("user_annotation", "fhe.resnet.conv", 10, 200),
    _x("user_annotation", "fhe.keyswitch", 20, 50),
    _x("user_annotation", "fhe.keyswitch", 80, 50),
    _x("user_annotation", "fhe.keyswitch", 90, 10),  # nested in the one before: counted once
    _x("user_annotation", "fhe.resnet.relu", 220, 100),
    _x("user_annotation", "fhe.keyswitch", 230, 10),  # a relinearisation outside the convolutions
    _x("user_annotation", "fhe.resnet.conv", 510, 100),
    _x("user_annotation", "fhe.keyswitch", 520, 10),
    _x("user_annotation", "fhe.resnet.relu", 620, 50),
    _x("user_annotation", "fhe.resnet.relu", 640, 80),  # overlaps the one before: the union counts
    _x("user_annotation", "fhe.resnet.shortcut", 730, 10),
    _x("user_annotation", "fhe.resnet.conv", 1100, 50),  # after the window
    _x("user_annotation", "fhe.keyswitch", 1110, 10),
    _x("kernel", "ntt_pass1", 40, 5, stream=7),
]


@pytest.fixture
def trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return tracing.load(path, 1e-6)


@pytest.mark.parametrize("metric, want", [("resnet.conv_ms_per_job", 0.15),
                                          ("resnet.conv_keyswitches_per_job", 1.5),
                                          ("resnet.relu_ms_per_job", 0.1)])
def test_readers(trace, metric, want):
    assert harness.reader("metrics", metric)(trace) == pytest.approx(want)  # 300 us, 3 switches, 200 us over 2 jobs


@pytest.mark.parametrize("metric", ["resnet.conv_ms_per_job", "resnet.conv_keyswitches_per_job",
                                    "resnet.relu_ms_per_job"])
def test_readers_find_nothing_in_another_cell(tmp_path, metric):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [e for e in EVENTS if not e["name"].startswith("fhe.resnet")]}))
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
