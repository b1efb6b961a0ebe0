"""The readers of the program's own spans (``fhebench/spans.py`` and the four
metrics on it) on a small hand-written Chrome trace: encode spans nested in an
encode and in a BSGS span, an idle gap straddling two encode spans, and program
spans outside the window that must not count."""

import json

import pytest

from fhebench import harness, spans, tracing
from fhebench.tests.test_fhebench_metrics import EVENTS as NO_PROGRAM_SPANS


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _span(name, ts, dur):
    return _x("user_annotation", name, ts, dur)


EVENTS = [
    _span("window", 0, 1000),
    _span("job", 0, 500),
    _span("job", 500, 500),
    _span("dense.1", 100, 300),
    _span("fhe.bsgs", 100, 300),
    _span("fhe.encode", 110, 40),
    _span("fhe.encode.coeffs", 110, 20),
    _span("fhe.encode.upload", 130, 20),
    _span("fhe.encode", 200, 60),
    _span("fhe.encode_const", 210, 20),  # nested in an encode: counted once
    _span("fhe.keyswitch", 300, 50),
    _span("eval_mod", 550, 400),
    _span("fhe.encode_const", 600, 100),
    _span("fhe.keyswitch", 700, 100),
    _span("fhe.encode", 1100, 100),  # after the window
    _span("fhe.keyswitch", -50, 40),  # before it
    _x("kernel", "ntt_pass1", 120, 20, stream=7),
    _x("kernel", "fused_ks_pass_a", 250, 70, stream=7),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 650, 10, bytes=1000),
    _x("kernel", "modops_kernel", 720, 60, stream=7),
    _x("kernel", "late", 1150, 10, stream=7),
]
# busy [120, 140] [250, 320] [650, 660] [720, 780]; idle [0, 120] [140, 250] [320, 650]
# [660, 720] [780, 1000]: 840 us.  Outermost encodes [110, 150] [200, 260] [600, 700]: 200 us.


def _trace(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tracing.load(path, 1e-6)


@pytest.fixture
def trace(tmp_path):
    return _trace(tmp_path, EVENTS)


def read(name, trace):
    return harness.reader("metrics", name)(trace)


def test_outermost_drops_nested_and_outside_spans(trace):
    assert spans.outermost(trace, spans.ENCODES) == [(110, 150), (200, 260), (600, 700)]
    assert spans.outermost(trace, spans.KEYSWITCH) == [(300, 350), (700, 800)]


def test_overlap_of_two_unions():
    assert spans.overlap_us([(0, 10), (20, 30)], [(5, 25), (28, 40)]) == 12.0
    assert spans.overlap_us([(0, 10)], []) == 0.0


def test_encode_ms_per_job(trace):
    assert read("ops.encode_ms_per_job", trace) == pytest.approx(0.1)  # 200 us over 2 jobs


def test_encodes_per_job(trace):
    assert read("ops.encodes_per_job", trace) == pytest.approx(1.5)  # 3 outermost over 2 jobs


def test_encode_idle_share_splits_a_straddling_gap(trace):
    # under encodes: [110, 120] and [140, 150] of the first; [200, 250] of the second, whose
    # gap [140, 250] the first shares; [600, 650] and [660, 700] of the third: 160 of 840 us
    assert read("ops.encode_idle_share", trace) == pytest.approx(100.0 * 160 / 840)


def test_keyswitch_host_ms_per_job(trace):
    assert read("keyswitch.host_ms_per_job", trace) == pytest.approx(0.075)  # 150 us over 2 jobs


def test_idle_gaps_name_the_innermost_program_span(trace):
    # the harness's breakdown charges a whole gap to the innermost span open as it begins
    idle = dict(tracing.breakdown(trace)["idle_gaps"])
    assert idle["fhe.encode.upload"] == pytest.approx(110e-6)  # [140, 250]
    assert idle["fhe.encode_const"] == pytest.approx(60e-6)  # [660, 720]
    assert idle["fhe.keyswitch"] == pytest.approx(550e-6)  # [320, 650] and [780, 1000]
    assert idle["between calls"] == pytest.approx(120e-6)  # [0, 120]


@pytest.mark.parametrize("name", ["ops.encode_ms_per_job", "ops.encodes_per_job", "ops.encode_idle_share",
                                  "keyswitch.host_ms_per_job"])
def test_none_without_program_spans(tmp_path, name):
    assert read(name, _trace(tmp_path, NO_PROGRAM_SPANS)) is None
