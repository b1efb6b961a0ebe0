"""Each reader of ``fhebench/metrics`` on a small hand-written Chrome trace:
kernels overlapping on two streams, a copy overlapping them, an idle gap under
a named span, and device work outside the window that must not count."""

import json

import pytest

from fhebench import harness, tracing


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


EVENTS = [
    _x("user_annotation", "window", 0, 1000),
    _x("user_annotation", "job", 0, 500),
    _x("user_annotation", "job", 500, 500),
    _x("user_annotation", "upload", 0, 100),
    _x("user_annotation", "apply_bsgs.1", 100, 300),
    _x("user_annotation", "download", 400, 100),
    _x("user_annotation", "eval_mod", 500, 450),
    _x("user_annotation", "download", 950, 50),
    _x("cpu_op", "aten::empty", 5, 2),
    _x("kernel", "void fused_ks<int>(int*, int)", 110, 100, stream=7),
    _x("kernel", "void (anonymous namespace)::ntt_pass(int*)", 150, 100, stream=8),
    _x("kernel", "void fused_ks<int>(int*, int)", 600, 100, stream=7),
    _x("kernel", "late", 1100, 50, stream=7),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 20, 30, bytes=1000000),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 200, 100, bytes=2000000),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 960, 20, bytes=500000),
    _x("gpu_memset", "Memset (Device)", 700, 10),
    {"ph": "i", "cat": "instant", "name": "marker", "ts": 1, "args": {}},
]
LEAST = 60e-6  # s a job


@pytest.fixture
def trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return tracing.load(path, LEAST, peak_bytes=3 * 2**30)


def read(name, trace):
    return harness.reader("metrics", name)(trace)


def test_window_and_jobs(trace):
    assert trace.window == (0, 1000) and trace.jobs == 2 and trace.window_s == pytest.approx(1e-3)


def test_busy_is_the_union_of_kernels_copies_and_memsets(trace):
    # [20, 50] + [110, 300] + [600, 710] + [960, 980]; the kernel at 1100 lies outside
    assert tracing.busy_s(trace) == pytest.approx(350e-6)


def test_h2d_mb_per_job(trace):
    assert read("ops.h2d_mb_per_job", trace) == pytest.approx(1.5)


def test_launches_per_job(trace):
    assert read("ops.launches_per_job", trace) == pytest.approx(1.5)


def test_kernels_roofline_over_the_union_of_both_streams(trace):
    # kernel time [110, 250] + [600, 700] = 240 us; least 2 × 60 us
    assert read("kernels_roofline", trace) == pytest.approx(50.0)


def test_mfu(trace):
    assert read("mfu", trace) == pytest.approx(12.0)


def test_idle_share(trace):
    assert read("device.idle_share", trace) == pytest.approx(65.0)


def test_peak_gib(trace):
    assert read("device.peak_gib", trace) == pytest.approx(3.0)


def test_idle_gaps_labelled_by_the_open_span(trace):
    b = tracing.breakdown(trace)
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps == pytest.approx({"apply_bsgs.1": 300e-6, "eval_mod": 250e-6, "upload": 80e-6, "download": 20e-6})
    assert [k for k, _ in b["idle_gaps"]] == ["apply_bsgs.1", "eval_mod", "upload", "download"]


def test_device_ops_by_short_name(trace):
    ops = dict((k, v) for k, v in tracing.breakdown(trace)["device_ops"])
    assert ops["fused_ks"] == pytest.approx(200e-6)
    assert "late" not in ops  # it ran after the window
    assert ops["ntt_pass"] == pytest.approx(100e-6)
    assert ops["Memcpy HtoD (Pageable -> Device)"] == pytest.approx(130e-6)


def test_readers_return_nothing_without_device_work(tmp_path):
    path = tmp_path / "empty.json"
    path.write_text(json.dumps({"traceEvents": [_x("user_annotation", "window", 0, 10)]}))
    t = tracing.load(path, LEAST)
    for name in ("ops.h2d_mb_per_job", "ops.launches_per_job", "kernels_roofline", "device.idle_share",
                 "device.peak_gib"):
        assert read(name, t) is None, name


def test_one_window_span_is_required(tmp_path):
    path = tmp_path / "none.json"
    path.write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(ValueError):
        tracing.load(path, LEAST)
