"""``rescale.fused_share`` on small hand-written traces: the share of the
window's outermost ``fhe.rescale`` spans that hold an ``fhe.rescale.fused`` span."""

import pytest

from fhebench import harness, tracing


def _x(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "args": {}}


def _trace(jobs, rescales, fused):
    """A window of ``jobs`` jobs 1,000 us apart, each with ``rescales``
    ``fhe.rescale`` spans 100 us apart, the first ``fused`` of them holding an
    ``fhe.rescale.fused`` (after a ``fhe.table`` build, as a first call opens one)."""
    events = [_x("window", 0, 1000 * jobs)]
    for j in range(jobs):
        t0 = 1000 * j
        events.append(_x("job", t0, 1000))
        for r in range(rescales):
            ts = t0 + 10 + 100 * r
            events += [_x("fhe.keyswitch", ts - 8, 6), _x("fhe.rescale", ts, 40),
                       _x("fhe.table.fused_rescale_tables", ts + 2, 3)]
            if r < fused:
                events.append(_x("fhe.rescale.fused", ts + 8, 20))
    return events


def read(events):
    return harness.reader("metrics", "rescale.fused_share")(tracing.from_events(events, 1e-6))


@pytest.mark.parametrize("jobs, rescales, fused, share", [(1, 3, 3, 100.0), (2, 8, 8, 100.0), (1, 4, 2, 50.0),
                                                          (2, 2, 1, 50.0), (1, 4, 1, 25.0)])
def test_share_of_rescales_with_one_launch(jobs, rescales, fused, share):
    assert read(_trace(jobs, rescales, fused)) == pytest.approx(share)


def test_no_rescale_reads_none():
    assert read(_trace(1, 0, 0)) is None  # the window and its job alone
    # a fused span outside any rescale span gives no reading either
    assert read([_x("window", 0, 1000), _x("job", 0, 1000), _x("fhe.rescale.fused", 20, 5)]) is None


def test_a_program_without_the_span_reads_none():
    """Rescales that run each component's kernels in turn open no
    ``fhe.rescale.fused``: nothing to read, not 0."""
    assert read(_trace(2, 3, 0)) is None


def test_only_outermost_rescale_spans_in_the_window_count():
    events = _trace(1, 2, 1)
    events.append(_x("fhe.rescale", 12, 20))  # nested in the first rescale's span: not a rescale of its own
    events.append(_x("fhe.rescale.fused", 13, 2))  # nested fused span: the first rescale holds one either way
    events += [_x("fhe.rescale", 1200, 40), _x("fhe.rescale.fused", 1210, 10)]  # after the window
    assert read(events) == pytest.approx(50.0)
