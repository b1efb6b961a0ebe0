"""``bsgs.diag_hit_share`` on small hand-written traces: the share of the
diagonals inside the window's outermost ``fhe.bsgs`` spans that the plan held
(an ``fhe.bsgs.diag_hit`` span) rather than encoded (an outermost ``fhe.encode``)."""

import pytest

from fhebench import harness, tracing


def _x(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "args": {}}


def _trace(jobs, hits, encodes):
    """A window of ``jobs`` jobs 1,000 us apart, each one ``fhe.bsgs`` span over
    ``hits`` kept diagonals and then ``encodes`` encoded ones, 10 us apart."""
    events = [_x("window", 0, 1000 * jobs)]
    for j in range(jobs):
        t0 = 1000 * j
        events += [_x("job", t0, 1000), _x("fhe.bsgs", t0 + 5, 900)]
        for i in range(hits + encodes):
            ts = t0 + 10 + 10 * i
            if i < hits:
                events.append(_x("fhe.bsgs.diag_hit", ts, 1))
            else:
                events += [_x("fhe.encode", ts, 8), _x("fhe.encode.coeffs", ts + 1, 3), _x("fhe.encode.upload", ts + 4, 3)]
    return events


def read(events):
    return harness.reader("metrics", "bsgs.diag_hit_share")(tracing.from_events(events, 1e-6))


@pytest.mark.parametrize("jobs, hits, encodes, share", [(1, 9, 0, 100.0), (2, 9, 0, 100.0), (1, 0, 9, 0.0),
                                                        (2, 3, 1, 75.0), (1, 1, 3, 25.0)])
def test_share_of_diagonals_the_plan_held(jobs, hits, encodes, share):
    assert read(_trace(jobs, hits, encodes)) == pytest.approx(share)


def test_no_bsgs_reads_none():
    assert read(_trace(1, 0, 0)[:2]) is None  # the window and its job alone
    # encodes and hits outside any BSGS span (a bias, a constant) give no reading either
    events = [_x("window", 0, 1000), _x("job", 0, 1000), _x("fhe.encode", 10, 5), _x("fhe.bsgs.diag_hit", 20, 1)]
    assert read(events) is None


def test_only_what_lies_inside_an_outermost_bsgs_in_the_window_counts():
    events = _trace(1, 2, 2)
    events.append(_x("fhe.encode", 31, 2))  # nested in the encode at 30: counted once
    events.append(_x("fhe.bsgs", 100, 50))  # nested in the job's BSGS span: not a second span
    events += [_x("fhe.encode", 950, 5), _x("fhe.bsgs.diag_hit", 960, 1)]  # inside the job, after its BSGS
    events += [_x("fhe.bsgs", 1200, 100), _x("fhe.bsgs.diag_hit", 1210, 1)]  # after the window
    assert read(events) == pytest.approx(50.0)
