"""``bsgs.mac_share`` on small hand-written traces: the share of the window's
outermost ``fhe.bsgs`` spans that hold an ``fhe.bsgs.mac`` span."""

import pytest

from fhebench import harness, tracing


def _x(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "args": {}}


def _trace(jobs, matvecs, with_mac):
    """A window of ``jobs`` jobs 1,000 us apart, each with ``matvecs`` ``fhe.bsgs``
    spans 100 us apart, the first ``with_mac`` of them holding an ``fhe.bsgs.mac``
    (after a ``fhe.bsgs.diag_hit``, as the program opens them)."""
    events = [_x("window", 0, 1000 * jobs)]
    for j in range(jobs):
        t0 = 1000 * j
        events.append(_x("job", t0, 1000))
        for m in range(matvecs):
            ts = t0 + 10 + 100 * m
            events += [_x("fhe.bsgs", ts, 80), _x("fhe.keyswitch", ts + 5, 20), _x("fhe.bsgs.diag_hit", ts + 30, 1)]
            if m < with_mac:
                events.append(_x("fhe.bsgs.mac", ts + 32, 10))
    return events


def read(events):
    return harness.reader("metrics", "bsgs.mac_share")(tracing.from_events(events, 1e-6))


@pytest.mark.parametrize("jobs, matvecs, with_mac, share", [(1, 3, 3, 100.0), (2, 8, 8, 100.0), (1, 4, 2, 50.0),
                                                            (2, 2, 1, 50.0), (1, 4, 1, 25.0)])
def test_share_of_matvecs_with_one_mac(jobs, matvecs, with_mac, share):
    assert read(_trace(jobs, matvecs, with_mac)) == pytest.approx(share)


def test_no_bsgs_reads_none():
    assert read(_trace(1, 0, 0)) is None  # the window and its job alone
    # a MAC span outside any BSGS span gives no reading either
    assert read([_x("window", 0, 1000), _x("job", 0, 1000), _x("fhe.bsgs.mac", 20, 5)]) is None


def test_a_program_without_the_span_reads_none():
    """Matvecs whose products run one launch each open no ``fhe.bsgs.mac``:
    nothing to read, not 0."""
    assert read(_trace(2, 3, 0)) is None


def test_only_outermost_bsgs_spans_in_the_window_count():
    events = _trace(1, 2, 1)
    events.append(_x("fhe.bsgs", 12, 40))  # nested in the first matvec's span: not a matvec of its own
    events.append(_x("fhe.bsgs.mac", 13, 2))  # nested MAC: the first matvec holds one either way
    events += [_x("fhe.bsgs", 1200, 80), _x("fhe.bsgs.mac", 1210, 10)]  # after the window
    assert read(events) == pytest.approx(50.0)
