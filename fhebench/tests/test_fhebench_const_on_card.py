"""``ops.const_on_card_share`` on small hand-written traces: the share of the
window's outermost ``fhe.encode_const`` spans that hold an
``fhe.encode.const_column`` span."""

import pytest

from fhebench import harness, tracing


def _x(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "args": {}}


def _trace(consts, on_card):
    """A window of one job holding ``consts`` constant encodes 10 us apart, the
    first ``on_card`` of them built as a column, the others on the host."""
    events = [_x("window", 0, 1000), _x("job", 0, 1000)]
    for i in range(consts):
        ts = 10 + 10 * i
        events.append(_x("fhe.encode_const", ts, 8))
        parts = ("fhe.encode.const_column",) if i < on_card else ("fhe.encode.coeffs", "fhe.encode.upload")
        events += [_x(name, ts + 1 + 3 * k, 2) for k, name in enumerate(parts)]
    return events


def read(events):
    return harness.reader("metrics", "ops.const_on_card_share")(tracing.from_events(events, 1e-6))


@pytest.mark.parametrize("consts, on_card, share", [(4, 4, 100.0), (4, 2, 50.0), (3, 0, 0.0), (1, 1, 100.0)])
def test_share_of_constants_built_on_the_card(consts, on_card, share):
    assert read(_trace(consts, on_card)) == pytest.approx(share)


def test_no_constant_reads_none():
    assert read(_trace(0, 0)) is None
    assert read(_trace(0, 0) + [_x("fhe.encode", 10, 5), _x("fhe.encode.coeffs", 11, 2)]) is None


def test_outermost_spans_in_the_window_only():
    events = _trace(2, 1)
    events.append(_x("fhe.encode_const", 11, 2))  # nested in the first: counted once
    events += [_x("fhe.encode_const", 1200, 8), _x("fhe.encode.const_column", 1201, 2)]  # after the window
    assert read(events) == pytest.approx(50.0)
    # a column outside every constant's span counts for none
    assert read(_trace(2, 0) + [_x("fhe.encode.const_column", 500, 2)]) == pytest.approx(0.0)
