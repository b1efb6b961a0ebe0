"""The program's own spans in a traced window: ``repro_torch.obs.span`` names each
stretch of host work inside the port ``fhe.*`` (``fhe.encode``, ``fhe.keyswitch``,
...), on the profiler's clock like the harness's spans and the device's events.

A span of a set counts when it starts inside the window and lies inside no other
span of the same set, so an encode nested in an encode is counted once.  Times
are the trace's microseconds.
"""

from __future__ import annotations

from fhebench import tracing

ENCODES = ("fhe.encode", "fhe.encode_const")
KEYSWITCH = ("fhe.keyswitch",)


def outermost(t: tracing.Trace, names) -> list:
    """(start, end) of every span named in ``names`` that starts in the window
    and lies inside no other such span, in order of start."""
    found = sorted(((ts, ts + dur) for ts, dur, name in t.spans
                    if name in names and t.window[0] <= ts < t.window[1]), key=lambda s: (s[0], -s[1]))
    out, reach = [], float("-inf")
    for a, b in found:
        if b > reach:
            out.append((a, b))
            reach = b
    return out


def ms_per_job(t: tracing.Trace, names):
    """The union of the outermost spans of ``names`` within the window, in ms a job."""
    spans = outermost(t, names)
    if not spans or not t.jobs:
        return None
    return tracing.union_us(tracing.clipped(((a, b - a) for a, b in spans), t.window)) * 1e-3 / t.jobs


def overlap_us(xs, ys) -> float:
    """The length both unions of (start, end) intervals cover."""
    xs, ys = tracing.merged(xs), tracing.merged(ys)
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        total += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total
