"""A traced window, read from ``torch.profiler``'s Chrome trace.

The harness wraps its own calls into the context in spans (``record_function``),
which the trace carries as ``user_annotation`` events on the host's timeline: a
``window`` span around the traced jobs, a ``job`` span around each, and one
span around each call (``upload``, ``conv``, ``dense.1``, ``eval_mod``, ...).  The
device's work is the ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events.  Times
are the trace's microseconds; every reader of ``fhebench/metrics`` takes a
``Trace`` and returns one number or None.
"""

from __future__ import annotations

import dataclasses
import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OUTER_SPANS = ("window", "job")


@dataclasses.dataclass
class Trace:
    kernels: list  # (ts, dur, name, stream)
    copies: list  # (ts, dur, name, bytes)
    memsets: list  # (ts, dur)
    spans: list  # (ts, dur, name)
    window: tuple  # (start, end)
    jobs: int
    least_s_per_job: float
    peak_bytes: int | None = None

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6


def from_events(events: list, least_s_per_job: float, peak_bytes: int | None = None) -> Trace:
    kernels, copies, memsets, spans = [], [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0.0))
        args = e.get("args", {})
        if cat == "kernel":
            kernels.append((ts, dur, e["name"], args.get("stream")))
        elif cat == "gpu_memcpy":
            copies.append((ts, dur, e["name"], float(args.get("bytes", 0))))
        elif cat == "gpu_memset":
            memsets.append((ts, dur))
        elif cat == "user_annotation":
            spans.append((ts, dur, e["name"]))
    windows = [s for s in spans if s[2] == "window"]
    if len(windows) != 1:
        raise ValueError(f"a traced run holds one 'window' span, found {len(windows)}")
    w0, wd, _ = windows[0]
    window = (w0, w0 + wd)
    jobs = sum(1 for s in spans if s[2] == "job" and w0 <= s[0] <= window[1])
    return Trace(kernels, copies, memsets, spans, window, jobs, least_s_per_job, peak_bytes)


def load(path, least_s_per_job: float, peak_bytes: int | None = None) -> Trace:
    with open(path) as f:
        return from_events(json.load(f)["traceEvents"], least_s_per_job, peak_bytes)


def clipped(intervals, window) -> list:
    """(start, end) pairs cut to the window, empty ones dropped."""
    out = []
    for ts, dur in intervals:
        a, b = max(ts, window[0]), min(ts + dur, window[1])
        if b > a:
            out.append((a, b))
    return out


def merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def union_us(intervals) -> float:
    return sum(b - a for a, b in merged(intervals))


def kernel_intervals(t: Trace) -> list:
    return clipped([(k[0], k[1]) for k in t.kernels], t.window)


def busy_intervals(t: Trace) -> list:
    device = [(k[0], k[1]) for k in t.kernels] + [(c[0], c[1]) for c in t.copies] + list(t.memsets)
    return merged(clipped(device, t.window))


def busy_s(t: Trace) -> float:
    return union_us(busy_intervals(t)) * 1e-6


def idle_gaps(t: Trace) -> list:
    """(start, length) of every stretch of the window with nothing on the device."""
    gaps, cur = [], t.window[0]
    for a, b in busy_intervals(t):
        if a > cur:
            gaps.append((cur, a - cur))
        cur = max(cur, b)
    if t.window[1] > cur:
        gaps.append((cur, t.window[1] - cur))
    return gaps


def span_at(t: Trace, ts: float) -> str:
    """The innermost harness span open at ``ts`` below window and job, or "between calls"."""
    best = None
    for s0, d, name in t.spans:
        if name not in OUTER_SPANS and s0 <= ts < s0 + d and (best is None or d < best[0]):
            best = (d, name)
    return best[1] if best else "between calls"


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace, template or argument list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()


def breakdown(t: Trace, top: int = 10) -> dict:
    """The device operations of the window that took most time, by name, and the
    window's idle time by the harness span open when each gap began, in seconds."""
    ops: dict[str, float] = {}
    inside = lambda ts: t.window[0] <= ts < t.window[1]
    for ts, dur, name, _ in t.kernels:
        if inside(ts):
            ops[short_name(name)] = ops.get(short_name(name), 0.0) + dur * 1e-6
    for ts, dur, name, _ in t.copies:
        if inside(ts):
            ops[name] = ops.get(name, 0.0) + dur * 1e-6
    idle: dict[str, float] = {}
    for start, length in idle_gaps(t):
        label = span_at(t, start)
        idle[label] = idle.get(label, 0.0) + length * 1e-6
    rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
