"""Chrome/Perfetto ``trace_event`` JSON exporter + structural validator.

``to_chrome_trace`` turns a ``Tracer`` into the JSON-object form of the
Trace Event Format (a dict with a ``traceEvents`` list), which both
``chrome://tracing`` and https://ui.perfetto.dev open directly.  The mapping
convention across this repo:

  * **process (pid)** — one per chip (pid = chip index + 1), plus pid 0 for
    the fleet router (sheds, admission, retries, backlog counters).
  * **thread (tid)**  — one per resource lane inside a chip: the chip-level
    health track, one track per cluster affiliation, the ``deep`` gang
    track (FLASH-FHE chips) or the single ``whole-chip`` track (sequential
    baselines).  Simulator/dispatch traces intern tracks per functional
    unit the same way.
  * **ts/dur**        — simulated *cycles*, not microseconds.  Perfetto
    renders them as µs; read "1 µs" as "1 cycle".  Timestamps are sim-clock
    or dispatch-index values, so same-seed runs export byte-identical files.

Serialisation is canonical — events stably sorted by (ts, emission order)
with metadata first, ``json.dumps(sort_keys=True, separators=(",", ":"))``
— so byte equality is the determinism test (``tests/test_obs.py``).

``validate_chrome_trace`` is the structural checker shared by the tests and
the obs-smoke CI job: required keys per phase, non-negative monotone
timestamps per track, balanced B/E nesting per (pid, tid), balanced b/e
async spans per (cat, id) with no negative depth, and JSON-serialisability.
It returns a list of human-readable problems (empty = valid) so callers
choose between asserting and reporting.
"""

from __future__ import annotations

import json

from .trace import Tracer

__all__ = ["to_chrome_trace", "dumps_chrome_trace", "write_chrome_trace",
           "validate_chrome_trace"]

_REQUIRED = ("ph", "ts", "pid", "tid")


def to_chrome_trace(tracer: Tracer) -> dict:
    """Trace Event Format (JSON-object form) for one recorded run."""
    events: list[dict] = []
    for pid, name in sorted(tracer.process_names.items()):
        events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                       "ts": 0.0, "args": {"name": name}})
        events.append({"ph": "M", "name": "process_sort_index", "pid": pid,
                       "tid": 0, "ts": 0.0, "args": {"sort_index": pid}})
    for (pid, tid), label in sorted(tracer.thread_names.items()):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "ts": 0.0, "args": {"name": label}})
        events.append({"ph": "M", "name": "thread_sort_index", "pid": pid,
                       "tid": tid, "ts": 0.0, "args": {"sort_index": tid}})
    # stable sort: ties keep emission order, so B-before-E and b-before-e
    # relationships at one instant survive (and the output is deterministic)
    events.extend(sorted(tracer.events, key=lambda e: e["ts"]))
    return {"traceEvents": events, "displayTimeUnit": "ns",
            "metadata": {"clock": "sim-cycles"}}


def dumps_chrome_trace(tracer: Tracer) -> str:
    """Canonical byte form — the unit of the byte-determinism guarantee."""
    return json.dumps(to_chrome_trace(tracer), sort_keys=True,
                      separators=(",", ":"))


def write_chrome_trace(tracer: Tracer, path: str) -> str:
    with open(path, "w") as fh:
        fh.write(dumps_chrome_trace(tracer))
    return path


def validate_chrome_trace(obj: dict) -> list[str]:
    """Structural problems in a trace dict (empty list = valid)."""
    problems: list[str] = []
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    try:
        json.dumps(obj)
    except (TypeError, ValueError) as e:  # non-serialisable payload
        problems.append(f"not JSON-serialisable: {e}")
    last_ts: dict[tuple, float] = {}
    open_spans: dict[tuple, list[str]] = {}
    async_depth: dict[tuple, int] = {}
    async_counts: dict[tuple, list[int]] = {}
    for k, ev in enumerate(events):
        missing = [key for key in _REQUIRED if key not in ev]
        if missing:
            problems.append(f"event {k}: missing keys {missing}")
            continue
        ph, ts = ev["ph"], ev["ts"]
        if ph == "M":
            continue
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {k}: bad ts {ts!r}")
            continue
        track = (ev["pid"], ev["tid"])
        if ph in ("X", "B", "E", "i", "C"):
            if ts < last_ts.get(track, 0.0):
                problems.append(
                    f"event {k}: ts {ts} not monotone on track {track}")
            last_ts[track] = ts
        if ph == "X":
            if ev.get("dur", -1.0) < 0:
                problems.append(f"event {k}: X without non-negative dur")
        elif ph == "B":
            open_spans.setdefault(track, []).append(ev.get("name", ""))
        elif ph == "E":
            stack = open_spans.get(track)
            if not stack:
                problems.append(f"event {k}: E with no open B on track {track}")
            else:
                opened = stack.pop()
                name = ev.get("name")
                if name is not None and name != opened:
                    problems.append(
                        f"event {k}: E({name}) closes B({opened}) on {track}")
        elif ph in ("b", "n", "e"):
            if "id" not in ev or "cat" not in ev:
                problems.append(f"event {k}: async {ph} without id/cat")
                continue
            key = (ev["cat"], ev["id"])
            counts = async_counts.setdefault(key, [0, 0])
            if ph == "b":
                async_depth[key] = async_depth.get(key, 0) + 1
                counts[0] += 1
            elif ph == "e":
                async_depth[key] = async_depth.get(key, 0) - 1
                counts[1] += 1
                if async_depth[key] < 0:
                    problems.append(f"event {k}: async e before b for {key}")
        elif ph not in ("i", "C"):
            problems.append(f"event {k}: unknown phase {ph!r}")
    for track, stack in open_spans.items():
        if stack:
            problems.append(f"unclosed B spans on track {track}: {stack}")
    for key, (nb, ne) in async_counts.items():
        if nb != ne:
            problems.append(f"async span {key}: {nb} begins vs {ne} ends")
    return problems
