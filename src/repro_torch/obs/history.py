"""Perf-history tracker: append bench rows, detect regressions vs the past.

``BENCH_HISTORY.json`` is a flat JSON list of rows, one per (bench, scenario,
metric) measurement::

    {"bench": "cluster", "scenario": "shallow.flash.jsq.chips4.gang1",
     "metric": "latency_p99_cycles", "value": 123456.0,
     "commit": "a7c8264", "date": "2026-08-09"}

Rows are appended by ``benchmarks/run.py --smoke`` (every gated bench row)
and by ``tools/obs_smoke.py`` (the traced-fleet scenario); the file is the
repo's perf trajectory — cycle-level metrics are deterministic functions of
the code, so any drift between appends is a code-behaviour change.

``check_regression`` compares the NEWEST row of each (bench, scenario,
metric) group against the trailing median of up to ``window`` prior rows
with a symmetric relative tolerance band.  Wall-clock metrics (name
containing any of ``SKIP_SUBSTRINGS``) are skipped — host timing noise is
not a regression.  Single-row groups pass vacuously (a new metric has no
history to regress against).

Bench-row names like ``cluster.shallow.flash.jsq.chips4.gang1.latency_p99``
split as bench = first dot-segment, metric = last, scenario = the middle.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess

__all__ = ["append_rows", "check_regression", "load_history", "parse_row_name",
           "SKIP_SUBSTRINGS"]

# host-timing metrics: noisy across machines, never regression-gated
SKIP_SUBSTRINGS = ("wall_ms", "seconds", "wall_speedup")


def parse_row_name(name: str) -> tuple[str, str, str]:
    """Split a ``bench.scenario...metric`` row name into its three parts."""
    parts = name.split(".")
    if len(parts) == 1:
        return parts[0], "", parts[0]
    if len(parts) == 2:
        return parts[0], "", parts[1]
    return parts[0], ".".join(parts[1:-1]), parts[-1]


def current_commit(repo_dir: str | None = None) -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=repo_dir, capture_output=True, text=True, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except OSError:
        pass
    return "unknown"


def load_history(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        data = json.load(fh)
    if not isinstance(data, list):
        raise ValueError(f"{path}: expected a JSON list of rows")
    return data


def append_rows(path: str, rows, commit: str | None = None,
                date: str | None = None) -> int:
    """Append ``rows`` — ``(name, value)`` pairs or ready-made row dicts —
    stamping commit/date; returns the number appended.  Non-numeric values
    are skipped (history tracks numbers only)."""
    commit = commit if commit is not None else current_commit(os.path.dirname(path) or ".")
    date = date if date is not None else datetime.date.today().isoformat()
    history = load_history(path)
    n = 0
    for row in rows:
        if isinstance(row, dict):
            rec = dict(row)
        else:
            name, value = row
            bench, scenario, metric = parse_row_name(name)
            rec = {"bench": bench, "scenario": scenario, "metric": metric,
                   "value": value}
        try:
            rec["value"] = float(rec["value"])
        except (TypeError, ValueError):
            continue
        rec.setdefault("commit", commit)
        rec.setdefault("date", date)
        history.append(rec)
        n += 1
    with open(path, "w") as fh:
        json.dump(history, fh, indent=1)
        fh.write("\n")
    return n


def _median(xs: list[float]) -> float:
    s = sorted(xs)
    m = len(s) // 2
    return s[m] if len(s) % 2 else 0.5 * (s[m - 1] + s[m])


def check_regression(history: list[dict], window: int = 8,
                     tolerance: float = 0.15,
                     skip_substrings: tuple[str, ...] = SKIP_SUBSTRINGS) -> list[str]:
    """Regression messages (empty = clean): per (bench, scenario, metric)
    group in append order, the newest value must sit within ``tolerance``
    (relative, symmetric — an improvement outside the band is ALSO flagged,
    because for a deterministic simulator it means behaviour changed) of the
    median of up to ``window`` immediately-prior rows."""
    groups: dict[tuple[str, str, str], list[float]] = {}
    for row in history:
        key = (str(row.get("bench", "")), str(row.get("scenario", "")),
               str(row.get("metric", "")))
        try:
            groups.setdefault(key, []).append(float(row["value"]))
        except (KeyError, TypeError, ValueError):
            continue
    problems: list[str] = []
    for (bench, scenario, metric), values in sorted(groups.items()):
        if len(values) < 2:
            continue
        if any(s in metric for s in skip_substrings):
            continue
        newest = values[-1]
        baseline = _median(values[-1 - window:-1])
        scale = max(abs(baseline), 1e-12)
        dev = abs(newest - baseline) / scale
        if dev > tolerance:
            label = ".".join(p for p in (bench, scenario, metric) if p)
            problems.append(
                f"{label}: newest {newest:g} deviates {dev:.1%} from trailing "
                f"median {baseline:g} (tolerance {tolerance:.0%}, "
                f"n={len(values) - 1} prior)")
    return problems
