"""Deterministic span/event tracer for simulator and serving timelines.

This is the simulated-time seam.  Real time inside the port (the host's work
beside the card's, on ``torch.profiler``'s clock) is ``repro_torch.obs.spans``.

``Tracer`` records a flat list of Chrome ``trace_event``-shaped dicts (see
``repro_torch.obs.export`` for the file format and the pid/tid conventions) with
three hard rules that make traces *reproducible artifacts* rather than
profiler noise:

* **Sim-clock timestamps only.**  Every timestamp comes from the bound clock
  (the serving ``EventLoop``'s cycle counter), an explicit ``ts=`` argument,
  or a dispatch index — never from wall-clock time.  Two runs with the same
  seed therefore export byte-identical traces, and a trace diff is a
  behaviour diff.
* **Zero overhead when disabled.**  ``Tracer(enabled=False)`` (and the
  ``tracer=None`` default at every seam) records nothing: seams guard with
  ``if tracer:`` — ``__bool__`` returns ``enabled`` — so the disabled path
  is one attribute test and no allocation.  The no-op/unchanged-bench
  properties are pinned by ``tests/test_obs.py``.
* **No ambient identity.**  Track ids are interned per (pid, label) in
  registration order and span/async ids are explicit caller-provided keys
  (job ids), so nothing depends on ``id()``, hashing order, or interpreter
  state.

Event vocabulary (one method per Chrome phase the exporter understands):

  ``complete``      — a closed interval (phase "X"): run segments,
                      per-instruction unit occupancy
  ``begin``/``end`` — open/close a nested interval on a track (phases
                      "B"/"E"): chip downtime windows
  ``instant``       — a point event (phase "i"): sheds, faults, gang
                      barriers, retries
  ``counter``       — a sampled value (phase "C"): backlog, dispatch totals
  ``async_begin`` / ``async_instant`` / ``async_end`` — a logical operation
                      spanning tracks (phases "b"/"n"/"e", keyed by
                      ``(cat, id)``): job lifecycles with their
                      QUEUED→RUNNING→…→terminal state transitions
  ``span``          — context-manager sugar over ``begin``/``end``

Domain helpers (``job_begin``/``job_state``/``job_end``) wrap the async
trio with ``cat="job"`` so the serving seams stay one-liners.
"""

from __future__ import annotations

import contextlib
from typing import Callable

__all__ = ["Tracer"]


class Tracer:
    """Deterministic event recorder; export via ``repro_torch.obs.export``."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.events: list[dict] = []
        self._clock: Callable[[], float] | None = None
        self.process_names: dict[int, str] = {}
        # (pid, label) -> tid, interned in registration order per pid
        self._tracks: dict[tuple[int, str], int] = {}
        self._next_tid: dict[int, int] = {}
        self.n_dispatches = 0  # dispatch-index clock for kernel-launch events

    def __bool__(self) -> bool:
        return self.enabled

    # -- clock / topology ----------------------------------------------------

    def bind_clock(self, clock: Callable[[], float]) -> None:
        """Set the default timestamp source (e.g. ``lambda: loop.now``)."""
        self._clock = clock

    def now(self) -> float:
        return float(self._clock()) if self._clock is not None else 0.0

    def _ts(self, ts: float | None) -> float:
        return float(ts) if ts is not None else self.now()

    def name_process(self, pid: int, name: str) -> None:
        if self.enabled:
            self.process_names[pid] = name

    def new_process(self, name: str) -> int:
        """Allocate a fresh pid (one past the highest seen) and name it.
        Per-call timelines — e.g. each ``simulate_stream`` invocation — get
        their own process so their ts=0-based events never violate another
        track's monotonicity.  Deterministic: depends only on registration
        order, like ``track``."""
        if not self.enabled:
            return 0
        used = set(self.process_names) | {p for p, _ in self._tracks}
        pid = max(used, default=-1) + 1
        self.name_process(pid, name)
        return pid

    def track(self, pid: int, label: str) -> int:
        """Intern a (pid, label) thread track; stable tid per registration
        order.  Pre-register tracks in a fixed order (the cluster router does)
        when a human-friendly fixed layout matters."""
        key = (pid, label)
        tid = self._tracks.get(key)
        if tid is None:
            tid = self._next_tid.get(pid, 0)
            self._next_tid[pid] = tid + 1
            self._tracks[key] = tid
        return tid

    @property
    def thread_names(self) -> dict[tuple[int, int], str]:
        return {(pid, tid): label for (pid, label), tid in self._tracks.items()}

    # -- core event emitters -------------------------------------------------

    def complete(self, name: str, start: float, end: float, pid: int = 0,
                 tid: int = 0, **args) -> None:
        """Closed interval [start, end) on a track (phase "X")."""
        if self.enabled:
            self.events.append({"ph": "X", "name": name, "ts": float(start),
                                "dur": float(end) - float(start),
                                "pid": pid, "tid": tid, "args": args})

    def begin(self, name: str, ts: float | None = None, pid: int = 0,
              tid: int = 0, **args) -> None:
        if self.enabled:
            self.events.append({"ph": "B", "name": name, "ts": self._ts(ts),
                                "pid": pid, "tid": tid, "args": args})

    def end(self, name: str, ts: float | None = None, pid: int = 0,
            tid: int = 0) -> None:
        if self.enabled:
            self.events.append({"ph": "E", "name": name, "ts": self._ts(ts),
                                "pid": pid, "tid": tid})

    def instant(self, name: str, ts: float | None = None, pid: int = 0,
                tid: int = 0, **args) -> None:
        if self.enabled:
            self.events.append({"ph": "i", "name": name, "ts": self._ts(ts),
                                "pid": pid, "tid": tid, "s": "t", "args": args})

    def counter(self, name: str, values: dict, ts: float | None = None,
                pid: int = 0) -> None:
        """Sampled counter series (phase "C"); ``values`` maps series→number."""
        if self.enabled:
            self.events.append({"ph": "C", "name": name, "ts": self._ts(ts),
                                "pid": pid, "tid": 0,
                                "args": {k: float(v) for k, v in values.items()}})

    def async_begin(self, name: str, aid, cat: str = "async",
                    ts: float | None = None, pid: int = 0, tid: int = 0,
                    **args) -> None:
        if self.enabled:
            self.events.append({"ph": "b", "name": name, "cat": cat,
                                "id": aid, "ts": self._ts(ts),
                                "pid": pid, "tid": tid, "args": args})

    def async_instant(self, name: str, aid, cat: str = "async",
                      ts: float | None = None, pid: int = 0, tid: int = 0,
                      **args) -> None:
        if self.enabled:
            self.events.append({"ph": "n", "name": name, "cat": cat,
                                "id": aid, "ts": self._ts(ts),
                                "pid": pid, "tid": tid, "args": args})

    def async_end(self, name: str, aid, cat: str = "async",
                  ts: float | None = None, pid: int = 0, tid: int = 0,
                  **args) -> None:
        if self.enabled:
            self.events.append({"ph": "e", "name": name, "cat": cat,
                                "id": aid, "ts": self._ts(ts),
                                "pid": pid, "tid": tid, "args": args})

    @contextlib.contextmanager
    def span(self, name: str, pid: int = 0, tid: int = 0, **args):
        """Lexical span on a track: ``with tracer.span("route"): ...``."""
        if not self.enabled:
            yield self
            return
        self.begin(name, pid=pid, tid=tid, **args)
        try:
            yield self
        finally:
            self.end(name, pid=pid, tid=tid)

    # -- job-lifecycle helpers (async span keyed by job id, cat="job") -------

    def job_begin(self, job_id: int, name: str, ts: float | None = None,
                  pid: int = 0, **args) -> None:
        self.async_begin(name, job_id, cat="job", ts=ts, pid=pid, **args)

    def job_state(self, job_id: int, name: str, state: str,
                  ts: float | None = None, pid: int = 0, **args) -> None:
        self.async_instant(name, job_id, cat="job", ts=ts, pid=pid,
                           state=state, **args)

    def job_end(self, job_id: int, name: str, state: str,
                ts: float | None = None, pid: int = 0, **args) -> None:
        self.async_end(name, job_id, cat="job", ts=ts, pid=pid,
                       state=state, **args)

    # -- kernel-dispatch seam -------------------------------------------------

    def dispatch_hook(self, pid: int = 0, label: str = "kernel-dispatch"):
        """A hook for ``kernels.dispatch.hook_dispatches`` (or
        ``ExecPolicy(dispatch_hook=...)``, via ``ExecPolicy.traced``): each
        kernel launch becomes a unit-width "X" slice at its *dispatch index*
        — kernels carry no sim-time of their own, so the index is the
        deterministic clock for this track."""
        tid = self.track(pid, label)

        def hook(op: str) -> None:
            if self.enabled:
                i = self.n_dispatches
                self.n_dispatches = i + 1
                self.events.append({"ph": "X", "name": op, "ts": float(i),
                                    "dur": 1.0, "pid": pid, "tid": tid,
                                    "args": {}})
        return hook
