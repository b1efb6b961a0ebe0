"""Discrete-event simulation kernel: event heap, clock, run loop.

Deliberately tiny and generic — the serving policies (``repro_torch.serve.policy``)
are the only intended client, but nothing here knows about FHE.  Events are
plain callbacks ordered by (time, insertion sequence); the sequence number
makes simultaneous events deterministic (submission order) and breaks heap
ties without comparing payloads.  Cancellation is lazy: a cancelled event
stays in the heap and is skipped when popped — O(1) cancel, which preemption
uses to revoke a suspended job's completion event.  The loop compacts the heap
once cancelled entries outnumber live ones — checked on BOTH insertion and
cancellation, so a mass-cancellation burst with no follow-up inserts (admission
shedding revoking thousands of queued deadline events at once) still compacts
immediately.  Long fleet runs (many engines sharing one loop, each preemption
leaving a dead completion event) therefore stay O(live events) in memory: the
heap never holds more cancelled entries than live ones outside the compaction
call itself, and each compaction's O(heap) cost is amortised over the ≥ heap/2
cancellations that triggered it.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Callable


class Event:
    """One scheduled callback.  ``cancel()`` revokes it in O(1)."""

    __slots__ = ("time", "seq", "fn", "cancelled", "_loop")

    def __init__(self, time: float, seq: int, fn: Callable[[], None], loop: "EventLoop | None" = None):
        self.time = time
        self.seq = seq
        self.fn = fn
        self.cancelled = False
        self._loop = loop

    def cancel(self) -> None:
        if not self.cancelled:
            self.cancelled = True
            if self._loop is not None:
                self._loop._note_cancel()

    def __lt__(self, other: "Event") -> bool:  # heap ordering
        return (self.time, self.seq) < (other.time, other.seq)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "cancelled" if self.cancelled else "pending"
        return f"Event(t={self.time:.1f}, seq={self.seq}, {state})"


class EventLoop:
    """Monotonic clock + binary-heap run loop.

    The clock unit is *cycles* throughout the serving subsystem (converted to
    seconds only at the metrics layer, via the chip frequency).
    """

    def __init__(self, start: float = 0.0, tracer=None):
        self.now = float(start)
        self._heap: list[Event] = []
        self._seq = itertools.count()
        self._n_cancelled = 0
        self.processed = 0
        # observability seam: a ``repro_torch.obs.Tracer`` bound here timestamps
        # every event it records off THIS clock — the loop is the single
        # source of simulated time, which is what makes traces deterministic
        if tracer is not None and tracer:
            tracer.bind_clock(lambda: self.now)

    def __len__(self) -> int:
        return len(self._heap) - self._n_cancelled

    def call_at(self, time: float, fn: Callable[[], None]) -> Event:
        if time < self.now:
            raise ValueError(f"cannot schedule into the past: {time} < now={self.now}")
        self._maybe_compact()
        ev = Event(float(time), next(self._seq), fn, loop=self)
        heapq.heappush(self._heap, ev)
        return ev

    def _note_cancel(self) -> None:
        """Bookkeeping hook ``Event.cancel`` calls; compacts when dead entries
        outnumber live ones so pure cancellation bursts cannot bloat the heap."""
        self._n_cancelled += 1
        self._maybe_compact()

    def _maybe_compact(self) -> None:
        if self._n_cancelled > 32 and 2 * self._n_cancelled > len(self._heap):
            self._compact()

    def _compact(self) -> None:
        """Drop cancelled entries and re-heapify (amortised by the cancel count)."""
        self._heap = [e for e in self._heap if not e.cancelled]
        heapq.heapify(self._heap)
        self._n_cancelled = 0

    def call_after(self, delay: float, fn: Callable[[], None]) -> Event:
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        return self.call_at(self.now + delay, fn)

    def peek_time(self) -> float | None:
        """Time of the next pending event, or None when drained."""
        while self._heap and self._heap[0].cancelled:
            heapq.heappop(self._heap)
            self._n_cancelled -= 1
        return self._heap[0].time if self._heap else None

    def step(self) -> bool:
        """Dispatch the next pending event; False when the heap is drained."""
        while self._heap:
            ev = heapq.heappop(self._heap)
            if ev.cancelled:
                self._n_cancelled -= 1
                continue
            assert ev.time >= self.now, "event heap violated monotonic time"
            self.now = ev.time
            self.processed += 1
            ev.fn()
            return True
        return False

    def run(self, until: float | None = None, max_events: int | None = None) -> float:
        """Run to quiescence (or a time/event horizon); returns the final clock.

        ``until`` stops *before* dispatching any event strictly later than the
        horizon (the clock advances to the horizon).  ``max_events`` is a
        safety valve for open-loop sources that never drain.
        """
        dispatched = 0
        while True:
            if max_events is not None and dispatched >= max_events:
                return self.now
            t = self.peek_time()
            if t is None:
                return self.now
            if until is not None and t > until:
                self.now = max(self.now, until)
                return self.now
            self.step()
            dispatched += 1
