"""Seeded fault injection + retry policy for fleet serving.

The fault model covers the three failure classes a real accelerator fleet
sees (the SoK on FHE accelerators assumes datacenter deployment; EFFACT's
full-stack platform targets the same):

* **chip crash / recover** — a die goes dark: every job resident on it (and
  every gang it participates in) fails transiently, its backlog estimator is
  zeroed, and the router stops placing work on it until the matching
  ``recover`` event.  Recovered chips rejoin with a *cold* warm-set.
* **transient job failure** — a single running job dies (ECC fault, kernel
  abort) without taking the chip down.
* **slowdown (straggler) windows** — a chip runs at ``factor``× its nominal
  service time between ``slow_start``/``slow_end`` (thermal throttling, a
  noisy neighbour on the HBM bus).  Wall-clock excess is charged to
  ``wasted_cycles`` so work-conservation invariants stay checkable.

``FaultConfig`` draws a ``FaultPlan`` (a sorted list of ``FaultEvent``)
deterministically from a seed via per-chip spawned ``SeedSequence`` streams —
same seed, same plan, same ``ClusterResult``.  Scripted plans for benches
come from the classmethod helpers (``FaultPlan.single_crash`` etc.).

``RetryPolicy`` owns the recovery knobs: max attempts, capped exponential
backoff (in cycles), and whether deep jobs may resume from their last
SRAM→HBM spill (checkpoint) instead of restarting from zero.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "FaultEvent",
    "FaultPlan",
    "FaultConfig",
    "RetryPolicy",
    "FAULT_KINDS",
]

FAULT_KINDS = ("crash", "recover", "transient", "slow_start", "slow_end")


@dataclasses.dataclass(frozen=True, order=True)
class FaultEvent:
    """One injected fault, ordered by time for deterministic replay."""

    at: float  # cycle at which the fault fires
    chip: int  # victim chip index
    kind: str  # one of FAULT_KINDS
    factor: float = 1.0  # slowdown factor (slow_start only; > 1 means slower)

    def __post_init__(self):
        assert self.kind in FAULT_KINDS, f"unknown fault kind {self.kind!r}"
        assert self.at >= 0.0
        assert self.chip >= 0
        if self.kind == "slow_start":
            assert self.factor > 1.0, "slowdown factor must exceed 1.0"


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, time-sorted schedule of fault events.

    Build one from ``FaultConfig.draw()`` (seeded random plan) or from the
    scripted classmethods below (bench scenarios want exact timings).
    """

    events: tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(sorted(self.events)))

    def __len__(self) -> int:
        return len(self.events)

    def for_chip(self, chip: int) -> tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.chip == chip)

    # -- scripted scenario helpers -----------------------------------------

    @classmethod
    def single_crash(cls, chip: int, at: float, down: float) -> FaultPlan:
        """One chip dies at ``at`` and recovers ``down`` cycles later."""
        return cls(events=(
            FaultEvent(at=at, chip=chip, kind="crash"),
            FaultEvent(at=at + down, chip=chip, kind="recover"),
        ))

    @classmethod
    def straggler(cls, chip: int, at: float, span: float,
                  factor: float = 2.0) -> FaultPlan:
        """One chip runs ``factor``× slower for ``span`` cycles."""
        return cls(events=(
            FaultEvent(at=at, chip=chip, kind="slow_start", factor=factor),
            FaultEvent(at=at + span, chip=chip, kind="slow_end"),
        ))

    @classmethod
    def flaky(cls, chip: int, times) -> FaultPlan:
        """Transient single-job failures on ``chip`` at each time in ``times``."""
        return cls(events=tuple(
            FaultEvent(at=float(t), chip=chip, kind="transient") for t in times
        ))

    def merged(self, other: FaultPlan) -> FaultPlan:
        return FaultPlan(events=self.events + other.events)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Recovery knobs for transiently-failed jobs.

    ``max_attempts`` counts *retries* after the first attempt; 0 disables
    recovery entirely (the bench's no-recovery baseline).  Backoff for retry
    k (1-based) is ``min(backoff_cap, backoff_base * backoff_factor**(k-1))``
    cycles of re-queue delay.  ``checkpoint`` lets deep jobs resume from
    their last SRAM→HBM spill instead of restarting from zero.
    """

    max_attempts: int = 3
    backoff_base: float = 1000.0
    backoff_factor: float = 2.0
    backoff_cap: float = 64_000.0
    checkpoint: bool = True

    def __post_init__(self):
        assert self.max_attempts >= 0
        assert self.backoff_base >= 0.0
        assert self.backoff_factor >= 1.0
        assert self.backoff_cap >= self.backoff_base

    def backoff_cycles(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (1-based count of prior failures)."""
        assert attempt >= 1
        return float(min(self.backoff_cap,
                         self.backoff_base * self.backoff_factor ** (attempt - 1)))


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Seeded random fault-plan generator.

    Per chip, crash arrivals follow a Poisson process with mean inter-crash
    gap ``mtbf_cycles`` and exponential downtime with mean ``mttr_cycles``
    (next crash is drawn after the recovery, so windows never overlap on one
    chip).  Independent streams draw transient job failures
    (``transient_rate`` per Mcycle) and slowdown windows
    (``slow_rate`` per Mcycle, span ``slow_span_cycles``, factor
    ``slow_factor``).  All randomness descends from ``seed`` via spawned
    ``SeedSequence`` streams, one per (chip, fault-class), so plans are
    reproducible and chips are independent.
    """

    seed: int = 0
    horizon_cycles: float = 1e6
    mtbf_cycles: float | None = None  # mean cycles between crashes; None = no crashes
    mttr_cycles: float = 50_000.0  # mean downtime per crash
    transient_rate: float = 0.0  # transient job failures per Mcycle per chip
    slow_rate: float = 0.0  # slowdown windows per Mcycle per chip
    slow_span_cycles: float = 50_000.0
    slow_factor: float = 2.0

    def __post_init__(self):
        assert self.horizon_cycles > 0.0
        assert self.mtbf_cycles is None or self.mtbf_cycles > 0.0
        assert self.mttr_cycles > 0.0
        assert self.transient_rate >= 0.0
        assert self.slow_rate >= 0.0
        assert self.slow_span_cycles > 0.0
        assert self.slow_factor > 1.0

    def draw(self, n_chips: int) -> FaultPlan:
        """Materialise a deterministic plan over ``n_chips`` chips."""
        root = np.random.SeedSequence(self.seed)
        streams = root.spawn(3 * n_chips)
        events: list[FaultEvent] = []
        for chip in range(n_chips):
            crash_rng = np.random.default_rng(streams[3 * chip + 0])
            trans_rng = np.random.default_rng(streams[3 * chip + 1])
            slow_rng = np.random.default_rng(streams[3 * chip + 2])
            if self.mtbf_cycles is not None:
                t = float(crash_rng.exponential(self.mtbf_cycles))
                while t < self.horizon_cycles:
                    down = float(crash_rng.exponential(self.mttr_cycles))
                    events.append(FaultEvent(at=t, chip=chip, kind="crash"))
                    up = t + down
                    if up < self.horizon_cycles:
                        events.append(FaultEvent(at=up, chip=chip, kind="recover"))
                    t = up + float(crash_rng.exponential(self.mtbf_cycles))
            if self.transient_rate > 0.0:
                gap = 1e6 / self.transient_rate
                t = float(trans_rng.exponential(gap))
                while t < self.horizon_cycles:
                    events.append(FaultEvent(at=t, chip=chip, kind="transient"))
                    t += float(trans_rng.exponential(gap))
            if self.slow_rate > 0.0:
                gap = 1e6 / self.slow_rate
                t = float(slow_rng.exponential(gap))
                while t < self.horizon_cycles:
                    span = self.slow_span_cycles
                    events.append(FaultEvent(
                        at=t, chip=chip, kind="slow_start", factor=self.slow_factor))
                    end = t + span
                    if end < self.horizon_cycles:
                        events.append(FaultEvent(at=end, chip=chip, kind="slow_end"))
                    t = end + float(slow_rng.exponential(gap))
        return FaultPlan(events=tuple(events))
