"""Online multi-tenant scheduling policies over the discrete-event engine.

Implements the paper's §4.2 policy as a *reactive* scheduler driven by
arrival/completion events (replacing the old one-pass offline heuristic in
``repro_torch.core.scheduler``):

  * shallow job → exactly ONE cluster affiliation, with the affiliation's
    bootstrappable circuit decomposed into two extra swift pipelines
    (multi-exit — the lane math lives in ``core.simulator.lanes_shallow``);
  * deep job → gang-scheduled across ALL bootstrappable clusters
    (exclusive: every affiliation is occupied while a deep job runs);
  * priority preemption: a running deep job is suspended when a
    strictly-higher-priority shallow job arrives.  Suspension runs a proper
    state machine (QUEUED → RUNNING → SUSPENDED → RUNNING → DONE) and charges
    the SRAM→HBM working-set spill plus the later restore to the *deep* job's
    remaining work — the DMA overlaps the incoming shallow job's ramp-up, so
    affiliations free immediately (matching the paper's "avoid the convoy
    effect" argument).  A preemption at zero progress spills nothing.

  Deep jobs otherwise yield to shallow traffic (the paper schedules one
  shallow job per affiliation to maximise throughput); a *waiting* deep job
  with strictly higher priority than a queued shallow job drains the chip
  instead of letting that shallow job jump ahead, so priorities mean the same
  thing in both directions.

Two extensions beyond the single-chip policy live here too:

  * ``FlashPolicy(deep_coop=True)`` grants deep jobs the swift clusters as
    well (``core.simulator.lanes_deep_coop``): large-point NTTs decompose
    across boot+swift pipelines with every (i)NTT routed through the L3
    transpose module — deep service time drops, bounded by the transpose
    bandwidth (the paper's §7 future-work direction).
  * ``GangReservation`` is the cross-chip deep-gang barrier used by
    ``repro_torch.serve.cluster``: one deep job splits across M identical chips'
    bootstrappable clusters, with serialized inter-chip link exchanges
    (``gang_service_cycles``) charged into every fragment's service demand so
    per-chip work conservation still validates.  Fragments start, suspend
    (a preemption on ANY member suspends the whole gang), resume, and finish
    in lockstep.

``SequentialPolicy`` is the CraterLake / F1+ baseline: whole chip per job,
non-preemptive, highest-priority-then-arrival at each dispatch point.

Per-job service times come from the cycle-level simulator
(``core.simulator.simulate_stream``) over planner instruction streams, so the
fused-key-switch accounting composes directly.  Identical
(chip, workload, kind, ``ExecPolicy.policy_key()``) jobs share one memoised
``SimResult`` — the policy key is the canonical identity of the execution
mode (scheme, kernel pipeline, hoisting, numerics); each job's policy is
re-tagged with its scheme (CKKS vs BGV) before keying, so mixed-scheme
streams never alias cached service times.
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
from typing import Callable

from repro_torch.core.cache import MB
from repro_torch.core.hardware import ChipConfig
from repro_torch.core.jobs import FheJob
from repro_torch.core.planner import plan_fused, workload_stream
from repro_torch.core.simulator import (
    SimResult,
    lanes_deep,
    lanes_deep_coop,
    lanes_shallow,
    lanes_whole_chip,
    simulate_stream,
)
from repro_torch.fhe.context import ExecPolicy

from .events import Event, EventLoop

_TOL = 1e-6  # cycle-arithmetic tolerance used by the consistency checks


class JobState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    SUSPENDED = "suspended"
    DONE = "done"
    # terminal rejection: admission control (router) or queue-timeout (engine)
    # dropped the job before it ever ran — no segments, no completion, and the
    # work-conservation invariants exclude it
    SHED = "shed"
    # fault injection (repro_torch.serve.faults): the attempt died under it — chip
    # crash, gang abort, or a transient job fault.  The record freezes (each
    # retry is a FRESH JobExec) with ``failed_cycle`` set and the running
    # invariant busy + remaining == service + spill + wasted still holding
    FAILED_TRANSIENT = "failed_transient"
    # terminal: retries exhausted (or recovery disabled) — the fleet gave up
    FAILED = "failed"


@dataclasses.dataclass(frozen=True)
class Segment:
    """One contiguous occupancy interval on a resource.

    ``resource`` is ``affiliation-<i>`` for shallow placements and ``deep``
    for gang placements (which occupy *every* affiliation).  ``chip`` is the
    fleet chip index the interval ran on — retried jobs can hold segments on
    several chips, so overlap checks must group by (chip, resource).
    """

    start: float
    end: float
    resource: str
    chip: int = 0

    @property
    def cycles(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class JobExec:
    """Execution record + suspend/resume state machine for one job."""

    job: FheJob
    service_cycles: float
    sim: SimResult | None  # None only for admission-shed jobs (never priced)
    lanes: str  # final placement label (affiliation-i / deep / whole-chip)
    state: JobState = JobState.QUEUED
    remaining: float = 0.0  # cycles left, incl. unpaid spill/restore overhead
    segments: list[Segment] = dataclasses.field(default_factory=list)
    first_start: float | None = None
    completion: float | None = None
    spill_restore_cycles: float = 0.0
    n_preemptions: int = 0
    chip_index: int = 0  # which fleet chip served the job (0 when single-chip)
    cold_start_cycles: float = 0.0  # router-charged warm-set miss, part of service_cycles
    # cross-chip gang fields: a ganged deep job has one JobExec *fragment* per
    # member chip, all pointing at the same reservation and moving in lockstep
    gang: "GangReservation | None" = dataclasses.field(default=None, repr=False)
    gang_rank: int = 0  # this fragment's position in the gang (0 = primary)
    gang_size: int = 1  # chips in the gang (1 = not ganged)
    link_cycles: float = 0.0  # per-chip inter-chip exchange stalls, inside service_cycles
    link_bytes: float = 0.0  # gang-total link traffic, recorded on the rank-0 fragment
    shed_cycle: float | None = None  # instant the job was dropped (SHED only)
    # fault/retry accounting (repro_torch.serve.faults): each retry is a FRESH record
    attempts: int = 1  # 1-based attempt number this record represents
    wasted_cycles: float = 0.0  # THIS attempt's lost work: failed runs + straggler excess
    prior_wasted_cycles: float = 0.0  # waste carried from earlier failed attempts
    checkpoint_cycles: float = 0.0  # work a checkpoint resume skipped (vs full restart)
    full_service_cycles: float = 0.0  # un-checkpointed demand, for the turnaround identity
    failed_cycle: float | None = None  # instant the attempt died (FAILED* only)
    _has_checkpoint: bool = False  # a SRAM→HBM spill exists to resume from
    _run_factor: float = 1.0  # straggler slowdown of the current run segment
    _run_start: float | None = None
    _suspended_at: float | None = None  # last preemption time (aging reference)
    _complete_ev: Event | None = None
    _deadline_ev: Event | None = None  # queue-timeout shed deadline, if armed

    def __post_init__(self):
        self.remaining = self.service_cycles
        if self.full_service_cycles == 0.0:
            self.full_service_cycles = self.service_cycles

    @property
    def kind(self) -> str:
        return self.job.kind

    @property
    def time_to_shed(self) -> float:
        """Arrival → shed decision (0.0 = rejected at admission)."""
        assert self.shed_cycle is not None, "job was not shed"
        return self.shed_cycle - self.job.arrival_cycle

    @property
    def turnaround(self) -> float:
        assert self.completion is not None, "job not finished"
        return self.completion - self.job.arrival_cycle

    @property
    def queueing_delay(self) -> float:
        assert self.first_start is not None, "job never started"
        return self.first_start - self.job.arrival_cycle

    @property
    def wasted_total(self) -> float:
        """All fault-lost work across attempts: failed runs, straggler excess,
        and abandoned spill payments — everything busy that was not progress."""
        return self.prior_wasted_cycles + self.wasted_cycles

    @property
    def preempted_cycles(self) -> float:
        """Extra cycles vs an uninterrupted run: suspension gaps, spill/restore,
        retry backoff and re-queue gaps — everything between first start and
        completion that is neither service demand nor fault-wasted work.
        Crash-requeue spill goes to ``wasted_cycles``, never double-counted
        here: turnaround = queueing_delay + full_service + preempted + wasted.
        """
        if self.completion is None or self.first_start is None:
            return 0.0
        return ((self.completion - self.first_start)
                - self.full_service_cycles - self.wasted_total)

    @property
    def busy_cycles(self) -> float:
        return sum(s.cycles for s in self.segments)


def working_set_bytes(job: FheJob) -> float:
    """SRAM-resident state a preempted deep job must spill: two ciphertext
    polynomials over the extended basis plus key-switch accumulators."""
    p = job.params
    return 6.0 * (p.L + 1 + p.alpha) * p.n * 4.0


# ---------------------------------------------------------------------------
# admission control (overload protection)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Overload-protection policy: which jobs get dropped (``JobState.SHED``)
    instead of growing the backlog without bound.

    Three independent mechanisms, each off (``None``) by default:

      * ``max_wait_cycles`` — *utilization reserve* at the cluster router: a
        job is shed on arrival when the best estimated wait across the fleet
        (``ClusterRouter._wait``, the same drain-width/serial estimator the
        ``hetero`` router uses) already exceeds this bound.  This is what
        keeps queues bounded under sustained overload: once the fleet's
        backlog covers ``max_wait_cycles`` of work, further arrivals shed at
        the door rather than queueing behind it.
      * ``tenant_rate_per_mcycle`` (+ ``tenant_burst``) — a classic *token
        bucket per tenant* at the router: each tenant's bucket refills at the
        rate (jobs per Mcycle of simulated time) up to the burst capacity and
        each admitted job takes one token; an empty bucket sheds.  Isolates
        an abusive tenant: a flood drains only its own bucket, so a
        well-behaved tenant's admissions are untouched.
      * ``shed_after_cycles`` — an *engine-level queue timeout*: a job still
        QUEUED (never started) this many cycles after arrival is shed where
        it waits.  This is the SLO backstop for jobs the router admitted into
        a queue that subsequently congested (e.g. behind a deep gang); its
        ``time_to_shed`` is exactly this bound, where router sheds are 0.

    Shed jobs are terminal: no segments, no completion, queued events
    cancelled, never counted into warm-sets, and their admission never
    touched (router path) or is echoed back out of (engine path) the backlog
    estimators.
    """

    max_wait_cycles: float | None = None
    tenant_rate_per_mcycle: float | None = None
    tenant_burst: float = 8.0
    shed_after_cycles: float | None = None

    def __post_init__(self):
        if self.max_wait_cycles is not None and self.max_wait_cycles < 0:
            raise ValueError(f"max_wait_cycles must be >= 0, got {self.max_wait_cycles}")
        if self.tenant_rate_per_mcycle is not None and self.tenant_rate_per_mcycle <= 0:
            raise ValueError(
                f"tenant_rate_per_mcycle must be positive, got {self.tenant_rate_per_mcycle}")
        if self.tenant_burst < 1:
            raise ValueError(f"tenant_burst must be >= 1, got {self.tenant_burst}")
        if self.shed_after_cycles is not None and self.shed_after_cycles <= 0:
            raise ValueError(
                f"shed_after_cycles must be positive, got {self.shed_after_cycles}")


class TokenBucket:
    """Continuous-refill token bucket (rate in tokens per Mcycle).

    Starts full.  ``try_take`` refills by elapsed simulated time, then either
    spends one token (admit) or reports empty (shed).  Fractional tokens
    accumulate, so a rate of 0.5/Mcycle admits one job every 2 Mcycles in
    steady state.
    """

    __slots__ = ("rate_per_cycle", "burst", "tokens", "_t")

    def __init__(self, rate_per_mcycle: float, burst: float):
        assert rate_per_mcycle > 0 and burst >= 1
        self.rate_per_cycle = rate_per_mcycle / 1e6
        self.burst = float(burst)
        self.tokens = float(burst)
        self._t = 0.0

    def try_take(self, now: float) -> bool:
        self.tokens = min(self.burst, self.tokens + (now - self._t) * self.rate_per_cycle)
        self._t = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


# ---------------------------------------------------------------------------
# service-time model (memoised cycle simulation)
# ---------------------------------------------------------------------------

_SERVICE_MEMO: dict[tuple, SimResult] = {}


def exec_policy_from_hoist(hoist: bool) -> ExecPolicy:
    """The ExecPolicy equivalent of the legacy ``hoist=`` bool: the fused
    accelerator pipeline, with hoisted vs per-rotation key-switching."""
    return ExecPolicy(backend="fused", hoisting="always" if hoist else "never")


def job_service_sim(job: FheJob, chip: ChipConfig, hoist: bool = False,
                    policy: ExecPolicy | None = None,
                    deep_coop: bool = False, device="cuda") -> SimResult:
    """Cycle-accurate service time for one job under its granted lanes.

    Identical (chip, workload, kind, policy_key, coop) tuples share one
    SimResult — the planner stream and lane grant are functions of those
    alone, so the simulation is too.  ``ExecPolicy.policy_key()`` is the
    single source of truth for the execution-mode part of the key: it covers
    the kernel pipeline, the hoisting mode, and the numerics mode, and
    distinct policies never alias — a memo keyed only on (chip, workload,
    kind) would silently hand post-hoisting callers the pre-hoisting cycle
    counts.  ``deep_coop`` grants a deep job the swift clusters too
    (``lanes_deep_coop``; ignored for shallow jobs and whole-chip baselines).
    The legacy ``hoist=`` bool maps through ``exec_policy_from_hoist`` when
    no policy is given.  ``device`` resolves a ``backend="auto"`` policy's
    key-switch pipeline (``planner.plan_fused``: fused on "cuda", staged on
    "cpu"); the resolved pipeline is part of the memo key, so one "auto"
    policy's two prices never alias.  Callers must treat the result as
    read-only.
    """
    policy = policy if policy is not None else exec_policy_from_hoist(hoist)
    # re-tag the execution policy with the job's scheme (CKKS vs BGV): a mixed
    # stream prices BGV jobs off their own planner expansions, and the
    # scheme-leading policy_key keeps the memo entries from aliasing
    policy = policy.for_scheme(job.scheme)
    coop = bool(deep_coop) and job.kind == "deep" and chip.multi_job
    fused = plan_fused(policy, device)
    key = (chip, job.workload, job.kind, policy.policy_key(), fused, coop)
    hit = _SERVICE_MEMO.get(key)
    if hit is not None:
        return hit
    if not chip.multi_job:
        lanes, cache_mb = lanes_whole_chip(chip), chip.total_cache_mb
    elif job.kind == "shallow":
        # L2 is shared: a shallow job sees its L1 plus a 1/n_aff share of L2
        lanes = lanes_shallow(chip)
        cache_mb = chip.l1_mb_per_aff + chip.l2_mb / chip.n_affiliations
    else:
        lanes = lanes_deep_coop(chip) if coop else lanes_deep(chip)
        cache_mb = chip.total_cache_mb
    stream = workload_stream(job.workload, job.params, mode="hw", policy=policy,
                             device=device)
    sim = simulate_stream(stream, chip, lanes, cache_bytes=cache_mb * MB)
    _SERVICE_MEMO[key] = sim
    return sim


# ---------------------------------------------------------------------------
# cross-chip deep gangs (service model + lockstep barrier)
# ---------------------------------------------------------------------------

GANG_SYNCS = 8  # global barriers per ganged deep job (bootstrap stage boundaries)


def gang_link_bytes(job: FheJob, n_chips: int, syncs: int = GANG_SYNCS) -> float:
    """Total inter-chip link traffic for one ``n_chips``-wide deep gang.

    The gang shards a deep job's independent baby-step/batch work across M
    chips' bootstrappable clusters and synchronises at ``syncs`` global
    barriers (the bootstrapping stage boundaries: CtS radix stages, EvalMod,
    StC).  Each barrier all-gathers the sharded ciphertext working set — of
    which a ``(M-1)/M`` fraction is remote to any member — in both
    directions (scatter updated shards, gather the merged state), hence the
    factor 2.  Monotone in M: wider gangs exchange strictly more bytes.
    """
    if n_chips <= 1:
        return 0.0
    return 2.0 * syncs * working_set_bytes(job) * (n_chips - 1) / n_chips


def gang_service_cycles(single_chip_cycles: float, job: FheJob, n_chips: int,
                        link_bytes_per_cycle: float,
                        syncs: int = GANG_SYNCS) -> tuple[float, float]:
    """Per-chip busy time ``(cycles, link_cycles)`` of an M-chip deep gang.

    Compute shards M ways; every member then stalls through the serialized
    link exchanges (the link is the bottleneck during a barrier, so its cost
    is charged into each fragment's service demand — work conservation stays
    penalty-inclusive, exactly like the router's cold-start charge).  The
    link is priced ≫ the on-chip L3 transpose: at the default 256 B/cycle it
    moves bytes 32× slower than the 2048-port transpose module and 4× slower
    than one chip's HBM.
    """
    if n_chips <= 1:
        return float(single_chip_cycles), 0.0
    link = gang_link_bytes(job, n_chips, syncs) / float(link_bytes_per_cycle)
    return float(single_chip_cycles) / n_chips + link, link


class GangReservation:
    """Lockstep barrier for ONE deep job split across M chips.

    The cluster router creates one reservation per multi-chip deep placement
    and submits a fragment ``JobExec`` to each member engine; every fragment
    carries the full per-chip gang demand (``gang_service_cycles``).  The
    fragments move through the state machine in lockstep:

      * start / resume — each member signals ``member_ready`` once its chip
        has drained; its ``FlashPolicy`` then *holds* the chip idle
        (``_gang_hold``, no shallow admission) so the reservation cannot be
        stolen.  When the LAST member arrives the barrier fires a zero-delay
        launch event and every fragment enters RUNNING at the same instant —
        holding is the visible queueing price of aligning M chips.
      * preempt — a strictly-higher-priority shallow arrival on ANY member
        chip suspends EVERY fragment at that instant (each spills its 1/M
        shard of the working set), after which members independently drain
        and re-enter the barrier.

    Members must be identical (chip, exec-policy) pairs so fragments price
    and progress identically — the router's gang planner groups chips by
    exactly that key.
    """

    def __init__(self, job: FheJob, loop: EventLoop):
        self.job = job
        self.loop = loop
        self.members: list[tuple["FlashPolicy", JobExec]] = []
        self._ready: set[int] = set()
        self._launch_pending = False
        self.running = False
        self.aborted = False  # fault abort: the gang is dead, fragments frozen

    @property
    def size(self) -> int:
        return len(self.members)

    def attach(self, policy: "FlashPolicy", je: JobExec) -> None:
        assert isinstance(policy, FlashPolicy), (
            "gang fragments need a FlashPolicy chip (multi_job=True)"
        )
        self.members.append((policy, je))

    def member_ready(self, policy: "FlashPolicy") -> None:
        """Barrier arrival (idempotent); launches once every member holds."""
        if self.aborted:
            return
        if policy.tracer and id(policy) not in self._ready:
            je = next(j for p, j in self.members if p is policy)
            policy.tracer.instant(
                "gang_ready", pid=je.chip_index + 1,
                tid=policy.tracer.track(je.chip_index + 1, "deep"),
                job=self.job.job_id, rank=je.gang_rank, size=self.size)
        self._ready.add(id(policy))
        if len(self._ready) == self.size and not self._launch_pending:
            self._launch_pending = True
            self.loop.call_after(0.0, self._launch)

    def _launch(self) -> None:
        self._launch_pending = False
        if self.aborted:
            return  # a member chip died between barrier entry and launch
        self._ready.clear()
        self.running = True
        # lockstep pacing: every fragment runs at the SLOWEST member's factor,
        # so a straggler chip drags the whole gang (the real failure mode wide
        # gangs have) and fragments still finish at the same instant
        factor = max(p.slow_factor for p, _ in self.members)
        for policy, je in self.members:
            if policy.tracer:
                policy.tracer.instant(
                    "gang_launch", pid=je.chip_index + 1,
                    tid=policy.tracer.track(je.chip_index + 1, "deep"),
                    job=self.job.job_id, rank=je.gang_rank, factor=factor)
            policy._gang_launch(je, factor)

    def suspend(self) -> None:
        """Gang-wide preemption: suspend every fragment at this instant."""
        if not self.running:
            return
        self.running = False
        for policy, je in self.members:
            policy._gang_suspend(je)

    def abort(self, now: float) -> list[JobExec]:
        """Fault-driven lockstep abort: a member chip died (or a fragment hit
        a transient fault), so EVERY fragment fails at this instant — per-chip
        shard checkpoints are useless once gang membership changes, so the job
        re-plans from scratch on the healthy sub-fleet.  Idempotent; returns
        the newly-failed fragment records (all sharing one ``failed_cycle``).
        """
        if self.aborted:
            return []
        self.aborted = True
        self.running = False
        self._ready.clear()
        victims: list[JobExec] = []
        for policy, je in self.members:
            if je.state in (JobState.QUEUED, JobState.RUNNING, JobState.SUSPENDED):
                policy._gang_member_fail(je, now)
                victims.append(je)
        return victims


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------


# states that mark a queue entry dead-in-place (lazily purged, never dispatched)
_DEAD_STATES = (JobState.SHED, JobState.FAILED_TRANSIENT, JobState.FAILED)


class _PriorityQueue:
    """Max-priority, then FIFO-by-arrival, then submission order.

    Shed/failed entries are dropped lazily: a queue-timeout shed (or a fault)
    marks the job terminal in place (O(1)) and the entry is discarded whenever
    it surfaces at the top — the same trick the event heap uses for
    cancellations."""

    def __init__(self):
        self._heap: list[tuple[float, float, int, JobExec]] = []
        self._seq = itertools.count()

    def _purge(self) -> None:
        while self._heap and self._heap[0][-1].state in _DEAD_STATES:
            heapq.heappop(self._heap)

    def __len__(self) -> int:
        # after the purge a non-zero length guarantees a live (non-shed) head,
        # which is all the dispatch loops rely on; shed entries buried deeper
        # may still be counted until they surface
        self._purge()
        return len(self._heap)

    def push(self, je: JobExec) -> None:
        heapq.heappush(self._heap, (-je.job.priority, je.job.arrival_cycle, next(self._seq), je))

    def pop(self) -> JobExec:
        self._purge()
        return heapq.heappop(self._heap)[-1]

    def peek(self) -> JobExec | None:
        self._purge()
        return self._heap[0][-1] if self._heap else None


def _cancel_deadline(je: JobExec) -> None:
    """Revoke a job's queue-timeout shed deadline (it is starting to run)."""
    if je._deadline_ev is not None:
        je._deadline_ev.cancel()
        je._deadline_ev = None


# -- tracing helpers (repro_torch.obs seam) ----------------------------------------
# Every emission is guarded by ``if tracer:`` — ``tracer`` is None (or a
# disabled Tracer, which is falsy) on every default path, so the serving hot
# loops pay one attribute test.  Conventions (see docs/observability.md):
# pid = chip_index + 1 (pid 0 is the fleet router), tid = the resource track
# (affiliation-i / deep / whole-chip / chip), job lifecycles are async spans
# keyed by job_id with state-transition instants.  Gang fragments share one
# job id, so only the rank-0 fragment speaks for the job's async span; every
# fragment still records its own run segments on its own chip's tracks.

# turnaround histogram buckets (cycles): decade-ish ladder covering shallow
# sub-ms jobs through deep bootstrapped pipelines at 1 GHz-scale clocks
TURNAROUND_BUCKETS = (1e4, 3e4, 1e5, 3e5, 1e6, 3e6, 1e7, 3e7, 1e8, 3e8, 1e9)


def _trace_segment(tracer, je: JobExec, start: float, end: float,
                   resource: str) -> None:
    """One closed run interval — emitted exactly where ``segments.append`` is."""
    if tracer:
        pid = je.chip_index + 1
        tracer.complete(je.job.workload, start, end, pid=pid,
                        tid=tracer.track(pid, resource),
                        job=je.job.job_id, kind=je.kind, attempt=je.attempts)


def _primary(je: JobExec) -> bool:
    return je.gang is None or je.gang_rank == 0


def _trace_state(tracer, je: JobExec, state: str, **args) -> None:
    if tracer and _primary(je):
        tracer.job_state(je.job.job_id, je.job.workload, state,
                         pid=je.chip_index + 1, attempt=je.attempts, **args)


def _trace_job_end(tracer, je: JobExec, state: str) -> None:
    if tracer and _primary(je):
        tracer.job_end(je.job.job_id, je.job.workload, state,
                       pid=max(je.chip_index, -1) + 1)


def _fail_record(je: JobExec, now: float, resource: str, chip: ChipConfig,
                 tracer=None) -> None:
    """Freeze one attempt record as FAILED_TRANSIENT with consistent books.

    Closes any open run segment (that wall time is lost → ``wasted_cycles``).
    A deep job holding a SRAM→HBM spill checkpoint keeps its ``remaining``
    (the retry resumes from the last suspension point, paying one fresh HBM
    restore); everything else restarts from zero — its entire busy history
    becomes waste and abandoned spill payments are re-classified as waste too,
    so the frozen record satisfies busy + remaining == service + spill +
    wasted and fleet-wide work conservation stays checkable.
    """
    _cancel_deadline(je)
    if je._complete_ev is not None:
        je._complete_ev.cancel()
        je._complete_ev = None
    if je.state is JobState.RUNNING and je._run_start is not None:
        w = now - je._run_start
        if w > 0:
            je.segments.append(Segment(je._run_start, now, resource, chip=je.chip_index))
            _trace_segment(tracer, je, je._run_start, now, resource)
        je.wasted_cycles += w
        je._run_start = None
        if je._has_checkpoint:
            # the checkpoint survives in HBM; the retry pays one restore
            pay = working_set_bytes(je.job) / je.gang_size / chip.hbm_bytes_per_cycle
            je.remaining += pay
            je.spill_restore_cycles += pay
    if not je._has_checkpoint:
        je.wasted_cycles = je.busy_cycles
        je.spill_restore_cycles = 0.0
        je.remaining = je.service_cycles
    je.state = JobState.FAILED_TRANSIENT
    je.failed_cycle = now
    _trace_state(tracer, je, "FAILED_TRANSIENT", resource=resource)


class _DeferredDispatchMixin:
    """Coalesce dispatch: arrivals/completions enqueue state changes, and the
    actual placement decision runs in a zero-delay follow-up event.  This makes
    simultaneous arrivals commute — all jobs landing at cycle *t* are queued
    before any of them is placed, so priority order (not event insertion
    order) decides, matching the old offline sort semantics."""

    loop: EventLoop | None
    _dispatch_pending: bool

    def _schedule_dispatch(self) -> None:
        if not self._dispatch_pending:
            self._dispatch_pending = True
            self.loop.call_after(0.0, self._run_dispatch)

    def _run_dispatch(self) -> None:
        self._dispatch_pending = False
        self.dispatch()


class FlashPolicy(_DeferredDispatchMixin):
    """The paper's §4.2 heterogeneous multi-job policy (online form).

    ``aging_quanta`` is the deep-job aging / utilization-reserve knob
    (ROADMAP): a saturating same-priority shallow stream would otherwise
    starve a deep job indefinitely, because the gang launch needs every
    affiliation free at once.  Once the oldest waiting (or suspended) deep
    job has queued longer than ``aging_quanta`` × the observed mean shallow
    service time, the policy stops admitting shallow jobs at or below the
    deep job's priority — the chip drains within one shallow quantum and the
    gang launches.  ``None`` (the default) disables aging: the knob trades
    shallow tail latency for a deep-job starvation bound, so operators opt
    in per deployment (``tests/test_serving.py`` pins both behaviours).
    Strictly-higher-priority shallow traffic still overtakes an aged deep
    job, so priorities keep their meaning.

    ``deep_coop`` grants deep jobs the swift clusters too
    (``lanes_deep_coop``): the serving engine prices deep services with the
    boot+swift lane grant, trading L3-transpose traffic for lane width —
    shallow services are untouched.  Off by default because it is a
    beyond-paper mode (§7 future work); ``tests/test_serving.py`` pins that
    it strictly reduces deep p99 on a deep-only stream.
    """

    def __init__(self, chip: ChipConfig, aging_quanta: float | None = None,
                 deep_coop: bool = False):
        assert chip.multi_job, f"{chip.name} cannot co-schedule jobs (multi_job=False)"
        assert aging_quanta is None or aging_quanta > 0
        self.chip = chip
        self.aging_quanta = aging_quanta
        self.deep_coop = bool(deep_coop)
        self.loop: EventLoop | None = None
        self.on_complete: Callable[[JobExec], None] = lambda je: None
        self._dispatch_pending = False
        self.tracer = None  # repro_torch.obs seam; the owning ServingEngine sets it
        # fault state (repro_torch.serve.faults): a dead chip accepts no work; a
        # straggler window stretches every NEW run segment by slow_factor
        self.alive = True
        self.slow_factor = 1.0
        self.aff_running: list[JobExec | None] = [None] * chip.n_affiliations
        self.shallow_q = _PriorityQueue()
        self.deep_q = _PriorityQueue()
        self.deep_active: JobExec | None = None
        # holding for a cross-chip gang barrier: the chip stays drained (no
        # shallow admission) until every member chip is ready
        self._gang_hold = False
        self._deep_label = (lanes_deep_coop(chip) if self.deep_coop
                            else lanes_deep(chip)).label
        self._shallow_svc_sum = 0.0
        self._shallow_svc_n = 0

    def bind(self, loop: EventLoop, on_complete: Callable[[JobExec], None]) -> None:
        self.loop = loop
        self.on_complete = on_complete

    def submit(self, je: JobExec) -> None:
        # a FAILED_TRANSIENT entry can legitimately arrive here (its arrival
        # event raced a crash at the same instant); the queue purges it lazily.
        # A live QUEUED submission to a dead chip is a router bug.
        assert self.alive or je.state is not JobState.QUEUED, (
            f"job {je.job.job_id} routed to dead chip {je.chip_index}"
        )
        (self.shallow_q if je.kind == "shallow" else self.deep_q).push(je)
        self._schedule_dispatch()

    def _aged(self, je: JobExec, now: float) -> bool:
        """Has this deep job *waited* past the aging threshold?

        Waiting is measured from arrival for a never-started job and from the
        last suspension for a preempted one — time spent RUNNING must not
        count, or a long-running deep job would be "aged" the instant it is
        preempted.  The shallow quantum is the running mean of *completed*
        shallow service times — before any shallow job completes there is
        nothing to starve behind, so aging stays off and arrival-order
        semantics are unchanged.
        """
        if self.aging_quanta is None or self._shallow_svc_n == 0:
            return False
        since = je._suspended_at if je._suspended_at is not None else je.job.arrival_cycle
        quantum = self._shallow_svc_sum / self._shallow_svc_n
        return (now - since) >= self.aging_quanta * quantum

    # -- dispatch -----------------------------------------------------------

    def dispatch(self) -> None:
        now = self.loop.now
        self._maybe_preempt(now)
        self._place_shallow(now)
        self._maybe_start_deep(now)

    def _maybe_preempt(self, now: float) -> None:
        d = self.deep_active
        top = self.shallow_q.peek()
        if d is None or d.state is not JobState.RUNNING or top is None:
            return
        if top.job.priority <= d.job.priority:
            return
        if d.gang is not None:
            d.gang.suspend()  # lockstep: every member fragment suspends now
        else:
            self._suspend_deep(d, now)

    def _suspend_deep(self, d: JobExec, now: float) -> None:
        # suspend: close the deep segment, revoke its completion, charge the
        # SRAM→HBM spill + later restore to its remaining work (a gang
        # fragment spills only its 1/M shard of the working set).  Under a
        # straggler window only worked/_run_factor of the wall time is real
        # progress; the excess is charged to wasted_cycles.  The spilled image
        # doubles as a crash checkpoint (_has_checkpoint) for retries.
        worked = now - d._run_start
        d._complete_ev.cancel()
        spill_pay = 0.0
        if worked > 0:
            progress = worked / d._run_factor
            d.segments.append(Segment(d._run_start, now, "deep", chip=d.chip_index))
            _trace_segment(self.tracer, d, d._run_start, now, "deep")
            pay = (2.0 * working_set_bytes(d.job) / d.gang_size
                   / self.chip.hbm_bytes_per_cycle)
            d.remaining = max(0.0, d.remaining - progress) + pay
            d.spill_restore_cycles += pay
            d.wasted_cycles += worked - progress
            d._has_checkpoint = True
            spill_pay = pay
        d.n_preemptions += 1
        _trace_state(self.tracer, d, "SUSPENDED", spill_cycles=spill_pay)
        d.state = JobState.SUSPENDED
        d._run_start = None
        d._suspended_at = now  # aging clock restarts: only waiting counts
        d._complete_ev = None

    # -- gang callbacks (invoked by GangReservation, possibly cross-chip) ----

    def _gang_launch(self, d: JobExec, factor: float = 1.0) -> None:
        self._gang_hold = False
        self._run_deep(d, self.loop.now, factor=factor)

    def _gang_suspend(self, d: JobExec) -> None:
        if d.state is not JobState.RUNNING:
            return
        self._suspend_deep(d, self.loop.now)
        self._schedule_dispatch()  # this chip's affiliations just freed

    def _deep_fence(self, now: float) -> tuple[float, bool] | None:
        """(priority, strict) below which shallow jobs yield to a deep job.

        ``strict`` (set by aging) also fences *equal*-priority shallow jobs —
        the starvation case the knob exists for.  A suspended deep job fences
        only once aged (it was legitimately preempted); a queued head fences
        lower priorities always, equals only when aged."""
        d = self.deep_active
        if d is not None:
            if d.state is JobState.SUSPENDED and self._aged(d, now):
                return d.job.priority, True
            return None
        head = self.deep_q.peek()
        if head is None:
            return None
        return head.job.priority, self._aged(head, now)

    def _place_shallow(self, now: float) -> None:
        if self._gang_hold:
            return  # chip is reserved for a cross-chip gang barrier
        if self.deep_active is not None and self.deep_active.state is JobState.RUNNING:
            return  # deep gang owns every affiliation
        fence = self._deep_fence(now)
        while len(self.shallow_q):
            top = self.shallow_q.peek()
            if fence is not None and (
                top.job.priority < fence[0] or (fence[1] and top.job.priority <= fence[0])
            ):
                return  # drain for the (possibly aged) deep job
            free = [i for i, r in enumerate(self.aff_running) if r is None]
            if not free:
                return
            self._start_shallow(self.shallow_q.pop(), free[0], now)

    def _start_shallow(self, je: JobExec, aff: int, now: float) -> None:
        _cancel_deadline(je)
        je.state = JobState.RUNNING
        _trace_state(self.tracer, je, "RUNNING", resource=f"affiliation-{aff}")
        je.lanes = f"affiliation-{aff}"
        if je.first_start is None:  # a retry keeps its original first start
            je.first_start = now
        je._run_start = now
        je._run_factor = self.slow_factor
        self.aff_running[aff] = je
        je._complete_ev = self.loop.call_after(
            je.remaining * je._run_factor, lambda: self._finish_shallow(je, aff))

    def _finish_shallow(self, je: JobExec, aff: int) -> None:
        now = self.loop.now
        je.segments.append(Segment(je._run_start, now, f"affiliation-{aff}",
                                   chip=je.chip_index))
        _trace_segment(self.tracer, je, je._run_start, now, f"affiliation-{aff}")
        je.wasted_cycles += (now - je._run_start) - je.remaining  # straggler excess
        je.remaining = 0.0
        je.state = JobState.DONE
        je.completion = now
        _trace_job_end(self.tracer, je, "DONE")
        self.aff_running[aff] = None
        self._shallow_svc_sum += je.service_cycles
        self._shallow_svc_n += 1
        self.on_complete(je)
        self._schedule_dispatch()

    def _maybe_start_deep(self, now: float) -> None:
        if any(r is not None for r in self.aff_running):
            return  # gang needs the whole chip
        top = self.shallow_q.peek()
        if self.deep_active is not None:
            # a suspended deep resumes once the shallow system drains — or,
            # aged, once the fence has drained the equal/lower-priority queue
            d = self.deep_active
            if d.state is JobState.SUSPENDED and (
                top is None or (self._aged(d, now) and top.job.priority <= d.job.priority)
            ):
                self._start_or_hold(d, now)
            return
        head = self.deep_q.peek()
        if head is None:
            return
        # after _place_shallow, any still-queued shallow job is fenced behind
        # this deep job's priority — the chip is drained, so the gang launches
        # (an aged deep job also overtakes equal-priority queued shallow jobs)
        if top is not None and (
            top.job.priority > head.job.priority
            or (top.job.priority == head.job.priority and not self._aged(head, now))
        ):
            return
        self.deep_active = self.deep_q.pop()
        self._start_or_hold(self.deep_active, now)

    def _start_or_hold(self, d: JobExec, now: float) -> None:
        """Run a single-chip deep job now; for a gang fragment, hold the chip
        and enter the cross-chip barrier instead (the reservation launches
        every fragment once the last member chip drains)."""
        if d.gang is not None:
            self._gang_hold = True
            d.gang.member_ready(self)
        else:
            self._run_deep(d, now)

    def _run_deep(self, d: JobExec, now: float, factor: float | None = None) -> None:
        _cancel_deadline(d)
        d.state = JobState.RUNNING
        _trace_state(self.tracer, d, "RUNNING", resource="deep")
        d.lanes = (f"{self._deep_label}+gang[{d.gang_rank}/{d.gang_size}]"
                   if d.gang is not None else self._deep_label)
        if d.first_start is None:
            d.first_start = now
        d._run_start = now
        d._run_factor = factor if factor is not None else self.slow_factor
        d._complete_ev = self.loop.call_after(
            d.remaining * d._run_factor, lambda: self._finish_deep(d))

    def _finish_deep(self, d: JobExec) -> None:
        now = self.loop.now
        d.segments.append(Segment(d._run_start, now, "deep", chip=d.chip_index))
        _trace_segment(self.tracer, d, d._run_start, now, "deep")
        d.wasted_cycles += (now - d._run_start) - d.remaining  # straggler excess
        d.remaining = 0.0
        d.state = JobState.DONE
        d.completion = now
        _trace_job_end(self.tracer, d, "DONE")
        self.deep_active = None
        if d.gang is not None:
            d.gang.running = False  # all fragments finish at this instant
        self.on_complete(d)
        self._schedule_dispatch()

    # -- fault injection (invoked by the cluster router's fault handlers) ----

    def fail_all(self, now: float) -> list[JobExec]:
        """Chip crash: every resident job fails transiently and the chip stops
        accepting work until ``revive``.  Returns every newly-failed record —
        including fragments a gang abort killed on OTHER (healthy) chips, so
        the router sees each victim exactly once."""
        self.alive = False
        victims: list[JobExec] = []
        for i, je in enumerate(self.aff_running):
            if je is not None:
                _fail_record(je, now, f"affiliation-{i}", self.chip, self.tracer)
                victims.append(je)
                self.aff_running[i] = None
        d = self.deep_active
        if d is not None:
            if d.gang is not None:
                victims.extend(d.gang.abort(now))
            else:
                _fail_record(d, now, "deep", self.chip, self.tracer)
                victims.append(d)
            self.deep_active = None
        for q in (self.shallow_q, self.deep_q):
            while len(q):
                je = q.pop()
                if je.state is not JobState.QUEUED:
                    continue  # a gang abort above already froze this fragment
                if je.gang is not None:
                    victims.extend(je.gang.abort(now))
                else:
                    _fail_record(je, now, "queued", self.chip, self.tracer)
                    victims.append(je)
        self._gang_hold = False
        return victims

    def fail_one(self, now: float) -> list[JobExec]:
        """Transient job fault: kill ONE running job (deterministically the
        active deep job, else the lowest busy affiliation) without taking the
        chip down.  A ganged victim aborts its whole gang in lockstep."""
        d = self.deep_active
        if d is not None and d.state is JobState.RUNNING:
            if d.gang is not None:
                return d.gang.abort(now)
            _fail_record(d, now, "deep", self.chip, self.tracer)
            self.deep_active = None
            self._schedule_dispatch()
            return [d]
        for i, je in enumerate(self.aff_running):
            if je is not None:
                _fail_record(je, now, f"affiliation-{i}", self.chip, self.tracer)
                self.aff_running[i] = None
                self._schedule_dispatch()
                return [je]
        return []

    def _gang_member_fail(self, d: JobExec, now: float) -> None:
        """Abort this chip's fragment of a dead gang.  Always a full restart:
        the re-planned job may land on different chips, where a per-chip shard
        checkpoint is meaningless."""
        d._has_checkpoint = False
        _fail_record(d, now, "deep", self.chip, self.tracer)
        if self.deep_active is d:
            self.deep_active = None
        self._gang_hold = False
        if self.alive:
            self._schedule_dispatch()  # the gang's claim on this chip is gone

    def revive(self) -> None:
        """Chip recovered from a crash: accept placements again.  The crash
        cleared every queue, so the chip rejoins empty (and the router rejoins
        it with a cold warm-set)."""
        self.alive = True


class SequentialPolicy(_DeferredDispatchMixin):
    """Homogeneous baseline (CraterLake / F1+): whole chip per job, priority-
    then-arrival dispatch, no preemption."""

    def __init__(self, chip: ChipConfig):
        self.chip = chip
        self.loop: EventLoop | None = None
        self.on_complete: Callable[[JobExec], None] = lambda je: None
        self._dispatch_pending = False
        self.tracer = None  # repro_torch.obs seam; the owning ServingEngine sets it
        self.queue = _PriorityQueue()
        self.running: JobExec | None = None
        self.alive = True
        self.slow_factor = 1.0

    def bind(self, loop: EventLoop, on_complete: Callable[[JobExec], None]) -> None:
        self.loop = loop
        self.on_complete = on_complete

    def submit(self, je: JobExec) -> None:
        assert self.alive or je.state is not JobState.QUEUED, (
            f"job {je.job.job_id} routed to dead chip {je.chip_index}"
        )
        self.queue.push(je)
        self._schedule_dispatch()

    def dispatch(self) -> None:
        if self.running is not None or not len(self.queue):
            return
        je = self.queue.pop()
        now = self.loop.now
        _cancel_deadline(je)
        je.state = JobState.RUNNING
        _trace_state(self.tracer, je, "RUNNING", resource="whole-chip")
        je.lanes = lanes_whole_chip(self.chip).label
        if je.first_start is None:  # a retry keeps its original first start
            je.first_start = now
        je._run_start = now
        je._run_factor = self.slow_factor
        self.running = je
        je._complete_ev = self.loop.call_after(
            je.remaining * je._run_factor, lambda: self._finish(je))

    def _finish(self, je: JobExec) -> None:
        now = self.loop.now
        je.segments.append(Segment(je._run_start, now, "whole-chip", chip=je.chip_index))
        _trace_segment(self.tracer, je, je._run_start, now, "whole-chip")
        je.wasted_cycles += (now - je._run_start) - je.remaining  # straggler excess
        je.remaining = 0.0
        je.state = JobState.DONE
        je.completion = now
        _trace_job_end(self.tracer, je, "DONE")
        self.running = None
        self.on_complete(je)
        self._schedule_dispatch()

    # -- fault injection (mirrors FlashPolicy; sequential chips never gang) --

    def fail_all(self, now: float) -> list[JobExec]:
        self.alive = False
        victims: list[JobExec] = []
        if self.running is not None:
            _fail_record(self.running, now, "whole-chip", self.chip, self.tracer)
            victims.append(self.running)
            self.running = None
        while len(self.queue):
            je = self.queue.pop()
            if je.state is JobState.QUEUED:
                _fail_record(je, now, "queued", self.chip, self.tracer)
                victims.append(je)
        return victims

    def fail_one(self, now: float) -> list[JobExec]:
        je = self.running
        if je is None or je.state is not JobState.RUNNING:
            return []
        _fail_record(je, now, "whole-chip", self.chip, self.tracer)
        self.running = None
        self._schedule_dispatch()
        return [je]

    def revive(self) -> None:
        self.alive = True


def policy_for(chip: ChipConfig):
    return FlashPolicy(chip) if chip.multi_job else SequentialPolicy(chip)


# ---------------------------------------------------------------------------
# engine + result
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServeResult:
    chip: ChipConfig
    jobs: list[JobExec]  # submission order
    makespan: float
    events_processed: int
    chip_index: int = 0  # this engine's fleet position (0 when single-chip)

    def validate(self) -> "ServeResult":
        """Timeline-consistency invariants (raises AssertionError on violation):
        every submission reached a terminal state (DONE, SHED, or frozen by a
        fault), per-affiliation intervals on THIS chip never overlap, and each
        record's run segments sum to the work it was charged (work
        conservation): a completed job ran service + spill/restore + wasted
        cycles; a fault-frozen attempt satisfies the running form busy +
        remaining == service + spill + wasted.  Shed jobs must have NO
        segments, no start, no completion, and a shed instant no earlier than
        their arrival."""
        n_aff = self.chip.n_affiliations if self.chip.multi_job else 1
        per_resource: dict[str, list[Segment]] = {}
        for je in self.jobs:
            if je.state is JobState.SHED:
                assert not je.segments, f"shed job {je.job.job_id} holds run segments"
                assert je.completion is None and je.first_start is None, (
                    f"shed job {je.job.job_id} has start/completion timestamps"
                )
                assert je.shed_cycle is not None, f"shed job {je.job.job_id} missing shed_cycle"
                assert je.shed_cycle >= je.job.arrival_cycle - _TOL, (
                    f"job {je.job.job_id} shed before it arrived"
                )
                continue
            if je.state in (JobState.FAILED_TRANSIENT, JobState.FAILED):
                assert je.failed_cycle is not None, (
                    f"failed job {je.job.job_id} missing failed_cycle"
                )
                assert je.completion is None, (
                    f"failed attempt of {je.job.job_id} holds a completion"
                )
                got = je.busy_cycles + je.remaining
                want = je.service_cycles + je.spill_restore_cycles + je.wasted_cycles
                assert abs(got - want) <= _TOL * max(1.0, want), (
                    f"failed attempt of {je.job.job_id}: busy+remaining {got} != "
                    f"service+spill+wasted {want}"
                )
            else:
                assert je.state is JobState.DONE, (
                    f"job {je.job.job_id} never completed ({je.state})"
                )
                assert je.completion is not None and je.first_start is not None
                assert je.first_start >= je.job.arrival_cycle - _TOL, (
                    f"job {je.job.job_id} started before it arrived"
                )
                got = je.busy_cycles
                want = je.service_cycles + je.spill_restore_cycles + je.wasted_cycles
                assert abs(got - want) <= _TOL * max(1.0, want), (
                    f"job {je.job.job_id} ran {got} cycles, owed {want} "
                    f"(service {je.service_cycles} + spill/restore "
                    f"{je.spill_restore_cycles} + wasted {je.wasted_cycles})"
                )
            for seg in je.segments:
                assert seg.end >= seg.start - _TOL
                if seg.chip != self.chip_index:
                    continue  # an earlier attempt's run on another fleet chip
                if seg.resource == "deep":  # a gang occupies every affiliation
                    for a in range(n_aff):
                        per_resource.setdefault(f"affiliation-{a}", []).append(seg)
                else:
                    per_resource.setdefault(seg.resource, []).append(seg)
        for resource, segs in per_resource.items():
            segs.sort(key=lambda s: (s.start, s.end))
            for prev, cur in zip(segs, segs[1:]):
                assert cur.start >= prev.end - _TOL, (
                    f"overlapping placements on {resource}: "
                    f"[{prev.start}, {prev.end}) and [{cur.start}, {cur.end})"
                )
        return self


class ServingEngine:
    """Feeds arrivals into a policy over the event loop and collects results.

    Open-loop: pass finished ``FheJob`` lists (arrival_cycle set).  Closed
    loop: pass a *source* object with ``initial_jobs()`` and
    ``on_complete(job_exec, now) -> list[FheJob]`` (see
    ``repro_torch.serve.traffic.ClosedLoopSource``).
    """

    def __init__(self, chip: ChipConfig, policy=None, loop: EventLoop | None = None,
                 hoist: bool = False, exec_policy: ExecPolicy | None = None,
                 shed_after: float | None = None, tracer=None, metrics=None,
                 device="cuda"):
        self.chip = chip
        self.policy = policy if policy is not None else policy_for(chip)
        # engine-level queue timeout (AdmissionConfig.shed_after_cycles): a job
        # still QUEUED this long after arrival is shed where it waits
        assert shed_after is None or shed_after > 0
        self.shed_after = shed_after
        # observability (repro_torch.obs): a disabled tracer normalises to None so
        # every guard below is one attribute test; the policy shares it.  The
        # optional MetricsRegistry collects completion counters/histograms
        self.tracer = tracer if tracer else None
        self.metrics = metrics
        self.policy.tracer = self.tracer
        self._fleet = False  # True under a ClusterRouter (it owns job spans)
        self._trace_registered = False
        # a caller-supplied loop lets N engines share one clock (fleet serving,
        # repro_torch.serve.cluster); by default each engine owns its own
        self.loop = loop if loop is not None else EventLoop(tracer=self.tracer)
        # execution policy for service-time estimation (kernel pipeline +
        # hoisting + numerics mode); ``hoist=`` is the legacy bool spelling.
        # Hoisted rotations amortise ModUp across BSGS baby steps, shrinking
        # deep (CtS/StC-heavy) jobs.
        self.exec_policy = (exec_policy if exec_policy is not None
                            else exec_policy_from_hoist(hoist))
        self.hoist = self.exec_policy.plan_hoist
        self.device = device  # resolves an "auto" policy's pipeline when pricing
        self.chip_index = 0  # fleet position; the cluster router assigns it
        self.jobs: list[JobExec] = []
        self._source = None
        # fleet hooks: the cluster router tracks per-chip backlog through these
        # (a queue-timeout shed must echo its admission back OUT of the backlog)
        self.on_job_complete: Callable[[JobExec], None] | None = None
        self.on_job_shed: Callable[[JobExec], None] | None = None
        self.policy.bind(self.loop, self._job_completed)

    def service_sim(self, job: FheJob) -> SimResult:
        """The memoised cycle sim this engine prices ``job`` at — the cluster
        router estimates through the same entry, so routing estimates match
        the engine's charges exactly.  Honours the policy's ``deep_coop``."""
        coop = job.kind == "deep" and bool(getattr(self.policy, "deep_coop", False))
        return job_service_sim(job, self.chip, policy=self.exec_policy, deep_coop=coop,
                               device=self.device)

    def _trace_register(self) -> None:
        """Name this chip's trace process and intern its resource tracks in a
        fixed order (chip health first, then placement lanes), so track ids —
        and therefore exported bytes — depend only on topology, not on which
        job happens to land first.  The cluster router calls this after
        assigning ``chip_index``; standalone engines call it on first submit."""
        if self.tracer is None or self._trace_registered:
            return
        self._trace_registered = True
        pid = self.chip_index + 1
        self.tracer.name_process(pid, f"chip{self.chip_index} {self.chip.name}")
        self.tracer.track(pid, "chip")  # health: down spans, fault instants
        if hasattr(self.policy, "aff_running"):  # FlashPolicy-shaped
            for a in range(self.chip.n_affiliations):
                self.tracer.track(pid, f"affiliation-{a}")
            self.tracer.track(pid, "deep")
        else:
            self.tracer.track(pid, "whole-chip")

    def submit(self, job: FheJob, extra_cycles: float = 0.0, sim: SimResult | None = None,
               service_cycles: float | None = None,
               gang: "GangReservation | None" = None,
               arm_deadline: bool = True) -> JobExec:
        """Queue one job.  ``extra_cycles`` is added to the service demand —
        the cluster router charges warm-set cold starts (KSK/plaintext fetch)
        this way, so work conservation holds penalty-inclusive.  The router's
        gang path overrides the priced demand (``service_cycles`` = per-chip
        gang duration incl. link stalls, with ``sim`` the single-chip sim for
        reference) and attaches the fragment to its cross-chip reservation.
        ``arm_deadline=False`` skips the queue-timeout shed — the router's
        retry path uses it because a retry's deadline measured from the
        ORIGINAL arrival would already be in the past (and a retried job must
        not be shed mid-recovery anyway).
        """
        if sim is None:
            sim = self.service_sim(job)
        base = float(service_cycles) if service_cycles is not None else sim.cycles
        je = JobExec(job=job, service_cycles=base + float(extra_cycles), sim=sim,
                     lanes="", cold_start_cycles=float(extra_cycles), gang=gang,
                     chip_index=self.chip_index)
        if gang is not None:
            gang.attach(self.policy, je)
        self.jobs.append(je)
        # clamp: integer-rounded arrivals from a closed-loop source can land a
        # fraction of a cycle before a fractional clock (non-integral spill pay)
        arrival = max(self.loop.now, float(job.arrival_cycle))
        if self.tracer is not None and not self._fleet:
            # standalone engines own the job's async span; in fleet mode the
            # router opens it at routing time (retries re-enter here, and a
            # second ``b`` per job id would corrupt the async track)
            self._trace_register()
            self.tracer.job_begin(job.job_id, job.workload, ts=arrival,
                                  pid=self.chip_index + 1, kind=job.kind,
                                  tenant=job.tenant_id, priority=job.priority)
        self.loop.call_at(arrival, lambda: self.policy.submit(je))
        if self.shed_after is not None and gang is None and arm_deadline:
            # gang fragments are exempt: the lockstep barrier already bounds
            # their queueing through the router's gang-vs-single estimate, and
            # shedding one fragment of a committed reservation would deadlock
            # the others at the barrier
            je._deadline_ev = self.loop.call_at(
                arrival + self.shed_after, lambda: self._shed_deadline(je))
        return je

    def _shed_deadline(self, je: JobExec) -> None:
        """Queue-timeout shed: fires ``shed_after`` cycles past arrival; a
        no-op unless the job is still waiting for its first dispatch."""
        je._deadline_ev = None
        if je.state is JobState.QUEUED and je.first_start is None:
            self.shed(je)

    def shed(self, je: JobExec) -> None:
        """Terminal SHED for a queued job: cancel its pending events, mark it,
        and notify the fleet hook (the router un-books its backlog charge).
        The policy queues drop the entry lazily (``_PriorityQueue._purge``)."""
        assert je.state is JobState.QUEUED and je.first_start is None, (
            f"can only shed a never-started queued job, not {je.state}"
        )
        _cancel_deadline(je)
        if je._complete_ev is not None:  # defensive: queued jobs hold none
            je._complete_ev.cancel()
            je._complete_ev = None
        je.state = JobState.SHED
        je.shed_cycle = self.loop.now
        if self.tracer is not None and _primary(je):
            self.tracer.instant("shed", pid=self.chip_index + 1,
                                tid=self.tracer.track(self.chip_index + 1, "chip"),
                                job=je.job.job_id, reason="timeout")
        _trace_job_end(self.tracer, je, "SHED")
        if self.on_job_shed is not None:
            self.on_job_shed(je)

    def _job_completed(self, je: JobExec) -> None:
        # gang fragments complete once per member; only rank 0 is the job
        if self.metrics is not None and _primary(je):
            self.metrics.counter("serve.jobs_completed", labels=("kind",)).inc(
                kind=je.kind)
            self.metrics.histogram(
                "serve.turnaround_cycles", buckets=TURNAROUND_BUCKETS,
            ).observe(je.completion - je.job.arrival_cycle)
        if self.on_job_complete is not None:
            self.on_job_complete(je)
        if self._source is not None:
            for job in self._source.on_complete(je, self.loop.now):
                self.submit(job)

    def result(self) -> ServeResult:
        """Snapshot this engine's timeline (fleet mode runs the shared loop
        once, then collects per-chip results through here).  NB: with a
        shared loop, ``events_processed`` is the loop-wide total — events are
        not attributable to one engine."""
        makespan = max((je.completion for je in self.jobs
                        if je.completion is not None), default=0.0)
        return ServeResult(chip=self.chip, jobs=list(self.jobs),
                           makespan=makespan, events_processed=self.loop.processed,
                           chip_index=self.chip_index)

    def run(self, source=None) -> ServeResult:
        if source is not None:
            self._source = source
            for job in source.initial_jobs():
                self.submit(job)
        self.loop.run()
        return self.result()


def serve(jobs: list[FheJob], chip: ChipConfig, policy=None, validate: bool = True,
          hoist: bool = False, exec_policy: ExecPolicy | None = None,
          shed_after: float | None = None, tracer=None, metrics=None,
          device="cuda") -> ServeResult:
    """Run an open-loop job list through the event engine; the one-call API.

    ``exec_policy`` selects the service-time kernel mode (an
    ``repro_torch.fhe.ExecPolicy``); the legacy ``hoist=`` bool is honoured when no
    policy is given.  ``shed_after`` arms the engine-level queue timeout: jobs
    still queued that many cycles after arrival end ``JobState.SHED`` instead
    of waiting forever (fleet admission lives in ``serve_cluster``).
    ``tracer`` (an ``repro_torch.obs.Tracer``) records the run for Perfetto export;
    ``metrics`` (an ``repro_torch.obs.MetricsRegistry``) collects completion stats.
    ``device`` resolves a ``backend="auto"`` policy when pricing jobs
    (``job_service_sim``)."""
    eng = ServingEngine(chip, policy=policy, hoist=hoist, exec_policy=exec_policy,
                        shed_after=shed_after, tracer=tracer, metrics=metrics,
                        device=device)
    for job in jobs:
        eng.submit(job)
    result = eng.run()
    return result.validate() if validate else result


def serve_source(source, chip: ChipConfig, policy=None, validate: bool = True,
                 hoist: bool = False, exec_policy: ExecPolicy | None = None,
                 shed_after: float | None = None, tracer=None, metrics=None,
                 device="cuda") -> ServeResult:
    """Run a closed-loop traffic source (arrivals depend on completions)."""
    eng = ServingEngine(chip, policy=policy, hoist=hoist, exec_policy=exec_policy,
                        shed_after=shed_after, tracer=tracer, metrics=metrics,
                        device=device)
    result = eng.run(source=source)
    return result.validate() if validate else result
