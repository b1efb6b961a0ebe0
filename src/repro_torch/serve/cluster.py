"""Multi-chip serving scale-out: a DES front-end router over a (possibly
heterogeneous) fleet of FHE accelerator chips.

One FLASH-FHE die saturates quickly under shallow-heavy Poisson streams (8
affiliations × ~0.15 Mcycle shallow services ≈ 50 jobs/Mcycle); the ROADMAP's
"millions of users" north star is a fleet problem.  This module shards a
single arrival stream across per-chip ``ServingEngine``s that all tick inside
ONE shared ``EventLoop`` — the router is itself a discrete-event component:
each arrival fires a routing event, the chosen engine schedules the job, and
completions flow back through the engine's ``on_job_complete`` hook to keep
the router's backlog estimates exact.

Fleet shape: homogeneous (``n_chips`` copies of one ``ChipConfig``) or
heterogeneous — ``ClusterConfig.chips`` takes a per-chip list of
``(ChipConfig, ExecPolicy)`` pairs, so a fleet can mix FLASH-FHE, CraterLake
and F1+ dies with different kernel/hoisting modes per chip (service-time
memoisation keys on ``ExecPolicy.policy_key()``, so mixed modes never alias).

Dispatch policies (``ClusterConfig.router``):

  round_robin  — cyclic, state-free; the baseline every queueing text beats
  jsq          — join-shortest-queue by *estimated backlog cycles* (the sum of
                 outstanding routed service demand per chip); near-optimal
                 when service demand is known, as it is here (the cycle-level
                 simulator prices every job before placement)
  po2          — power-of-two-choices: sample two chips with the router's own
                 seeded RNG, keep the shorter backlog; O(1) state reads with
                 most of jsq's benefit (Mitzenmacher's classic result)
  affinity     — workload-affinity: route to the chip minimising
                 ``backlog + cold_start_penalty``, where the penalty is the
                 HBM cost of faulting the job's KSK/plaintext working set
                 (``working_set_bytes / hbm_bytes_per_cycle × cold_factor``)
                 into a chip whose warm-set doesn't hold it.  With penalties
                 zeroed this degrades to jsq exactly.
  hetero       — heterogeneity-aware: minimise ``backlog + THIS chip's
                 service time for THIS job + cold penalty``.  On a mixed
                 fleet this is what routes deep jobs toward big-cache
                 bootstrappable-heavy chips and shallow floods toward
                 multi-affiliation chips; on a homogeneous fleet it degrades
                 to ``affinity``.

Cross-chip deep gangs (``ClusterConfig.gang_max_chips > 1``): a deep job may
split across up to M identical FlashPolicy chips' bootstrappable clusters.
Per-chip compute shards M ways, and each fragment additionally stalls through
the serialized inter-chip link exchanges (``policy.gang_service_cycles``;
bandwidth ``ClusterConfig.link_bytes_per_cycle``, priced ≫ the on-chip L3
transpose).  The planner compares the best gang's estimated completion
(barrier wait = the most-backlogged member, plus the per-chip gang demand)
against the best single-chip placement and only commits a multi-chip
``GangReservation`` when the gang strictly wins — queueing delay is weighed
against split speedup at routing time.  Gang fragments skip the warm-set
model (the gang streams its state through the link, not the per-chip LRU).

Warm-set model: every chip keeps an LRU of workload working sets capped at
its shared-L2 capacity (configurable).  ALL policies pay the cold-start
penalty on a warm-set miss — residency is a property of the chip, not of the
router — but only ``affinity``/``hetero`` *steer around* it.  The penalty is
charged into the job's service demand (``ServingEngine.submit``) so the
per-chip timeline invariants (work conservation, no overlap) hold
penalty-inclusive and ``ClusterResult.validate`` can re-assert them.

Quick use::

    from repro_torch.core.hardware import CRATERLAKE, F1PLUS, FLASH_FHE
    from repro_torch import serve

    jobs = serve.poisson_jobs(serve.PoissonConfig(rate_per_mcycle=200.0,
                                                  n_jobs=320, seed=7))
    mixed = serve.serve_cluster(
        jobs, chips=[FLASH_FHE, FLASH_FHE, CRATERLAKE, F1PLUS],
        router="hetero", gang_max_chips=2)
    print(serve.summarize(mixed))           # fleet-level SLOs
"""

from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict

import numpy as np

from repro_torch.core.cache import MB
from repro_torch.core.hardware import ChipConfig
from repro_torch.core.jobs import FheJob
from repro_torch.fhe.context import ExecPolicy
from repro_torch.obs.metrics import MetricsRegistry

from .events import EventLoop
from .faults import FaultConfig, FaultEvent, FaultPlan, RetryPolicy
from .policy import (
    GANG_SYNCS,
    AdmissionConfig,
    FlashPolicy,
    GangReservation,
    JobExec,
    JobState,
    ServeResult,
    ServingEngine,
    TokenBucket,
    _trace_job_end,
    gang_link_bytes,
    gang_service_cycles,
    working_set_bytes,
)

ROUTERS = ("round_robin", "jsq", "po2", "affinity", "hetero")


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Fleet shape + router policy + warm-set/cold-start + gang model."""

    n_chips: int = 0  # 0 = derive from ``chips`` (one of the two is required)
    router: str = "jsq"
    seed: int = 0  # router-local RNG (po2 sampling) — split off via SeedSequence
    cold_start: bool = True  # model warm-set misses at all?
    cold_factor: float = 2.0  # penalty = factor × working_set_bytes / hbm_B_per_cycle
    warm_capacity_mb: float | None = None  # per-chip warm-set cap; default: chip L2
    hoist: bool = False  # legacy bool spelling of the hoisted-rotation kernel mode
    # service-time execution policy per engine; wins over ``hoist`` when set —
    # its ``policy_key()`` is what keys the per-(chip, workload, kind) memo
    exec_policy: ExecPolicy | None = None
    # heterogeneous fleet: one (ChipConfig, ExecPolicy | None) pair per chip
    # (bare ChipConfig entries are accepted; ``exec_policy`` fills the gaps).
    # ``None`` = homogeneous fleet of ``n_chips`` × the serve_cluster chip.
    chips: tuple | None = None
    # cross-chip deep gangs: a deep job may split across up to this many
    # identical FlashPolicy chips (1 = gangs off)
    gang_max_chips: int = 1
    # inter-chip link bandwidth the gang exchanges are serialized through.
    # 256 B/cycle = 4× slower than one chip's HBM (1024 B/cycle) and 32×
    # slower than the 2048-port on-chip L3 transpose — crossing the package
    # boundary is deliberately expensive
    link_bytes_per_cycle: float = 256.0
    gang_syncs: int = GANG_SYNCS  # global barriers per ganged deep job
    # overload protection (None = admit everything, the historical behaviour):
    # utilization reserve + per-tenant token buckets at the router, and an
    # engine-level queue timeout — see ``policy.AdmissionConfig``
    admission: AdmissionConfig | None = None
    # fault injection (repro_torch.serve.faults): a FaultPlan (scripted) or a
    # FaultConfig (seeded random plan, drawn over the fleet at router build).
    # None = fault-free, the historical behaviour
    faults: FaultPlan | FaultConfig | None = None
    # recovery policy for transiently-failed jobs; None with faults armed
    # means NO recovery (failed jobs are lost — the bench's divergence
    # baseline uses RetryPolicy(max_attempts=0), which is equivalent)
    retry: RetryPolicy | None = None
    # where the fleet's jobs would run: resolves a ``backend="auto"`` policy's
    # key-switch pipeline when pricing ("cuda": fused, "cpu": staged)
    device: str = "cuda"

    def __post_init__(self):
        if self.admission is not None and not isinstance(self.admission, AdmissionConfig):
            raise ValueError(
                f"admission must be an AdmissionConfig, got {type(self.admission).__name__}")
        if self.faults is not None and not isinstance(self.faults, (FaultPlan, FaultConfig)):
            raise ValueError(
                f"faults must be a FaultPlan or FaultConfig, got {type(self.faults).__name__}")
        if self.retry is not None and not isinstance(self.retry, RetryPolicy):
            raise ValueError(
                f"retry must be a RetryPolicy, got {type(self.retry).__name__}")
        if self.chips is not None:
            norm = []
            for entry in self.chips:
                if isinstance(entry, ChipConfig):
                    norm.append((entry, self.exec_policy))
                else:
                    c, p = entry
                    norm.append((c, p if p is not None else self.exec_policy))
            object.__setattr__(self, "chips", tuple(norm))
            if self.n_chips == 0:
                object.__setattr__(self, "n_chips", len(norm))
            elif self.n_chips != len(norm):
                raise ValueError(
                    f"n_chips={self.n_chips} disagrees with len(chips)={len(norm)}")
        if self.n_chips < 1:
            raise ValueError(f"n_chips must be >= 1, got {self.n_chips}")
        if self.router not in ROUTERS:
            raise ValueError(f"unknown router {self.router!r}; choose from {ROUTERS}")
        if self.gang_max_chips < 1:
            raise ValueError(f"gang_max_chips must be >= 1, got {self.gang_max_chips}")
        if self.link_bytes_per_cycle <= 0:
            raise ValueError("link_bytes_per_cycle must be positive")
        if self.gang_syncs < 0:
            raise ValueError("gang_syncs must be >= 0")

    def chip_pairs(self, default_chip: ChipConfig | None = None) -> tuple:
        """The fleet as (ChipConfig, ExecPolicy | None) pairs, one per chip."""
        if self.chips is not None:
            return self.chips
        if default_chip is None:
            raise ValueError("homogeneous ClusterConfig needs a default chip")
        return tuple((default_chip, self.exec_policy) for _ in range(self.n_chips))


@dataclasses.dataclass
class ClusterResult:
    """Per-chip timelines + the merged fleet view.

    ``jobs`` holds one ``JobExec`` per routed job in submission order; for a
    ganged deep job that is its rank-0 (primary) fragment — the other
    fragments live only in their chips' ``chip_results`` timelines, and
    ``gangs`` maps the job id to the full member-chip tuple.
    """

    chip: ChipConfig  # primary/default chip (chips[0] on heterogeneous fleets)
    config: ClusterConfig
    chip_results: list[ServeResult]  # NB: each carries the SHARED loop's event
    # total in events_processed (per-chip attribution is not meaningful when
    # one clock drives every engine); the fleet-wide count lives below
    jobs: list[JobExec]  # submission order (matching ``serve.serve`` semantics)
    placements: dict[int, int]  # job_id -> chip index (primary member for gangs)
    makespan: float
    events_processed: int
    chips: list[ChipConfig] = dataclasses.field(default_factory=list)  # per-chip
    gangs: dict[int, tuple[int, ...]] = dataclasses.field(default_factory=dict)
    # router state snapshots at drain (admission/overload observability):
    # per-chip backlog estimators (should both be ~0 after a full drain and
    # are invariant-checked non-negative with serial <= total), the peak
    # fleet-wide backlog over the run (the "are queues bounded?" observable),
    # and shed counts by trigger ("token_bucket" / "reserve" / "timeout")
    final_backlog: list[float] = dataclasses.field(default_factory=list)
    final_backlog_serial: list[float] = dataclasses.field(default_factory=list)
    peak_backlog_cycles: float = 0.0
    shed_reasons: dict[str, int] = dataclasses.field(default_factory=dict)
    # per-chip shed attribution: chip -1 = rejected at the router's door
    # (token_bucket / reserve / no_healthy_chip — never routed anywhere),
    # chip i >= 0 = queue-timeout sheds on that chip.  ``validate`` asserts
    # the breakdown sums back to the fleet-global ``shed_reasons``
    shed_reasons_by_chip: dict[int, dict[str, int]] = dataclasses.field(default_factory=dict)
    # fault observability: per-chip [crash, recover) downtime windows (an
    # unrecovered crash closes at the run's end) and injected/handled fault
    # counters ("crashes" / "transients" / "slow_windows" / "retries" /
    # "jobs_lost" / "retry_no_chip")
    downtime: dict[int, list[tuple[float, float]]] = dataclasses.field(default_factory=dict)
    fault_counts: dict[str, int] = dataclasses.field(default_factory=dict)
    # per-chip fault attribution: injected events on their target chip,
    # retries/jobs_lost on the chip the attempt failed on, retry_no_chip
    # (whole fleet dark) on -1; sums back to ``fault_counts``
    fault_counts_by_chip: dict[int, dict[str, int]] = dataclasses.field(default_factory=dict)
    # ``MetricsRegistry.snapshot()`` of the run's registry (serve.shed /
    # serve.faults counters, turnaround histogram, peak-backlog gauge)
    metrics: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.chips:
            self.chips = [self.chip] * self.config.n_chips

    @property
    def n_chips(self) -> int:
        return self.config.n_chips

    def check_no_lost_jobs(self) -> "ClusterResult":
        """The no-lost-job invariant, cheap enough to run UNCONDITIONALLY:
        every submitted job's primary record is terminal — DONE, SHED, or
        FAILED (retries exhausted).  A job silently dropped by a buggy policy
        (stranded QUEUED/SUSPENDED, or a FAILED_TRANSIENT attempt never
        retried or given up on) trips this even with ``validate=False``."""
        terminal = (JobState.DONE, JobState.SHED, JobState.FAILED)
        for je in self.jobs:
            assert je.state in terminal, (
                f"job {je.job.job_id} lost: final state {je.state} is not terminal "
                f"(DONE/SHED/FAILED)"
            )
        return self

    def validate(self) -> "ClusterResult":
        """Fleet invariants on top of each chip's own ``ServeResult.validate``:
        no job is lost (every primary record terminal); every non-gang job
        completed on EXACTLY one chip (or was shed/failed); every gang job ran
        EXACTLY once on each reserved member chip with its fragments finishing
        in lockstep; an aborted gang failed in lockstep too (every fragment
        frozen at the same ``failed_cycle``); no run segment overlaps its
        chip's downtime windows (nothing placed on a dead chip); the recorded
        placements match the per-chip timelines; admission-shed jobs appear on
        NO chip and in NO placement; the backlog estimators never drift
        negative (and the serial component never exceeds the total); and the
        fleet makespan is the max over chips."""
        self.check_no_lost_jobs()
        for r in self.chip_results:
            r.validate()
        done_on: dict[int, list[int]] = {}  # jid -> chips holding a DONE record
        done_frags: dict[int, list[JobExec]] = {}
        failed_records: list[JobExec] = []
        for i, r in enumerate(self.chip_results):
            for je in r.jobs:
                jid = je.job.job_id
                assert je.chip_index == i, (
                    f"job {jid} tagged chip {je.chip_index}, found on chip {i}"
                )
                if je.state is JobState.DONE:
                    assert not (je.gang_size == 1 and i in done_on.get(jid, ())), (
                        f"job {jid} double-booked on chip {i}"
                    )
                    done_on.setdefault(jid, []).append(i)
                    done_frags.setdefault(jid, []).append(je)
                elif je.state in (JobState.FAILED_TRANSIENT, JobState.FAILED):
                    failed_records.append(je)
                # no-placement-on-dead-chip: every run interval must avoid the
                # chip's downtime windows entirely
                for seg in je.segments:
                    for lo, hi in self.downtime.get(i, ()):
                        assert seg.end <= lo + 1e-6 or seg.start >= hi - 1e-6, (
                            f"job {jid} ran [{seg.start}, {seg.end}) on chip {i} "
                            f"during its downtime [{lo}, {hi})"
                        )
        # gang lockstep-abort: an aborted gang freezes EVERY fragment at one
        # instant — group failed gang fragments by (job, failed_cycle) and
        # demand each abort event covers the full membership on distinct chips
        aborts: dict[tuple[int, float], list[JobExec]] = {}
        for je in failed_records:
            if je.gang_size > 1:
                aborts.setdefault((je.job.job_id, je.failed_cycle), []).append(je)
        for (jid, at), group in aborts.items():
            want = group[0].gang_size
            assert len(group) == want, (
                f"gang job {jid} aborted at {at} with {len(group)} of {want} "
                f"fragments — lockstep abort violated"
            )
            used = [f.chip_index for f in group]
            assert len(set(used)) == len(used), (
                f"gang job {jid} abort records collide on chips {used}"
            )
        # router-shed jobs (chip_index < 0): rejected at the door, so they
        # must never have reached a chip timeline, a placement, or a warm-set
        # (the cold_start_cycles charge is the warm-set's observable)
        router_shed = {je.job.job_id for je in self.jobs
                       if je.state is JobState.SHED and je.chip_index < 0}
        for je in self.jobs:
            if je.job.job_id in router_shed:
                assert not je.segments and je.completion is None
                assert je.shed_cycle is not None and je.cold_start_cycles == 0.0
        assert not router_shed & set(done_on), (
            f"admission-shed jobs found on chips: {sorted(router_shed & set(done_on))}"
        )
        for name, arr in (("backlog", self.final_backlog),
                          ("backlog_serial", self.final_backlog_serial)):
            for i, v in enumerate(arr):
                assert v >= 0.0, f"chip {i} {name} estimator drifted negative: {v}"
        for i, (total, serial) in enumerate(zip(self.final_backlog,
                                                self.final_backlog_serial)):
            assert serial <= total + 1e-6 * max(1.0, total), (
                f"chip {i} serial backlog {serial} exceeds total {total}"
            )
        for jid, used in done_on.items():
            fs = done_frags[jid]
            if fs[0].gang_size == 1:
                assert len(used) == 1, f"non-gang job {jid} completed on chips {used}"
                assert self.placements[jid] == used[0], (
                    f"job {jid} placed on chip {self.placements[jid]}, ran on {used[0]}"
                )
                continue
            members = self.gangs.get(jid)
            assert members is not None, f"gang fragments of {jid} lack a reservation"
            assert len(set(members)) == len(members), (
                f"gang {jid} reserves chip(s) twice: {members}"
            )
            assert sorted(used) == sorted(members), (
                f"gang job {jid} ran on chips {used}, reserved {members}"
            )
            assert self.placements[jid] == members[0]
            assert all(f.gang_size == len(members) for f in fs)
            comps = [f.completion for f in fs]
            assert max(comps) - min(comps) <= 1e-6 * max(1.0, max(comps)), (
                f"gang job {jid} fragments finished out of lockstep: {comps}"
            )
        done_primary = {je.job.job_id for je in self.jobs if je.state is JobState.DONE}
        assert done_primary == set(done_on), (
            "primary DONE records disagree with chip timelines"
        )
        n_failed = sum(1 for je in self.jobs if je.state is JobState.FAILED)
        n_shed = sum(1 for je in self.jobs if je.state is JobState.SHED)
        assert len(self.jobs) == len(done_primary) + n_shed + n_failed, (
            f"{len(self.jobs)} jobs routed != {len(done_primary)} done "
            f"+ {n_shed} shed + {n_failed} failed"
        )
        per_chip_mk = max((r.makespan for r in self.chip_results), default=0.0)
        assert abs(self.makespan - per_chip_mk) <= 1e-6 * max(1.0, per_chip_mk)
        # per-chip attribution must re-aggregate to the fleet-global books
        # (both are views over one labelled counter, so a mismatch means the
        # router double- or under-counted somewhere)
        for label, per_chip, total in (
                ("shed", self.shed_reasons_by_chip, self.shed_reasons),
                ("fault", self.fault_counts_by_chip, self.fault_counts)):
            agg: dict[str, int] = {}
            for chip, counts in per_chip.items():
                assert -1 <= chip < self.config.n_chips, (
                    f"{label} attribution names unknown chip {chip}")
                for k, v in counts.items():
                    agg[k] = agg.get(k, 0) + v
            assert agg == total, (
                f"per-chip {label} breakdown {agg} does not sum to the "
                f"fleet-global book {total}")
        return self


class ClusterRouter:
    """Front-end DES router: shards one arrival stream over N engines."""

    def __init__(self, chip: ChipConfig | None, config: ClusterConfig,
                 loop: EventLoop | None = None, tracer=None, metrics=None):
        pairs = config.chip_pairs(chip)
        self.chip = chip if chip is not None else pairs[0][0]
        self.config = config
        # observability (repro_torch.obs): the tracer timestamps off the SHARED
        # loop; the metrics registry is the fleet's shed/fault book of record
        # (``shed_reasons``/``fault_counts`` re-aggregate it, so the global
        # and per-chip views can never disagree)
        self.tracer = tracer if tracer else None
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._shed_ctr = self.metrics.counter("serve.shed", labels=("reason", "chip"))
        self._fault_ctr = self.metrics.counter("serve.faults", labels=("kind", "chip"))
        self._backlog_gauge = self.metrics.gauge("serve.peak_backlog_cycles")
        self.loop = loop if loop is not None else EventLoop(tracer=self.tracer)
        self.chips = [c for c, _ in pairs]
        adm = config.admission
        self.engines = [ServingEngine(c, loop=self.loop, hoist=config.hoist,
                                      exec_policy=p,
                                      shed_after=(adm.shed_after_cycles
                                                  if adm is not None else None),
                                      tracer=self.tracer, metrics=self.metrics,
                                      device=config.device)
                        for c, p in pairs]
        for i, eng in enumerate(self.engines):
            eng.chip_index = i
            eng._fleet = True  # the router owns job async spans
            eng.on_job_complete = functools.partial(self._completed, i)
            eng.on_job_shed = functools.partial(self._shed_echo, i)
        self._router_tid = 0
        if self.tracer is not None:
            # fixed trace topology up front: pid 0 = router, pid i+1 = chip i,
            # every resource track interned now so tids depend only on the
            # fleet shape (not on arrival order)
            self.tracer.name_process(0, "fleet router")
            self._router_tid = self.tracer.track(0, "router")
            for eng in self.engines:
                eng._trace_register()
        # per-tenant token buckets, created lazily on first arrival
        self._buckets: dict[int, TokenBucket] = {}
        # fault state: chip health, downtime windows, and the retry policy.
        # ``alive`` mirrors each policy's flag but lives here so the routing
        # hot path never reaches into engines
        self.alive = [True] * config.n_chips
        self.retry = config.retry
        self.downtime: dict[int, list[tuple[float, float]]] = {}
        self._down_since: dict[int, float] = {}
        if config.faults is not None:
            plan = (config.faults.draw(config.n_chips)
                    if isinstance(config.faults, FaultConfig) else config.faults)
            self.arm_faults(plan)
        # peak fleet-wide backlog estimate over the run: THE bounded-queues
        # observable (without admission it grows with the overload integral,
        # with admission it plateaus near the utilization reserve)
        self.peak_backlog = 0.0
        # estimated outstanding service cycles per chip: the simulator prices
        # each job at routing time and completions echo back.  An estimate,
        # not an oracle — spill/restore added to a preempted deep job after
        # placement is not re-echoed into the backlog
        self.backlog = [0.0] * config.n_chips
        # the deep-job component of each backlog: deep service occupies a
        # whole chip (all affiliations), so it drains serially even on a
        # multi-affiliation chip — the wait estimator prices it at full width
        self.backlog_serial = [0.0] * config.n_chips
        self.placements: dict[int, int] = {}
        self.gangs: dict[int, tuple[int, ...]] = {}  # job_id -> member chips
        self._submit_order: list[int] = []  # job_ids in submission order
        self._seen_ids: set[int] = set()
        self._by_id: dict[int, JobExec] = {}
        self._rr_next = 0
        self._rng = np.random.default_rng(np.random.SeedSequence(config.seed))
        self._warm_cap = [
            (config.warm_capacity_mb if config.warm_capacity_mb is not None
             else c.l2_mb) * MB
            for c in self.chips]
        self._warm: list[OrderedDict[str, float]] = [OrderedDict() for _ in range(config.n_chips)]
        # gang-capable chips, grouped by identical pricing — fragments must
        # progress in lockstep, so members share (chip, policy_key, coop)
        groups: dict[tuple, list[int]] = {}
        for i, eng in enumerate(self.engines):
            if isinstance(eng.policy, FlashPolicy):
                key = (eng.chip, eng.exec_policy.policy_key(),
                       eng.policy.deep_coop)
                groups.setdefault(key, []).append(i)
        self._gang_groups = [idxs for idxs in groups.values() if len(idxs) >= 2]

    # -- shed/fault books: derived views over the metrics counters -----------
    # (single source of truth — the fleet-global dicts and the per-chip
    # breakdowns are two aggregations of the same labelled counter, so
    # ``ClusterResult.validate`` can assert they sum without ever diverging)

    @staticmethod
    def _per_chip(ctr) -> dict[int, dict[str, int]]:
        return {int(chip): {key[0]: int(v) for key, v in rest.items()}
                for chip, rest in ctr.by_label("chip").items()}

    @property
    def shed_reasons(self) -> dict[str, int]:
        return {k: int(v) for k, v in self._shed_ctr.group_sum("reason").items()}

    @property
    def shed_reasons_by_chip(self) -> dict[int, dict[str, int]]:
        """Shed counts by chip: ``-1`` = rejected at the router's door
        (token_bucket / reserve / no_healthy_chip), ``i >= 0`` = queue-timeout
        sheds that had already been routed to chip i."""
        return self._per_chip(self._shed_ctr)

    @property
    def fault_counts(self) -> dict[str, int]:
        return {k: int(v) for k, v in self._fault_ctr.group_sum("kind").items()}

    @property
    def fault_counts_by_chip(self) -> dict[int, dict[str, int]]:
        """Fault/recovery counts by chip: injected events land on their target
        chip; retries/jobs_lost attribute to the chip the attempt FAILED on;
        ``retry_no_chip`` (whole fleet dark) lands on ``-1``."""
        return self._per_chip(self._fault_ctr)

    # -- submission ---------------------------------------------------------

    def submit(self, job: FheJob) -> None:
        """Schedule the routing decision at the job's arrival instant."""
        assert job.job_id not in self._seen_ids, (
            f"duplicate job_id {job.job_id}: the router keys placements by id"
        )
        self._seen_ids.add(job.job_id)
        self._submit_order.append(job.job_id)
        self.loop.call_at(max(self.loop.now, float(job.arrival_cycle)),
                          lambda: self._route(job))

    # -- dispatch policies --------------------------------------------------

    def _alive_idx(self) -> list[int]:
        return [i for i in range(self.config.n_chips) if self.alive[i]]

    def _pick(self, job: FheJob) -> int:
        """Health-aware placement: dead chips are invisible to every policy.
        Callers must guarantee at least one healthy chip (``_route`` sheds
        with reason "no_healthy_chip" otherwise)."""
        alive = self._alive_idx()
        assert alive, "_pick called with no healthy chip"
        if len(alive) == 1:
            return alive[0]
        r = self.config.router
        if r == "round_robin":
            while True:  # skip dead chips, keep the cyclic order among live ones
                i = self._rr_next % self.config.n_chips
                self._rr_next += 1
                if self.alive[i]:
                    return i
        if r == "jsq":
            return min(alive, key=lambda i: (self.backlog[i], i))
        if r == "po2":
            a, b = (alive[int(x)] for x in
                    self._rng.choice(len(alive), size=2, replace=False))
            return a if (self.backlog[a], a) <= (self.backlog[b], b) else b
        if r == "affinity":
            # total marginal cost = backlog + the cold-start you'd pay
            return min(alive, key=lambda i: (self.backlog[i] + self._cold_penalty(job, i), i))
        # hetero: like affinity, but also price THIS chip's service time for
        # THIS job — on a mixed fleet the estimate is what steers deep jobs to
        # bootstrappable-heavy chips and shallow floods to swift-heavy ones
        return min(alive, key=lambda i: (self._est(job, i), i))

    def _drain_width(self, i: int) -> int:
        """How many jobs chip i retires concurrently: a FlashPolicy chip
        drains a (shallow-dominated) backlog one job per affiliation, a
        sequential chip one at a time.  Raw backlog cycles would overstate a
        multi-affiliation chip's congestion by exactly this factor."""
        eng = self.engines[i]
        return eng.chip.n_affiliations if isinstance(eng.policy, FlashPolicy) else 1

    def _wait(self, i: int) -> float:
        """Estimated wall-clock cycles until chip i drains its backlog: the
        shallow component retires ``_drain_width`` jobs at a time, the deep
        component (whole-chip gangs) serially."""
        serial = self.backlog_serial[i]
        parallel = max(0.0, self.backlog[i] - serial)
        return parallel / self._drain_width(i) + serial

    def _est(self, job: FheJob, i: int) -> float:
        """Estimated completion of ``job`` on chip i: the backlog's wall-clock
        drain time plus this chip's service time for this job (+ cold start)."""
        return (self._wait(i)
                + self.engines[i].service_sim(job).cycles
                + self._cold_penalty(job, i))

    # -- cross-chip gang planner --------------------------------------------

    def _plan_gang(self, job: FheJob) -> list[int] | None:
        """Pick gang members for a deep job, or ``None`` to stay single-chip.

        For every group of identically-priced gang-capable chips, try widths
        M = 2..gang_max_chips over the M least-loaded members: estimated
        completion = the most-loaded member's drain time (the lockstep
        barrier waits for it) + the per-chip gang demand (compute/M + link
        stalls).  Commit only if the best gang strictly beats the best
        single-chip estimate — split speedup is weighed against the queueing
        delay of aligning M chips."""
        if not self._gang_groups:
            return None
        best_single = min(self._est(job, i) for i in self._alive_idx())
        best: tuple[float, int, list[int]] | None = None
        for group in self._gang_groups:
            idxs = [i for i in group if self.alive[i]]  # dead members can't gang
            if len(idxs) < 2:
                continue
            single = self.engines[idxs[0]].service_sim(job).cycles
            order = sorted(idxs, key=lambda i: (self._wait(i), i))
            for m in range(2, min(self.config.gang_max_chips, len(order)) + 1):
                members = order[:m]
                per_chip, _ = gang_service_cycles(
                    single, job, m, self.config.link_bytes_per_cycle,
                    self.config.gang_syncs)
                est = max(self._wait(i) for i in members) + per_chip
                if best is None or (est, m) < (best[0], best[1]):
                    best = (est, m, members)
        if best is not None and best[0] < best_single:
            return best[2]
        return None

    # -- warm-set / cold-start model ----------------------------------------

    def _cold_penalty(self, job: FheJob, i: int) -> float:
        if not self.config.cold_start or job.workload in self._warm[i]:
            return 0.0
        return (self.config.cold_factor * working_set_bytes(job)
                / self.chips[i].hbm_bytes_per_cycle)

    def _touch_warm(self, job: FheJob, i: int) -> None:
        w = self._warm[i]
        if job.workload in w:
            w.move_to_end(job.workload)
        else:
            w[job.workload] = working_set_bytes(job)
        while len(w) > 1 and sum(w.values()) > self._warm_cap[i]:
            w.popitem(last=False)  # evict least-recently-used working set

    # -- admission control ---------------------------------------------------

    def _admission_verdict(self, job: FheJob) -> str | None:
        """``None`` = admit; otherwise the shed trigger ("token_bucket" /
        "reserve").  The bucket is charged first — an over-rate tenant pays
        with its own tokens before it can even contend for fleet capacity."""
        adm = self.config.admission
        if adm is None:
            return None
        if adm.tenant_rate_per_mcycle is not None:
            bucket = self._buckets.get(job.tenant_id)
            if bucket is None:
                bucket = self._buckets[job.tenant_id] = TokenBucket(
                    adm.tenant_rate_per_mcycle, adm.tenant_burst)
            if not bucket.try_take(self.loop.now):
                return "token_bucket"
        if adm.max_wait_cycles is not None:
            # price the DEGRADED fleet: the reserve shrinks with the healthy
            # fraction, so admission tightens during an outage instead of
            # letting arrivals queue up against capacity that no longer exists
            # and shedding late (by timeout) after the SLO is already blown
            alive = self._alive_idx()
            bound = adm.max_wait_cycles * len(alive) / self.config.n_chips
            best = min(self._wait(i) for i in alive)
            if best > bound:
                return "reserve"
        return None

    def _shed_at_door(self, job: FheJob, reason: str) -> None:
        """Admission rejection: terminal SHED without touching any engine,
        warm-set, or backlog estimator.  The record keeps the job visible to
        the metrics layer (drop rate by tenant/kind) via ``ClusterResult.jobs``
        with the sentinel ``chip_index = -1``."""
        je = JobExec(job=job, service_cycles=0.0, sim=None, lanes="",
                     state=JobState.SHED, chip_index=-1)
        je.shed_cycle = self.loop.now
        self._by_id[job.job_id] = je
        self._shed_ctr.inc(reason=reason, chip=-1)
        if self.tracer is not None:
            # door-shed jobs never reach a chip: their whole (empty) lifecycle
            # lives on the router process
            self.tracer.job_begin(job.job_id, job.workload, pid=0,
                                  kind=job.kind, tenant=job.tenant_id,
                                  priority=job.priority)
            self.tracer.instant("shed", pid=0, tid=self._router_tid,
                                job=job.job_id, reason=reason)
            self.tracer.job_end(job.job_id, job.workload, "SHED", pid=0)

    def _note_backlog(self) -> None:
        total = sum(self.backlog)
        self.peak_backlog = max(self.peak_backlog, total)
        self._backlog_gauge.max(total)
        if self.tracer is not None:
            self.tracer.counter("backlog_cycles", {"total": total})

    # -- fault injection + recovery ------------------------------------------

    def arm_faults(self, plan: FaultPlan) -> None:
        """Schedule every fault event on the shared loop.  Must happen before
        arrivals are submitted (the constructor arms ``config.faults``): fault
        events then carry the lowest sequence numbers, so at any shared
        timestamp the fault processes FIRST and routing decisions already see
        the new health state — same-instant races resolve deterministically.
        Events aimed past the fleet (chip >= n_chips) are dropped."""
        for ev in plan.events:
            if ev.chip < self.config.n_chips:
                self.loop.call_at(ev.at, functools.partial(self._fault, ev))

    def _count(self, key: str, chip: int, n: int = 1) -> None:
        self._fault_ctr.inc(n, kind=key, chip=chip)

    def _fault_mark(self, name: str, i: int, **args) -> None:
        """Instant on chip i's health track (the "chip" tid is always 0 —
        ``_trace_register`` interns it first)."""
        if self.tracer is not None:
            self.tracer.instant(name, pid=i + 1,
                                tid=self.tracer.track(i + 1, "chip"), **args)

    def _fault(self, ev: FaultEvent) -> None:
        now = self.loop.now
        i = ev.chip
        policy = self.engines[i].policy
        if ev.kind == "crash":
            if not self.alive[i]:
                return  # random plans can crash an already-dead chip
            self._count("crashes", i)
            self.alive[i] = False
            self._down_since[i] = now
            if self.tracer is not None:
                # downtime is a B/E span on the health track: crash/recover
                # windows never overlap per chip (the guards above/below), so
                # the stack stays balanced; ``run`` closes unrecovered spans
                self.tracer.begin("down", pid=i + 1,
                                  tid=self.tracer.track(i + 1, "chip"))
            victims = policy.fail_all(now)
            self._handle_victims(victims, now)
            # the chip's outstanding work is gone: zero its estimators (the
            # victims' demand requeues against HEALTHY chips) and drop its
            # warm-set — recovery rejoins cold
            self.backlog[i] = 0.0
            self.backlog_serial[i] = 0.0
            self._warm[i].clear()
        elif ev.kind == "recover":
            if self.alive[i]:
                return
            self.alive[i] = True
            policy.revive()
            self.downtime.setdefault(i, []).append((self._down_since.pop(i), now))
            if self.tracer is not None:
                self.tracer.end("down", pid=i + 1,
                                tid=self.tracer.track(i + 1, "chip"))
        elif ev.kind == "transient":
            if not self.alive[i]:
                return  # a dead chip has nothing running to fault
            self._count("transients", i)
            self._fault_mark("transient", i)
            self._handle_victims(policy.fail_one(now), now)
        elif ev.kind == "slow_start":
            # slowdown windows are instants, NOT B/E spans: they may straddle
            # a crash/recover window on the same track, which would break the
            # B/E stack discipline the validator enforces
            self._count("slow_windows", i)
            self._fault_mark("slow_start", i, factor=ev.factor)
            policy.slow_factor = ev.factor
        else:  # slow_end
            self._fault_mark("slow_end", i)
            policy.slow_factor = 1.0

    def _handle_victims(self, victims: list[JobExec], now: float) -> None:
        """Requeue (or give up on) every job a fault just killed.  ``victims``
        holds one record per failed FRAGMENT; a gang abort contributes its
        whole membership, which collapses to ONE retry of the job."""
        by_job: dict[int, list[JobExec]] = {}
        for je in victims:
            self._debit_backlog(je.chip_index, je)
            by_job.setdefault(je.job.job_id, []).append(je)
        for records in by_job.values():
            primary = min(records, key=lambda je: je.gang_rank)
            carried = (primary.prior_wasted_cycles
                       + sum(r.wasted_cycles for r in records))
            self._by_id[primary.job.job_id] = primary
            self._after_failure(primary.job, primary, primary.attempts, carried)

    def _after_failure(self, job: FheJob, old: JobExec, attempts_done: int,
                       carried_wasted: float) -> None:
        """Decide the failed job's fate: exhausted → terminal FAILED; else
        schedule a retry after the policy's capped exponential backoff.
        ``attempts_done`` counts consumed attempts (a retry window finding
        zero healthy chips consumes one too, without producing a record)."""
        rp = self.retry
        if rp is None or attempts_done > rp.max_attempts:
            old.state = JobState.FAILED
            self._count("jobs_lost", old.chip_index)
            _trace_job_end(self.tracer, old, "FAILED")
            return
        self._count("retries", old.chip_index)
        delay = rp.backoff_cycles(attempts_done)
        if self.tracer is not None:
            self.tracer.instant("retry", pid=0, tid=self._router_tid,
                                job=job.job_id, attempt=attempts_done + 1,
                                delay=delay)
        self.loop.call_after(delay, functools.partial(
            self._retry, job, old, attempts_done, carried_wasted))

    def _price_key(self, i: int) -> tuple:
        """Service-pricing identity of chip i — a checkpoint's ``remaining``
        is denominated in these cycles, so resume needs an exact match."""
        eng = self.engines[i]
        return (eng.chip, eng.exec_policy.policy_key(),
                getattr(eng.policy, "deep_coop", None))

    def _retry(self, job: FheJob, old: JobExec, attempts_done: int,
               carried_wasted: float) -> None:
        """Re-place a transiently-failed job on the healthy sub-fleet.

        Retries bypass admission (the job was already admitted and has
        already paid — shedding it mid-recovery would both waste that work
        and violate the shed carve-outs) and skip the queue-timeout deadline
        (measured from the original arrival it would fire instantly).  A deep
        job with a spill checkpoint resumes its ``remaining`` on an
        identically-priced chip; everything else restarts in full, deep jobs
        re-entering the gang planner over the healthy sub-fleet."""
        now = self.loop.now
        if not any(self.alive):
            # the whole fleet is dark: burn an attempt and back off again
            self._count("retry_no_chip", -1)
            self._after_failure(job, old, attempts_done + 1, carried_wasted)
            return
        rp = self.retry
        attempts = attempts_done + 1
        use_ckpt = (rp.checkpoint and old._has_checkpoint and old.gang is None
                    and job.kind == "deep")
        if use_ckpt:
            okey = self._price_key(old.chip_index)
            cands = [i for i in self._alive_idx() if self._price_key(i) == okey]
            if cands:
                i = min(cands, key=lambda c: (self._wait(c), c))
                je = self.engines[i].submit(job, sim=old.sim,
                                            service_cycles=old.remaining,
                                            arm_deadline=False)
                je.full_service_cycles = old.full_service_cycles
                je.checkpoint_cycles = max(
                    0.0, old.full_service_cycles - old.remaining)
                je._has_checkpoint = True  # the HBM image outlives the crash
                self._book_retry(je, i, job, old, attempts, carried_wasted)
                return
            # no identically-priced healthy chip: fall through to full restart
        if job.kind == "deep" and self.config.gang_max_chips > 1:
            members = self._plan_gang(job)
            if members is not None:
                self._route_gang(job, members,
                                 retry_meta=(attempts, carried_wasted,
                                             old.first_start))
                return
        i = self._pick(job)
        je = self.engines[i].submit(job, arm_deadline=False)
        self._book_retry(je, i, job, old, attempts, carried_wasted)

    def _book_retry(self, je: JobExec, i: int, job: FheJob, old: JobExec,
                    attempts: int, carried_wasted: float) -> None:
        je.attempts = attempts
        je.prior_wasted_cycles = carried_wasted
        je.first_start = old.first_start  # queueing delay stays the original's
        self.placements[job.job_id] = i
        self.gangs.pop(job.job_id, None)  # a single-chip retry ends gang status
        self._by_id[job.job_id] = je
        self.backlog[i] += je.service_cycles
        if job.kind == "deep":
            self.backlog_serial[i] += je.service_cycles
        self._note_backlog()

    # -- event handlers ------------------------------------------------------

    def _route(self, job: FheJob) -> None:
        if not any(self.alive):
            # the entire fleet is dark: there is no queue to wait in (the
            # router holds no backlog of its own), so arrivals shed at the
            # door — the availability metrics surface the outage window
            self._shed_at_door(job, "no_healthy_chip")
            return
        verdict = self._admission_verdict(job)
        if verdict is not None:
            self._shed_at_door(job, verdict)
            return
        if job.kind == "deep" and self.config.gang_max_chips > 1:
            members = self._plan_gang(job)
            if members is not None:
                self._route_gang(job, members)
                return
        i = self._pick(job)
        if self.tracer is not None:
            # the router opens the job's async span (engines are fleet-managed
            # and stay silent in submit); the routing instant makes the
            # placement decision visible on the router track
            self.tracer.job_begin(job.job_id, job.workload, pid=i + 1,
                                  kind=job.kind, tenant=job.tenant_id,
                                  priority=job.priority)
            self.tracer.instant("routed", pid=0, tid=self._router_tid,
                                job=job.job_id, chip=i)
        pay = self._cold_penalty(job, i)  # counted in metrics via cold_start_cycles
        self._touch_warm(job, i)
        je = self.engines[i].submit(job, extra_cycles=pay)
        self.placements[job.job_id] = i
        self._by_id[job.job_id] = je
        self.backlog[i] += je.service_cycles
        if job.kind == "deep":
            self.backlog_serial[i] += je.service_cycles
        self._note_backlog()

    def _route_gang(self, job: FheJob, members: list[int],
                    retry_meta: tuple[int, float, float | None] | None = None) -> None:
        """Commit a multi-chip reservation: one lockstep fragment per member.

        Every fragment carries the full per-chip gang demand (compute/M +
        link stalls) so each member chip's work conservation validates; the
        rank-0 fragment is the job's primary record (``ClusterResult.jobs``)
        and additionally logs the gang-total link bytes.  ``retry_meta``
        (attempts, carried waste, original first_start) marks a re-ganged
        retry of a failed job."""
        eng = self.engines[members[0]]
        sim = eng.service_sim(job)
        per_chip, link = gang_service_cycles(
            sim.cycles, job, len(members), self.config.link_bytes_per_cycle,
            self.config.gang_syncs)
        if self.tracer is not None and retry_meta is None:
            self.tracer.job_begin(job.job_id, job.workload, pid=members[0] + 1,
                                  kind=job.kind, tenant=job.tenant_id,
                                  priority=job.priority)
        if self.tracer is not None:
            self.tracer.instant("routed_gang", pid=0, tid=self._router_tid,
                                job=job.job_id, chips=list(members))
        gang = GangReservation(job, self.loop)
        for rank, i in enumerate(members):
            je = self.engines[i].submit(job, sim=sim, service_cycles=per_chip,
                                        gang=gang,
                                        arm_deadline=retry_meta is None)
            je.chip_index = i
            je.gang_rank = rank
            je.gang_size = len(members)
            je.link_cycles = link
            if retry_meta is not None:
                attempts, carried, first_start = retry_meta
                je.attempts = attempts
                je.first_start = first_start
                if rank == 0:
                    je.prior_wasted_cycles = carried
            if rank == 0:
                je.link_bytes = gang_link_bytes(job, len(members),
                                                self.config.gang_syncs)
                self._by_id[job.job_id] = je
            self.backlog[i] += je.service_cycles
            self.backlog_serial[i] += je.service_cycles
        self.placements[job.job_id] = members[0]
        self.gangs[job.job_id] = tuple(members)
        self._note_backlog()

    def _debit_backlog(self, i: int, je: JobExec) -> None:
        """Echo a job's routed service demand back out of chip i's estimators.

        Every decrement clamps at 0.0 — actual service can diverge from the
        routed estimate (preemption spill/restore accrues after placement,
        gang suspensions re-price remaining work), so naive subtraction can
        drift the estimators negative and then *attract* the jsq/po2/hetero
        routers to phantom capacity.  The serial component is additionally
        clamped to never exceed the total (``ClusterResult.validate`` asserts
        both invariants on the drained snapshot)."""
        self.backlog[i] = max(0.0, self.backlog[i] - je.service_cycles)
        if je.kind == "deep":
            self.backlog_serial[i] = max(
                0.0, self.backlog_serial[i] - je.service_cycles)
        self.backlog_serial[i] = min(self.backlog_serial[i], self.backlog[i])

    def _completed(self, i: int, je: JobExec) -> None:
        self._debit_backlog(i, je)

    def _shed_echo(self, i: int, je: JobExec) -> None:
        """A queue-timeout shed un-books the backlog the router charged at
        routing time (the job will never run), so the estimators keep
        tracking genuinely outstanding work."""
        self._debit_backlog(i, je)
        self._shed_ctr.inc(reason="timeout", chip=i)

    # -- run -----------------------------------------------------------------

    def run(self) -> ClusterResult:
        self.loop.run()
        # a chip still dark at drain closes its downtime window at run end so
        # availability integrates the full outage (and its open "down" trace
        # span closes with it, keeping the B/E stacks balanced)
        for i, start in sorted(self._down_since.items()):
            self.downtime.setdefault(i, []).append((start, self.loop.now))
            if self.tracer is not None:
                self.tracer.end("down", pid=i + 1,
                                tid=self.tracer.track(i + 1, "chip"))
        self._down_since.clear()
        chip_results = [eng.result() for eng in self.engines]
        makespan = max((r.makespan for r in chip_results), default=0.0)
        jobs = [self._by_id[jid] for jid in self._submit_order]  # submission order
        return ClusterResult(chip=self.chip, config=self.config,
                             chip_results=chip_results, jobs=jobs,
                             placements=dict(self.placements), makespan=makespan,
                             events_processed=self.loop.processed,
                             chips=list(self.chips), gangs=dict(self.gangs),
                             final_backlog=list(self.backlog),
                             final_backlog_serial=list(self.backlog_serial),
                             peak_backlog_cycles=self.peak_backlog,
                             shed_reasons=dict(self.shed_reasons),
                             shed_reasons_by_chip=self.shed_reasons_by_chip,
                             downtime={i: list(w) for i, w in self.downtime.items()},
                             fault_counts=dict(self.fault_counts),
                             fault_counts_by_chip=self.fault_counts_by_chip,
                             metrics=self.metrics.snapshot())


def serve_cluster(jobs: list[FheJob], chip: ChipConfig | None = None, n_chips: int = 2,
                  router: str = "jsq", seed: int = 0, cold_start: bool = True,
                  cold_factor: float = 2.0, warm_capacity_mb: float | None = None,
                  config: ClusterConfig | None = None,
                  validate: bool = True, hoist: bool = False,
                  exec_policy: ExecPolicy | None = None,
                  chips=None, gang_max_chips: int = 1,
                  link_bytes_per_cycle: float = 256.0,
                  gang_syncs: int = GANG_SYNCS,
                  admission: AdmissionConfig | None = None,
                  faults: FaultPlan | FaultConfig | None = None,
                  retry: RetryPolicy | None = None,
                  tracer=None, metrics=None, device: str = "cuda") -> ClusterResult:
    """Serve an open-loop job list on a chip fleet; the one-call API.

    Homogeneous fleet: pass ``chip`` + ``n_chips``.  Heterogeneous fleet:
    pass ``chips=`` a per-chip list of ``ChipConfig`` or ``(ChipConfig,
    ExecPolicy)`` entries (``chip``/``n_chips`` are then ignored).
    ``gang_max_chips > 1`` lets deep jobs gang across identical FlashPolicy
    chips with link exchanges priced at ``link_bytes_per_cycle``.  Pass
    ``config=`` to reuse a prepared ``ClusterConfig`` (the other keyword
    arguments are ignored in that case); ``exec_policy`` sets the per-engine
    service-time execution policy (wins over the legacy ``hoist=`` bool).
    ``admission=`` arms overload protection (``AdmissionConfig``: per-tenant
    token buckets + utilization reserve at the router, queue-timeout at the
    engines); rejected jobs end ``JobState.SHED`` and surface through the
    drop-rate/goodput metrics rather than growing the backlog.  ``faults=``
    arms seeded fault injection (``FaultPlan`` scripted / ``FaultConfig``
    random) and ``retry=`` the recovery policy — see ``repro_torch.serve.faults``.
    ``tracer=`` (an ``repro_torch.obs.Tracer``) records the whole fleet run —
    chips→processes, affiliations/lanes→threads, job lifecycles as async
    spans — for Perfetto export (``repro_torch.obs.write_chrome_trace``);
    ``metrics=`` supplies the ``repro_torch.obs.MetricsRegistry`` backing the
    shed/fault books (one is created per run when omitted, and its snapshot
    lands in ``ClusterResult.metrics`` either way).  ``device`` resolves a
    ``backend="auto"`` policy when pricing jobs (``ClusterConfig.device``).
    """
    cfg = config if config is not None else ClusterConfig(
        n_chips=0 if chips is not None else n_chips, router=router, seed=seed,
        cold_start=cold_start, cold_factor=cold_factor,
        warm_capacity_mb=warm_capacity_mb, hoist=hoist, exec_policy=exec_policy,
        chips=tuple(chips) if chips is not None else None,
        gang_max_chips=gang_max_chips, link_bytes_per_cycle=link_bytes_per_cycle,
        gang_syncs=gang_syncs, admission=admission, faults=faults, retry=retry,
        device=device)
    rt = ClusterRouter(chip, cfg, tracer=tracer, metrics=metrics)
    for job in jobs:
        rt.submit(job)
    result = rt.run()
    result.check_no_lost_jobs()  # cheap, unconditional: no job may vanish
    return result.validate() if validate else result
