"""Traffic generation for the serving subsystem: open-loop Poisson streams,
sharded per-chip sub-streams, a skewed bursty-tenant stream, a diurnal
(day/night rate curve) production-shaped stream, trace replay, and a
closed-loop "N concurrent tenants" source — plus the mix-capacity helpers
(``mix_capacity_jobs_per_mcycle`` / ``fleet_capacity_jobs_per_mcycle``) that
turn "serve X× fleet capacity" into a concrete arrival rate.

All generators are seeded and fully deterministic — the same seed reproduces
the same arrival sequence bit-for-bit (the determinism test in
``tests/test_serving.py`` relies on this).  Multi-source generators
(``sharded_poisson_jobs``, ``bursty_jobs``) derive one RNG per source by
deterministic seed splitting (``numpy.random.SeedSequence.spawn``) rather
than seed arithmetic, so the same seed with different shard counts yields
uncorrelated yet reproducible streams.  Times are in cycles; rates are jobs
per megacycle so they read naturally against the simulator's outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

import numpy as np

from repro_torch.core.jobs import FheJob, make_job

from .policy import JobExec

# Workload mixes over the paper's §6.1 presets.  Weights are relative
# (normalised at draw time).
SHALLOW_MIX: dict[str, float] = {
    "lola_mnist_plain": 0.35,
    "matmul": 0.30,
    "dblookup": 0.20,
    "lola_cifar_plain": 0.15,
}
DEEP_MIX: dict[str, float] = {"lstm": 0.6, "logreg": 0.4}
# shallow-heavy mixed traffic: the paper's headline multi-tenant scenario
MIXED_MIX: dict[str, float] = {
    "lola_mnist_plain": 0.30,
    "matmul": 0.25,
    "dblookup": 0.20,
    "lola_cifar_plain": 0.10,
    "lstm": 0.10,
    "logreg": 0.05,
}
# pure exact-arithmetic traffic (BGV presets only)
BGV_MIX: dict[str, float] = {"psi": 0.55, "exact_count": 0.45}
# mixed-scheme deployment (APACHE's argument): CKKS inference traffic plus
# exact integer workloads in one stream — shallow BGV jobs ride the swift
# clusters alongside shallow CKKS per the paper's affiliation policy
MULTISCHEME_MIX: dict[str, float] = {
    "lola_mnist_plain": 0.22,
    "matmul": 0.18,
    "psi": 0.20,
    "exact_count": 0.15,
    "dblookup": 0.10,
    "lola_cifar_plain": 0.05,
    "lstm": 0.07,
    "logreg": 0.03,
}


def _normalise(weights: Mapping) -> tuple[list, np.ndarray]:
    keys = list(weights.keys())
    w = np.asarray([float(weights[k]) for k in keys], dtype=float)
    total = w.sum()
    if total <= 0:
        raise ValueError("mix weights must sum to a positive value")
    return keys, w / total


@dataclasses.dataclass(frozen=True)
class PoissonConfig:
    """Open-loop Poisson arrivals over a workload/priority mix."""

    rate_per_mcycle: float  # mean arrival rate, jobs per 1e6 cycles
    n_jobs: int
    mix: Mapping[str, float] = dataclasses.field(default_factory=lambda: dict(MIXED_MIX))
    priority_mix: Mapping[int, float] = dataclasses.field(default_factory=lambda: {0: 1.0})
    seed: int = 0
    start_id: int = 0
    tenant_id: int = 0
    start_cycle: float = 0.0  # arrivals begin after this offset


def _draw_poisson(cfg: PoissonConfig, rng: np.random.Generator) -> list[FheJob]:
    names, name_p = _normalise(cfg.mix)
    prios, prio_p = _normalise(cfg.priority_mix)
    mean_gap = 1e6 / cfg.rate_per_mcycle
    t = float(cfg.start_cycle)
    jobs = []
    for i in range(cfg.n_jobs):
        t += float(rng.exponential(mean_gap))
        w = names[int(rng.choice(len(names), p=name_p))]
        pr = int(prios[int(rng.choice(len(prios), p=prio_p))])
        jobs.append(make_job(w, priority=pr, arrival_cycle=int(round(t)),
                             job_id=cfg.start_id + i, tenant_id=cfg.tenant_id))
    return jobs


def poisson_jobs(cfg: PoissonConfig) -> list[FheJob]:
    """Draw ``cfg.n_jobs`` arrivals with exponential inter-arrival gaps."""
    return _draw_poisson(cfg, np.random.default_rng(cfg.seed))


def sharded_poisson_jobs(cfg: PoissonConfig, n_shards: int) -> list[list[FheJob]]:
    """Split one logical Poisson stream into ``n_shards`` sub-streams.

    Each shard is an independent Poisson process at ``rate / n_shards`` (the
    superposition is statistically the original stream), seeded from its own
    ``SeedSequence.spawn`` child — per-shard RNGs are uncorrelated by
    construction, and the SAME ``cfg.seed`` stays reproducible at ANY shard
    count (no seed arithmetic collisions like ``seed + shard``).  Job ids
    partition ``[start_id, start_id + n_jobs)`` contiguously per shard;
    ``tenant_id`` is inherited from ``cfg``.

    Use case: pre-sharding an arrival stream per front-end (one router per
    region), or generating per-chip background traffic.  For a SINGLE router
    over N chips, pass the unsharded stream to ``serve_cluster`` instead.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    base, extra = divmod(cfg.n_jobs, n_shards)
    shards, next_id = [], cfg.start_id
    for k, child in enumerate(np.random.SeedSequence(cfg.seed).spawn(n_shards)):
        n_k = base + (1 if k < extra else 0)
        sub = dataclasses.replace(cfg, rate_per_mcycle=cfg.rate_per_mcycle / n_shards,
                                  n_jobs=n_k, start_id=next_id)
        shards.append(_draw_poisson(sub, np.random.default_rng(child)))
        next_id += n_k
    return shards


@dataclasses.dataclass(frozen=True)
class DiurnalConfig:
    """Production-shaped open-loop arrivals: a Poisson process whose rate
    follows a raised-cosine day/night curve over hours of simulated time.

    The instantaneous rate is::

        rate(t) = trough + (peak − trough) · ½(1 − cos 2π(t/period + phase))

    i.e. the stream starts at the trough (``phase_frac=0`` ≈ midnight), peaks
    half a period in, and returns — the canonical diurnal shape every
    production service sees.  The long-run mean rate is
    ``peak · (1 + trough_frac) / 2`` (``mean_rate_per_mcycle``), which is how
    the overload bench dials a stream to X× fleet capacity.  Arrivals are
    drawn by *thinning* (Lewis & Shedler): candidate arrivals at the peak
    rate, each kept with probability ``rate(t)/peak`` — exact for a
    non-homogeneous Poisson process and fully seeded/deterministic like every
    other source here.
    """

    peak_rate_per_mcycle: float
    period_mcycles: float = 40.0  # one simulated "day"
    n_periods: float = 2.0  # stream horizon in days
    trough_frac: float = 0.25  # night-time rate as a fraction of peak
    phase_frac: float = 0.0  # fraction of a period to shift the curve by
    mix: Mapping[str, float] = dataclasses.field(default_factory=lambda: dict(MIXED_MIX))
    priority_mix: Mapping[int, float] = dataclasses.field(default_factory=lambda: {0: 1.0})
    seed: int = 0
    start_id: int = 0
    tenant_id: int = 0

    def __post_init__(self):
        if self.peak_rate_per_mcycle <= 0:
            raise ValueError(f"peak rate must be positive, got {self.peak_rate_per_mcycle}")
        if self.period_mcycles <= 0 or self.n_periods <= 0:
            raise ValueError("period_mcycles and n_periods must be positive")
        if not 0.0 <= self.trough_frac <= 1.0:
            raise ValueError(f"trough_frac must be in [0, 1], got {self.trough_frac}")

    @property
    def mean_rate_per_mcycle(self) -> float:
        """Long-run mean of the rate curve (jobs per Mcycle)."""
        return self.peak_rate_per_mcycle * (1.0 + self.trough_frac) / 2.0

    @property
    def horizon_cycles(self) -> float:
        return self.n_periods * self.period_mcycles * 1e6


def diurnal_rate(cfg: DiurnalConfig, t_cycles: float) -> float:
    """Instantaneous arrival rate (jobs/Mcycle) at simulated time ``t_cycles``."""
    peak, trough = cfg.peak_rate_per_mcycle, cfg.trough_frac * cfg.peak_rate_per_mcycle
    x = t_cycles / (cfg.period_mcycles * 1e6) + cfg.phase_frac
    return trough + (peak - trough) * 0.5 * (1.0 - np.cos(2.0 * np.pi * x))


def diurnal_jobs(cfg: DiurnalConfig) -> list[FheJob]:
    """Materialise the diurnal stream over ``n_periods`` simulated days.

    Unlike ``poisson_jobs`` the job COUNT is not fixed — it is governed by
    the rate curve and the horizon (≈ ``mean_rate_per_mcycle × horizon``),
    exactly like real traffic.  Job ids are ``start_id, start_id+1, …`` in
    arrival order.
    """
    rng = np.random.default_rng(cfg.seed)
    names, name_p = _normalise(cfg.mix)
    prios, prio_p = _normalise(cfg.priority_mix)
    peak_gap = 1e6 / cfg.peak_rate_per_mcycle
    horizon = cfg.horizon_cycles
    t, jobs = 0.0, []
    while True:
        t += float(rng.exponential(peak_gap))
        if t >= horizon:
            return jobs
        # thinning: keep this candidate with probability rate(t)/peak
        if float(rng.uniform()) * cfg.peak_rate_per_mcycle > diurnal_rate(cfg, t):
            continue
        w = names[int(rng.choice(len(names), p=name_p))]
        pr = int(prios[int(rng.choice(len(prios), p=prio_p))])
        jobs.append(make_job(w, priority=pr, arrival_cycle=int(round(t)),
                             job_id=cfg.start_id + len(jobs), tenant_id=cfg.tenant_id))


def mix_capacity_jobs_per_mcycle(mix: Mapping[str, float], chip,
                                 exec_policy=None, deep_coop: bool = False,
                                 device="cuda") -> float:
    """Steady-state service capacity of ONE chip on this workload mix.

    Each shallow job occupies one of ``n_affiliations`` lanes for its service
    time (the §4.2 policy drains shallow work affiliation-wide); a deep job
    owns the whole chip.  The expected chip-time per offered job is therefore
    ``Σ p_w · service_w / width_w``, and capacity is its reciprocal in jobs
    per Mcycle.  An estimate, not an oracle — it ignores queueing geometry,
    cold starts, and preemption — but it is exactly the number a capacity
    planner needs to dial offered load to X× capacity.
    """
    from .policy import job_service_sim  # local: traffic is imported by policy users

    names, p = _normalise(mix)
    cost = 0.0
    for name, prob in zip(names, p):
        job = make_job(name)
        sim = job_service_sim(job, chip, policy=exec_policy, deep_coop=deep_coop,
                              device=device)
        width = chip.n_affiliations if (chip.multi_job and job.kind == "shallow") else 1
        cost += float(prob) * sim.cycles / width
    return 1e6 / cost


def fleet_capacity_jobs_per_mcycle(mix: Mapping[str, float], chip_pairs,
                                   deep_coop: bool = False, device="cuda") -> float:
    """Aggregate ``mix_capacity_jobs_per_mcycle`` over a fleet.

    ``chip_pairs`` is an iterable of ``ChipConfig`` or ``(ChipConfig,
    ExecPolicy | None)`` entries — the same shape ``ClusterConfig.chip_pairs``
    returns, so benches can size offered load straight off a cluster config.
    """
    total = 0.0
    for entry in chip_pairs:
        chip, pol = entry if isinstance(entry, tuple) else (entry, None)
        total += mix_capacity_jobs_per_mcycle(mix, chip, exec_policy=pol,
                                              deep_coop=deep_coop, device=device)
    return total


@dataclasses.dataclass(frozen=True)
class BurstyConfig:
    """Skewed stream: a smooth Poisson background (tenant 0) plus one bursty
    tenant (tenant 1) that dumps ``burst_size`` back-to-back jobs at each of
    ``n_bursts`` Poisson-placed epochs.  Background and burst sources draw
    from separately spawned RNGs (same seed ⇒ same stream; changing burst
    shape never perturbs the background draws)."""

    base: PoissonConfig  # the background stream (tenant 0)
    n_bursts: int = 4
    burst_size: int = 12
    intra_gap_cycles: float = 2_000.0  # spacing inside one burst
    burst_mix: Mapping[str, float] | None = None  # default: base.mix
    burst_priority_mix: Mapping[int, float] | None = None  # default: base's


def bursty_jobs(cfg: BurstyConfig) -> list[FheJob]:
    """Materialise the merged (background + bursts) stream, sorted by arrival."""
    bg_seq, burst_seq = np.random.SeedSequence(cfg.base.seed).spawn(2)
    background = _draw_poisson(cfg.base, np.random.default_rng(bg_seq))
    span = max((j.arrival_cycle for j in background), default=0)
    rng = np.random.default_rng(burst_seq)
    names, name_p = _normalise(cfg.burst_mix if cfg.burst_mix is not None else cfg.base.mix)
    prios, prio_p = _normalise(cfg.burst_priority_mix if cfg.burst_priority_mix is not None
                               else cfg.base.priority_mix)
    epochs = sorted(float(x) for x in rng.uniform(0.0, max(span, 1.0), size=cfg.n_bursts))
    jobs = list(background)
    next_id = cfg.base.start_id + cfg.base.n_jobs
    for epoch in epochs:
        for k in range(cfg.burst_size):
            w = names[int(rng.choice(len(names), p=name_p))]
            pr = int(prios[int(rng.choice(len(prios), p=prio_p))])
            jobs.append(make_job(w, priority=pr,
                                 arrival_cycle=int(round(epoch + k * cfg.intra_gap_cycles)),
                                 job_id=next_id, tenant_id=cfg.base.tenant_id + 1))
            next_id += 1
    jobs.sort(key=lambda j: (j.arrival_cycle, j.job_id))
    return jobs


def trace_jobs(rows: Iterable[Sequence | Mapping]) -> list[FheJob]:
    """Replay a recorded trace.  Rows are ``(workload, arrival_cycle[, priority])``
    tuples or dicts with those keys (plus optional ``job_id``/``tenant_id``)."""
    jobs = []
    for i, row in enumerate(rows):
        if isinstance(row, Mapping):
            jobs.append(make_job(row["workload"],
                                 priority=int(row.get("priority", 0)),
                                 arrival_cycle=int(row["arrival_cycle"]),
                                 job_id=int(row.get("job_id", i)),
                                 tenant_id=int(row.get("tenant_id", 0))))
        else:
            workload, arrival, *rest = row
            jobs.append(make_job(workload, priority=int(rest[0]) if rest else 0,
                                 arrival_cycle=int(arrival), job_id=i))
    return jobs


class ClosedLoopSource:
    """N concurrent tenants, each keeping exactly one job in flight.

    Every tenant submits its first job at cycle 0 (plus an optional think-time
    draw) and its next job ``think_cycles`` (exponentially distributed, mean)
    after the previous one completes, until ``jobs_per_tenant`` jobs are done.
    Pass to ``repro_torch.serve.serve_source`` / ``ServingEngine.run(source=...)``.
    """

    def __init__(self, n_tenants: int, jobs_per_tenant: int,
                 mix: Mapping[str, float] | None = None,
                 priority_mix: Mapping[int, float] | None = None,
                 think_cycles: float = 0.0, seed: int = 0):
        self.n_tenants = n_tenants
        self.jobs_per_tenant = jobs_per_tenant
        self._names, self._name_p = _normalise(mix if mix is not None else SHALLOW_MIX)
        self._prios, self._prio_p = _normalise(priority_mix if priority_mix is not None else {0: 1.0})
        self.think_cycles = float(think_cycles)
        self._rng = np.random.default_rng(seed)
        self._submitted = {t: 0 for t in range(n_tenants)}
        self._next_id = 0

    def _draw(self, tenant: int, arrival: float) -> FheJob:
        w = self._names[int(self._rng.choice(len(self._names), p=self._name_p))]
        pr = int(self._prios[int(self._rng.choice(len(self._prios), p=self._prio_p))])
        job = make_job(w, priority=pr, arrival_cycle=int(round(arrival)),
                       job_id=self._next_id, tenant_id=tenant)
        self._next_id += 1
        self._submitted[tenant] += 1
        return job

    def _think(self) -> float:
        return float(self._rng.exponential(self.think_cycles)) if self.think_cycles > 0 else 0.0

    def initial_jobs(self) -> list[FheJob]:
        return [self._draw(t, self._think()) for t in range(self.n_tenants)]

    def on_complete(self, je: JobExec, now: float) -> list[FheJob]:
        tenant = je.job.tenant_id
        if self._submitted[tenant] >= self.jobs_per_tenant:
            return []
        return [self._draw(tenant, now + self._think())]
