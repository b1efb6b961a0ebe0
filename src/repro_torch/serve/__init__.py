"""repro_torch.serve — discrete-event multi-tenant serving for mixed FHE traffic.

The online realisation of the paper's §4.2 scheduling policy:

  events   — generic event heap / clock / run loop (the DES kernel)
  policy   — FlashPolicy (shallow-per-affiliation + deep gang + priority
             preemption with spill/restore, optional ``deep_coop`` swift-lane
             sharing) and the sequential baseline, plus the ServingEngine,
             the timeline-validated ServeResult, and the cross-chip
             GangReservation barrier
  cluster  — multi-chip scale-out: a DES front-end router sharding one
             arrival stream over a homogeneous OR heterogeneous fleet in one
             shared loop (round-robin / join-shortest-queue / power-of-two /
             workload-affinity / hetero routing, a per-chip warm-set
             cold-start model, and cross-chip deep gangs with an explicit
             inter-chip link cost)
  traffic  — seeded Poisson / sharded / bursty / diurnal / trace-replay /
             closed-loop tenant sources (multi-source RNGs via
             SeedSequence.spawn) plus mix/fleet capacity estimators
  metrics  — SLO summary: latency & queueing percentiles (overall and
             per-kind), throughput, utilization (+ per-chip and per-chip-type
             views), fairness, starvation, gang/link totals, and the overload
             block (goodput, drop rate by kind/tenant, time-to-shed)

Overload protection (``AdmissionConfig``): per-tenant token buckets and a
utilization reserve at the cluster router plus an engine-level queue
timeout; rejected jobs end in the terminal ``JobState.SHED`` with their
queued events cancelled and never touch warm-sets or backlog estimators —
see docs/serving.md "Overload & admission".

Fault tolerance (``repro_torch.serve.faults``): seeded chip-crash/recover,
transient-failure and straggler injection (``FaultPlan``/``FaultConfig``)
with recovery under a ``RetryPolicy`` — capped exponential backoff,
checkpoint resume from the last SRAM→HBM spill for deep jobs, lockstep
gang aborts, and health-aware routing that excludes dead chips — see
docs/serving.md "Fault tolerance & recovery".

Quick use::

    from repro_torch.core.hardware import CRATERLAKE, F1PLUS, FLASH_FHE
    from repro_torch import serve

    cfg = serve.traffic.PoissonConfig(rate_per_mcycle=4.0, n_jobs=64, seed=7)
    result = serve.serve(serve.traffic.poisson_jobs(cfg), FLASH_FHE)
    print(serve.metrics.summarize(result))

    fleet = serve.serve_cluster(serve.traffic.poisson_jobs(cfg),
                                chips=[FLASH_FHE, FLASH_FHE, CRATERLAKE, F1PLUS],
                                router="hetero", gang_max_chips=2)
    print(serve.summarize(fleet))

Service-time execution modes (kernel pipeline, rotation hoisting, numerics)
are selected with an ``repro_torch.fhe.ExecPolicy`` (re-exported here):
``serve(..., exec_policy=ExecPolicy(backend="fused", hoisting="always"))``.
The policy's ``policy_key()`` keys the per-(chip, workload, kind) service
memo, so distinct modes never alias.  ``backend="auto"`` resolves on the
``device`` the pricing entry points take (default "cuda": the fused
key-switch pipeline; "cpu": staged), never on what the host has; the
resolved pipeline is part of the memo key too.

``repro_torch.core.scheduler.schedule`` is a thin compatibility wrapper over this
package (``n_chips=`` routes through the cluster).
"""

from repro_torch.fhe.context import ExecPolicy

from . import cluster, events, faults, metrics, policy, traffic
from .cluster import ClusterConfig, ClusterResult, ClusterRouter, serve_cluster
from .events import Event, EventLoop
from .faults import FAULT_KINDS, FaultConfig, FaultEvent, FaultPlan, RetryPolicy
from .metrics import (
    drop_rate_by_tenant,
    goodput_by_tenant,
    max_queueing_by_kind,
    per_chip_type_utilization,
    summarize,
    summarize_cluster,
)
from .policy import (
    AdmissionConfig,
    FlashPolicy,
    GangReservation,
    JobExec,
    JobState,
    Segment,
    SequentialPolicy,
    ServeResult,
    ServingEngine,
    TokenBucket,
    exec_policy_from_hoist,
    gang_link_bytes,
    gang_service_cycles,
    job_service_sim,
    serve,
    serve_source,
    working_set_bytes,
)
from .traffic import (
    BurstyConfig,
    ClosedLoopSource,
    DiurnalConfig,
    PoissonConfig,
    bursty_jobs,
    diurnal_jobs,
    diurnal_rate,
    fleet_capacity_jobs_per_mcycle,
    mix_capacity_jobs_per_mcycle,
    poisson_jobs,
    sharded_poisson_jobs,
    trace_jobs,
)
