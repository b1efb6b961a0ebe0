"""Multi-job FHE scheduling — compatibility wrapper over ``repro_torch.serve``.

The actual policy now lives in the discrete-event serving subsystem
(``repro_torch.serve.policy``): per-affiliation shallow placement with multi-exit
decomposition, deep-job gang scheduling across all bootstrappable clusters,
and priority preemption with an explicit SRAM→HBM spill/restore cost and a
real suspend/resume state machine.  This module keeps the historical
``schedule(jobs, chip) -> list[ScheduledJob]`` surface so existing call sites
(tests, examples, paper-figure benchmarks) run the new engine unchanged.

The event engine also fixes two bugs in the old one-pass heuristic:

  * preemption no longer rewinds *all* affiliation free-times (which let the
    old scheduler double-book placements) — ``ServeResult.validate`` now
    asserts that no two placements overlap on any affiliation;
  * ``ScheduledJob.preempted_cycles`` records the cycles a job actually lost
    to suspension + spill/restore, instead of always 0.0.
"""

from __future__ import annotations

import dataclasses

from .hardware import ChipConfig
from .jobs import FheJob
from .simulator import SimResult


@dataclasses.dataclass
class ScheduledJob:
    job: FheJob
    start_cycle: float
    end_cycle: float
    lanes: str
    sim: SimResult
    preempted_cycles: float = 0.0
    chip_index: int = 0  # which fleet chip ran the job (0 when n_chips == 1)

    @property
    def completion_cycle(self) -> float:
        return self.end_cycle

    @property
    def turnaround(self) -> float:
        return self.end_cycle - self.job.arrival_cycle


def schedule(jobs: list[FheJob], chip: ChipConfig | None = None, n_chips: int = 1,
             router: str = "jsq", exec_policy=None, chips=None,
             gang_max_chips: int = 1, admission=None,
             faults=None, retry=None, device="cuda") -> list[ScheduledJob]:
    """Run ``jobs`` through the event-driven serving engine; returns per-job
    placement and completion in submission order.  Timeline consistency
    (no overlapping placements, work conservation) is asserted on every call.

    ``n_chips > 1`` shards the stream across a fleet of identical chips via
    ``repro_torch.serve.cluster`` (dispatch policy = ``router``); ``chips=`` a
    per-chip list of ``ChipConfig`` / ``(ChipConfig, ExecPolicy)`` entries
    builds a heterogeneous fleet instead, and ``gang_max_chips > 1`` lets
    deep jobs gang-split across identical chips.  Each returned
    ``ScheduledJob.chip_index`` names the (primary) chip that ran it.
    ``exec_policy`` (an ``repro_torch.fhe.ExecPolicy``) selects the service-time
    kernel mode.  ``admission`` (an ``repro_torch.serve.AdmissionConfig``) arms
    overload protection: SHED jobs are *dropped from the returned schedule*
    (they have no placement or completion) — callers that need the shed
    records use ``repro_torch.serve.serve_cluster`` directly.  ``faults=`` (a
    ``repro_torch.serve.FaultPlan`` / ``FaultConfig``) and ``retry=`` (a
    ``RetryPolicy``) arm fault injection on the fleet path; like SHED jobs,
    FAILED (retries-exhausted) jobs are dropped from the returned schedule.
    ``device`` resolves a ``backend="auto"`` ``exec_policy`` when pricing
    ("cuda": fused key-switch pipeline, "cpu": staged).
    """
    # deferred import: repro_torch.core.__init__ imports this module, and the serve
    # package imports repro_torch.core submodules — a top-level import would cycle
    from repro_torch.serve.cluster import serve_cluster
    from repro_torch.serve.policy import JobState, serve

    if chips is None and n_chips <= 1 and faults is None:
        shed_after = admission.shed_after_cycles if admission is not None else None
        jes = serve(jobs, chip, validate=True, exec_policy=exec_policy,
                    shed_after=shed_after, device=device).jobs
    else:
        jes = serve_cluster(jobs, chip, n_chips=n_chips, router=router, validate=True,
                            exec_policy=exec_policy, chips=chips,
                            gang_max_chips=gang_max_chips, admission=admission,
                            faults=faults, retry=retry, device=device).jobs
    jes = [je for je in jes if je.state is JobState.DONE]
    return [
        ScheduledJob(
            job=je.job,
            start_cycle=je.first_start,
            end_cycle=je.completion,
            lanes=je.lanes,
            sim=je.sim,
            preempted_cycles=je.preempted_cycles,
            chip_index=je.chip_index,
        )
        for je in jes
    ]


def avg_completion_cycles(scheduled: list[ScheduledJob]) -> float:
    return sum(s.turnaround for s in scheduled) / len(scheduled)


def makespan(scheduled: list[ScheduledJob]) -> float:
    return max(s.end_cycle for s in scheduled)
