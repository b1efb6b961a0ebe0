"""FHE job descriptions and the deep/shallow classifier (paper §4.2 step 1)."""

from __future__ import annotations

import dataclasses

from repro_torch.fhe.params import CkksParams, workload_kind, workload_params, workload_scheme


@dataclasses.dataclass(frozen=True)
class FheJob:
    """One submitted FHE workload instance."""

    workload: str  # name in fhe.params.WORKLOAD_PRESETS
    params: CkksParams
    priority: int = 0  # higher = more urgent (preemptive scheduling)
    arrival_cycle: int = 0
    job_id: int = 0
    tenant_id: int = 0  # submitting tenant (fairness accounting in repro_torch.serve)

    @property
    def kind(self) -> str:
        return classify(self.params)

    @property
    def scheme(self) -> str:
        """"ckks" or "bgv" — derived from the params (plain_modulus axis);
        the serving layer re-tags its ``ExecPolicy`` per job with this."""
        return self.params.scheme


def classify(params: CkksParams) -> str:
    """Paper §3.2: shallow ⇔ N ≤ 2^14 (no bootstrapping budget needed)."""
    return "shallow" if params.is_shallow() else "deep"


def make_job(workload: str, priority: int = 0, arrival_cycle: int = 0, job_id: int = 0,
             tenant_id: int = 0) -> FheJob:
    p = workload_params(workload)
    job = FheJob(workload=workload, params=p, priority=priority,
                 arrival_cycle=arrival_cycle, job_id=job_id, tenant_id=tenant_id)
    if job.kind != workload_kind(workload):
        raise ValueError(
            f"workload {workload!r}: classifier says {job.kind!r} but the preset "
            f"declares {workload_kind(workload)!r} — fix the preset's N or kind"
        )
    if job.scheme != workload_scheme(workload):
        raise ValueError(
            f"workload {workload!r}: params encode scheme {job.scheme!r} but the "
            f"preset declares {workload_scheme(workload)!r} — plain_modulus and "
            "the preset's scheme tag are out of sync"
        )
    return job
