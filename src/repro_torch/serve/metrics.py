"""SLO metrics over a ``ServeResult`` / ``ClusterResult``: latency
percentiles, throughput, per-cluster utilization, queueing delay, fairness,
and starvation counters.

Everything is derived from the per-job ``Segment`` timelines the event engine
records, so the numbers are exact (no sampling).  Cycle quantities convert to
wall-clock through the chip frequency.  ``summarize`` accepts either result
type; ``summarize_cluster`` is the explicit fleet path (per-chip utilization
imbalance, Jain fairness across chips as well as tenants, cold-start totals).
"""

from __future__ import annotations

import numpy as np

from .cluster import ClusterResult
from .policy import JobState, ServeResult

PERCENTILES = (50.0, 95.0, 99.0)


def _pct(values: list[float]) -> dict[str, float]:
    """Percentiles of a sample; an EMPTY sample yields NaN, not 0.0.

    A zero here used to read as a *perfect* tail — a stream with no deep
    completions (or every job shed) would sail through a "p99 must beat X"
    CI gate.  NaN poisons any such comparison instead (NaN > x and NaN < x
    are both False), and the ``n_completed_{kind}`` counts let gates require
    a non-empty sample explicitly."""
    if not values:
        return {f"p{int(q)}": float("nan") for q in PERCENTILES}
    arr = np.asarray(values, dtype=float)
    return {f"p{int(q)}": float(np.percentile(arr, q)) for q in PERCENTILES}


def jain_fairness(values: list[float]) -> float:
    """Jain's index: 1.0 = perfectly fair, 1/n = one value dominates."""
    if not values:
        return 1.0
    arr = np.asarray(values, dtype=float)
    denom = len(arr) * float((arr ** 2).sum())
    return float(arr.sum()) ** 2 / denom if denom > 0 else 1.0


def per_affiliation_busy(result: ServeResult) -> dict[str, float]:
    """Busy cycles per affiliation; deep gangs occupy every affiliation."""
    n_aff = result.chip.n_affiliations if result.chip.multi_job else 1
    busy = {f"affiliation-{a}": 0.0 for a in range(n_aff)}
    for je in result.jobs:
        for seg in je.segments:
            if seg.resource in busy:
                busy[seg.resource] += seg.cycles
            else:  # "deep" / "whole-chip": the whole machine is occupied
                for a in range(n_aff):
                    busy[f"affiliation-{a}"] += seg.cycles
    return busy


def tenant_slowdowns(result: ServeResult | ClusterResult) -> dict[int, float]:
    """Mean slowdown (turnaround ÷ service) per tenant."""
    acc: dict[int, list[float]] = {}
    for je in result.jobs:
        if je.state is JobState.DONE and je.service_cycles > 0:
            acc.setdefault(je.job.tenant_id, []).append(je.turnaround / je.service_cycles)
    return {t: float(np.mean(v)) for t, v in acc.items()}


def max_queueing_by_kind(result: ServeResult | ClusterResult) -> dict[str, float]:
    """Worst-case queueing delay (arrival → first dispatch) per job kind.

    This is the starvation indicator the ROADMAP asks for: under
    ``FlashPolicy`` a saturating shallow stream can hold every affiliation
    busy indefinitely, so a same-priority deep job's gang never launches —
    the deep entry here grows with the stream length while the shallow entry
    stays bounded by the service quantum.  (The aging/utilization-reserve
    knob that bounds it is a follow-on PR; the metric ships now.)
    """
    out = {"shallow": 0.0, "deep": 0.0}
    for je in result.jobs:
        if je.state is JobState.DONE:
            out[je.kind] = max(out[je.kind], je.queueing_delay)
    return out


def drop_rate_by_tenant(result: ServeResult | ClusterResult) -> dict[int, float]:
    """Shed fraction of each tenant's offered jobs (admission + timeout sheds)."""
    offered: dict[int, int] = {}
    shed: dict[int, int] = {}
    for je in result.jobs:
        t = je.job.tenant_id
        offered[t] = offered.get(t, 0) + 1
        if je.state is JobState.SHED:
            shed[t] = shed.get(t, 0) + 1
    return {t: shed.get(t, 0) / n for t, n in offered.items()}


def goodput_by_tenant(result: ServeResult | ClusterResult) -> dict[int, int]:
    """Completed-job count per tenant — the per-tenant goodput numerator the
    token-bucket isolation property compares (victim goodput under a flood vs
    its solo goodput)."""
    out: dict[int, int] = {}
    for je in result.jobs:
        if je.state is JobState.DONE:
            out[je.job.tenant_id] = out.get(je.job.tenant_id, 0) + 1
    return out


def _overload_block(result: ServeResult | ClusterResult,
                    done: list, makespan: float) -> dict[str, float]:
    """Shared SLO-degradation keys: offered/completed/shed counts, drop rates
    by kind, goodput, and the time-to-shed tail.  ``time_to_shed_*`` is NaN
    when nothing shed (same empty-sample semantics as the latency
    percentiles)."""
    jobs = result.jobs
    shed = [je for je in jobs if je.state is JobState.SHED]
    n_offered = len(jobs)
    out = {
        "n_offered": float(n_offered),
        "n_shed": float(len(shed)),
        "drop_rate": len(shed) / n_offered if n_offered else 0.0,
        # goodput two ways: completed fraction of offered load (what the
        # overload gates compare against the feasible fraction), and the
        # completion rate (identical to throughput_jobs_per_mcycle — named
        # here so SLO tables read naturally)
        "goodput_frac": len(done) / n_offered if n_offered else 0.0,
        "goodput_jobs_per_mcycle": (len(done) / (makespan / 1e6)
                                    if makespan > 0 else 0.0),
    }
    for kind in ("shallow", "deep"):
        offered_k = sum(1 for je in jobs if je.kind == kind)
        shed_k = sum(1 for je in shed if je.kind == kind)
        out[f"n_completed_{kind}"] = float(sum(1 for je in done if je.kind == kind))
        out[f"drop_rate_{kind}"] = shed_k / offered_k if offered_k else 0.0
    tts = _pct([je.time_to_shed for je in shed])
    out["time_to_shed_p50_cycles"] = tts["p50"]
    out["time_to_shed_p99_cycles"] = tts["p99"]
    return out


def _availability_block(result: ServeResult | ClusterResult,
                        done: list) -> dict[str, float]:
    """Shared fault/recovery keys.  ``wasted_mcycles`` sums the per-attempt
    ``wasted_cycles`` over EVERY record in the chip timelines (each attempt
    counted once — ``prior_wasted_cycles`` is a carry, not new waste);
    ``checkpoint_saved_mcycles`` is service a checkpoint resume did NOT have
    to redo."""
    primaries = result.jobs
    records = (
        [je for r in result.chip_results for je in r.jobs]
        if isinstance(result, ClusterResult) else primaries)
    return {
        "n_failed": float(sum(1 for je in primaries
                              if je.state is JobState.FAILED)),
        "n_retried_jobs": float(sum(1 for je in done if je.attempts > 1)),
        "retries_total": float(sum(je.attempts - 1 for je in primaries)),
        "wasted_mcycles": sum(je.wasted_cycles for je in records) / 1e6,
        "checkpoint_saved_mcycles": sum(je.checkpoint_cycles for je in done) / 1e6,
    }


def summarize(result: ServeResult | ClusterResult) -> dict[str, float]:
    """Flat metric dict (CSV-friendly).  Keys:

    latency_p50/p95/p99_cycles, latency_p99_ms — end-to-end turnaround;
    latency_p99_shallow/deep_cycles            — per-kind tail latency (what
                                                 the hetero/gang gates check);
    queue_p50/p95/p99_cycles                   — arrival → first dispatch;
    queue_max_shallow/deep_cycles              — worst queueing per kind
                                                 (deep = starvation indicator);
    makespan_mcycles, throughput_jobs_per_mcycle;
    util_mean, util_min, util_max              — busy/makespan per affiliation;
    fairness_jain                              — over per-tenant mean slowdown
                                                 (per-job when single-tenant);
    n_jobs, n_shallow, n_deep, n_preemptions, spill_restore_mcycles;
    n_offered, n_shed, n_completed_shallow/deep — admission accounting
                                                 (n_jobs counts completions;
                                                 offered = completed + shed);
    drop_rate, drop_rate_shallow/deep          — shed fraction of offered;
    goodput_frac, goodput_jobs_per_mcycle      — completed/offered, and the
                                                 completion rate;
    time_to_shed_p50/p99_cycles                — arrival → shed decision
                                                 (NaN when nothing shed);
    n_failed, n_retried_jobs, retries_total    — fault/recovery accounting;
    wasted_mcycles, checkpoint_saved_mcycles   — work lost to faults, and
                                                 service a checkpoint resume
                                                 did not redo.

    Empty percentile samples (a kind with zero completions, nothing shed)
    are NaN, never 0.0 — gates must check the ``n_completed_{kind}`` counts
    before comparing tails.

    A ``ClusterResult`` routes to ``summarize_cluster`` (fleet-level SLOs).
    """
    if isinstance(result, ClusterResult):
        return summarize_cluster(result)
    done = [je for je in result.jobs if je.state is JobState.DONE]
    lat = _pct([je.turnaround for je in done])
    queue = _pct([je.queueing_delay for je in done])
    mk = result.makespan
    busy = per_affiliation_busy(result)
    utils = [b / mk if mk > 0 else 0.0 for b in busy.values()]
    by_tenant = tenant_slowdowns(result)
    if len(by_tenant) > 1:
        slow = list(by_tenant.values())
    else:  # single tenant: fairness across individual jobs instead
        slow = [je.turnaround / je.service_cycles for je in done if je.service_cycles > 0]
    freq_hz = result.chip.freq_ghz * 1e9
    out = {
        "n_jobs": float(len(done)),
        "n_shallow": float(sum(1 for je in done if je.kind == "shallow")),
        "n_deep": float(sum(1 for je in done if je.kind == "deep")),
        "makespan_mcycles": mk / 1e6,
        "makespan_ms": mk / freq_hz * 1e3,
        "throughput_jobs_per_mcycle": len(done) / (mk / 1e6) if mk > 0 else 0.0,
        "util_mean": float(np.mean(utils)) if utils else 0.0,
        "util_min": float(np.min(utils)) if utils else 0.0,
        "util_max": float(np.max(utils)) if utils else 0.0,
        "fairness_jain": jain_fairness(slow),
        "n_preemptions": float(sum(je.n_preemptions for je in done)),
        "spill_restore_mcycles": sum(je.spill_restore_cycles for je in done) / 1e6,
    }
    out.update(_overload_block(result, done, mk))
    out.update(_availability_block(result, done))
    for k, v in lat.items():
        out[f"latency_{k}_cycles"] = v
    out["latency_p99_ms"] = lat["p99"] / freq_hz * 1e3
    for kind in ("shallow", "deep"):
        out[f"latency_p99_{kind}_cycles"] = _pct(
            [je.turnaround for je in done if je.kind == kind])["p99"]
    for k, v in queue.items():
        out[f"queue_{k}_cycles"] = v
    for kind, v in max_queueing_by_kind(result).items():
        out[f"queue_max_{kind}_cycles"] = v
    return out


def per_chip_utilization(result: ClusterResult) -> list[float]:
    """Busy fraction of the fleet makespan per chip (mean over affiliations)."""
    mk = result.makespan
    utils = []
    for r in result.chip_results:
        busy = per_affiliation_busy(r)
        utils.append(float(np.mean([b / mk if mk > 0 else 0.0 for b in busy.values()]))
                     if busy else 0.0)
    return utils


def per_chip_type_utilization(result: ClusterResult) -> dict[str, float]:
    """Mean busy fraction per chip *type* (e.g. on a mixed fleet: how loaded
    are the FLASH-FHE dies vs the CraterLake die?).  Keyed by chip name;
    kept out of the flat ``summarize_cluster`` dict so CSV columns stay
    uniform across fleets of different composition."""
    utils = per_chip_utilization(result)
    acc: dict[str, list[float]] = {}
    for chip, u in zip(result.chips, utils):
        acc.setdefault(chip.name, []).append(u)
    return {name: float(np.mean(v)) for name, v in acc.items()}


def summarize_cluster(result: ClusterResult) -> dict[str, float]:
    """Fleet-level SLOs: the merged-job latency/queueing view plus per-chip
    balance.  Keys beyond ``summarize``'s:

    n_chips;
    chip_util_mean/min/max                     — per-chip busy fraction;
    chip_util_imbalance                        — max − min (0 = perfectly even);
    fairness_jain_chips                        — Jain over per-chip busy cycles;
    n_cold_starts, cold_start_mcycles          — warm-set misses the router
                                                 charged into service demand;
    n_gang_jobs, gang_chips_mean               — deep jobs that gang-split, and
                                                 their mean width in chips;
    gang_link_bytes, gang_link_mcycles         — inter-chip exchange totals
                                                 (mcycles = per-chip link
                                                 stalls summed over members);
    peak_backlog_mcycles                       — max fleet-wide outstanding
                                                 routed demand over the run
                                                 (the bounded-queues
                                                 observable under overload);
    plus the admission block (n_offered, n_shed, n_completed_{kind},
    drop_rate[_kind], goodput_frac, goodput_jobs_per_mcycle,
    time_to_shed_p50/p99_cycles) shared with ``summarize``, and the
    availability block: the shared fault keys (n_failed, n_retried_jobs,
    retries_total, wasted_mcycles, checkpoint_saved_mcycles) plus
    downtime_mcycles / mttr_mcycles (NaN when nothing crashed) /
    availability (1 − downtime ÷ (n_chips × makespan)) and the injected
    fault counters (n_crashes, n_transients, n_slow_windows, n_retries,
    n_jobs_lost, n_retry_no_chip).

    Per-job numbers (latency, queueing, preemptions, spill) count each ganged
    job ONCE through its primary fragment — fragments share completion times
    by the lockstep invariant, so nothing is lost.  Per-chip numbers (busy
    cycles, utilization) naturally include every fragment's segments.

    Every latency/queueing/fairness number is computed from the union of the
    per-chip ``ServeResult`` timelines — the property suite asserts this merge
    identity directly.
    """
    done = [je for je in result.jobs if je.state is JobState.DONE]
    lat = _pct([je.turnaround for je in done])
    queue = _pct([je.queueing_delay for je in done])
    mk = result.makespan
    chip_utils = per_chip_utilization(result)
    chip_busy = [sum(per_affiliation_busy(r).values()) for r in result.chip_results]
    by_tenant = tenant_slowdowns(result)
    if len(by_tenant) > 1:
        slow = list(by_tenant.values())
    else:
        slow = [je.turnaround / je.service_cycles for je in done if je.service_cycles > 0]
    freq_hz = result.chip.freq_ghz * 1e9
    out = {
        "n_chips": float(result.n_chips),
        "n_jobs": float(len(done)),
        "n_shallow": float(sum(1 for je in done if je.kind == "shallow")),
        "n_deep": float(sum(1 for je in done if je.kind == "deep")),
        "makespan_mcycles": mk / 1e6,
        "makespan_ms": mk / freq_hz * 1e3,
        "throughput_jobs_per_mcycle": len(done) / (mk / 1e6) if mk > 0 else 0.0,
        "chip_util_mean": float(np.mean(chip_utils)) if chip_utils else 0.0,
        "chip_util_min": float(np.min(chip_utils)) if chip_utils else 0.0,
        "chip_util_max": float(np.max(chip_utils)) if chip_utils else 0.0,
        "chip_util_imbalance": (float(np.max(chip_utils) - np.min(chip_utils))
                                if chip_utils else 0.0),
        "fairness_jain": jain_fairness(slow),
        "fairness_jain_chips": jain_fairness(chip_busy),
        "n_preemptions": float(sum(je.n_preemptions for je in done)),
        "spill_restore_mcycles": sum(je.spill_restore_cycles for je in done) / 1e6,
        "n_cold_starts": float(sum(1 for je in done if je.cold_start_cycles > 0)),
        "cold_start_mcycles": sum(je.cold_start_cycles for je in done) / 1e6,
        "peak_backlog_mcycles": result.peak_backlog_cycles / 1e6,
    }
    out.update(_overload_block(result, done, mk))
    out.update(_availability_block(result, done))
    # availability under faults: per-chip downtime integrates the [crash,
    # recover) windows; MTTR is the mean window (NaN when nothing crashed,
    # same empty-sample semantics as the latency percentiles)
    windows = [hi - lo for ws in result.downtime.values() for lo, hi in ws]
    total_down = sum(windows)
    out["downtime_mcycles"] = total_down / 1e6
    out["mttr_mcycles"] = float(np.mean(windows)) / 1e6 if windows else float("nan")
    out["availability"] = (1.0 - total_down / (result.n_chips * mk)
                           if mk > 0 else 1.0)
    fc = result.fault_counts
    for key in ("crashes", "transients", "slow_windows", "retries",
                "jobs_lost", "retry_no_chip"):
        out[f"n_{key}"] = float(fc.get(key, 0))
    ganged = [je for je in done if je.gang_size > 1]
    out["n_gang_jobs"] = float(len(ganged))
    out["gang_chips_mean"] = (float(np.mean([je.gang_size for je in ganged]))
                              if ganged else 0.0)
    out["gang_link_bytes"] = sum(je.link_bytes for je in ganged)
    out["gang_link_mcycles"] = sum(je.link_cycles * je.gang_size for je in ganged) / 1e6
    for k, v in lat.items():
        out[f"latency_{k}_cycles"] = v
    out["latency_p99_ms"] = lat["p99"] / freq_hz * 1e3
    for kind in ("shallow", "deep"):
        out[f"latency_p99_{kind}_cycles"] = _pct(
            [je.turnaround for je in done if je.kind == kind])["p99"]
    for k, v in queue.items():
        out[f"queue_{k}_cycles"] = v
    for kind, v in max_queueing_by_kind(result).items():
        out[f"queue_max_{kind}_cycles"] = v
    return out
