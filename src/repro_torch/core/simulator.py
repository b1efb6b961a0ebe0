"""Cycle-level performance model driven by planner instruction streams.

Throughput/bottleneck model (the standard analysis for these accelerators):
each instruction contributes work to one functional unit —

  NTT/INTT   2·limbs·N / ntt_lanes                (two four-step passes)
  BCONV      N·k·m / bconv_lanes                  (modular MACs)
  PMULT/…    limbs·N / modmul_lanes
  AUTO       limbs·N / modmul_lanes               (permutation datapath)
  LOAD_*     bytes through the cache model → HBM traffic

With a fused iNTT→BConv→NTT pipeline (FLASH-FHE, CraterLake) the units overlap,
so job time ≈ max over unit totals (+HBM).  Without fusion (F1+) intermediates
round-trip through memory: time ≈ sum of unit totals and every BCONV/NTT
boundary adds HBM traffic — this is the ">10× slower than expected" F1+
behaviour the paper cites.

Captured *software* traces additionally carry explicit STORE_WS/LOAD_WS
records when the staged key-switch dispatcher ran (one pair per stage
boundary); each costs its working set through HBM regardless of the chip,
because the round-trip happens between kernel launches.  Fused-pipeline
traces (``repro_torch.kernels.fusedks``) emit none — `tests/test_fusedks.py`
validates this accounting against both captured streams.

Hoisted-rotation traces (``planner.hoisted_rotations`` /
``ctx.rotate_hoisted_group``) are the other shape this model prices:
one ModUp (INTT + β·{PMULT, BCONV, NTT}) plus ONE STORE_WS/LOAD_WS pair of
β·ext limbs — the materialised hoisted digits round-tripping to the MAC
launches — followed by k per-rotation {LOAD_KSK, MAC, ModDown, PADD, 2×AUTO}
records.  No new instruction kinds: the amortisation shows up as k·β ext-NTT
records collapsing to β, which the `ntt` unit total directly rewards;
`tests/test_hoisting.py` validates planner/simulator parity for this shape.
"""

from __future__ import annotations

import dataclasses

from repro_torch.fhe.trace import Instr

from .cache import LruCache, MB
from .hardware import ChipConfig


@dataclasses.dataclass
class LaneSet:
    """Functional-unit widths a scheduler grants to one job.

    bconv_macs: the BConv unit is l_sub=60 *vector* pipelines, each as wide as
    the cluster datapath (256 lanes) — so one bootstrappable cluster sustains
    60·256 modular MACs/cycle.
    """

    ntt_lanes: int
    bconv_macs: int
    modmul_lanes: int
    label: str = ""
    coop_transpose: bool = False  # swift clusters joined a deep job (L3 traffic)


def lanes_deep(chip: ChipConfig) -> LaneSet:
    """Deep job: all bootstrappable clusters across affiliations (paper §4.2)."""
    nb = chip.n_bootstrappable
    return LaneSet(ntt_lanes=nb * 256, bconv_macs=nb * 60 * 256, modmul_lanes=nb * 512,
                   label=f"{chip.name}:deep({nb}×boot)")


TRANSPOSE_PORTS = 2048  # L3 transpose module port count (paper §4.1)


def lanes_deep_coop(chip: ChipConfig) -> LaneSet:
    """Beyond-paper (the paper's §7 future work): swift clusters join deep
    jobs.  Large-point NTTs decompose across boot+swift pipelines, at the cost
    of routing every (i)NTT's data through the L3 transpose (modelled as a
    dedicated unit with 2048 ports)."""
    nb, ns = chip.n_bootstrappable, chip.n_swift
    return LaneSet(ntt_lanes=nb * 256 + ns * 128, bconv_macs=nb * 60 * 256,
                   modmul_lanes=nb * 512 + ns * 256,
                   label=f"{chip.name}:deep-coop({nb}×boot+{ns}×swift)",
                   coop_transpose=True)


def lanes_shallow(chip: ChipConfig) -> LaneSet:
    """Shallow job: one affiliation.  The bootstrappable 2^8 circuit decomposes
    into two 2^7 pipelines (multi-exit), joining the two swift clusters: four
    128-lane pipelines."""
    if chip.multi_exit_ntt:
        ntt = 2 * 128 * 1 + chip.swift_per_aff * 128
        mm = 512 + chip.swift_per_aff * 256
    else:
        ntt = 256 * chip.bootstrappable_per_aff
        mm = 512 * chip.bootstrappable_per_aff
    return LaneSet(ntt_lanes=ntt, bconv_macs=60 * 256, modmul_lanes=mm,
                   label=f"{chip.name}:shallow(1 affiliation)")


def lanes_whole_chip(chip: ChipConfig) -> LaneSet:
    """Homogeneous baseline policy: every cluster on the one running job."""
    nb = chip.n_bootstrappable
    bconv = nb * 60 * 256 if chip.fused_keyswitch else nb * 512  # F1+: BConv on Mod M/A
    return LaneSet(ntt_lanes=nb * 256, bconv_macs=bconv,
                   modmul_lanes=nb * 512, label=f"{chip.name}:whole-chip")


@dataclasses.dataclass
class SimResult:
    cycles: float
    hbm_bytes: float
    unit_cycles: dict
    cache_hit_ratio: float
    instr_count: int
    freq_ghz: float | None = None  # set by finalize(); 1 GHz assumed otherwise

    def __post_init__(self):
        self._time_s: float | None = None

    @property
    def time_s(self) -> float:
        """Wall-clock seconds; computed lazily so a result that was never
        ``finalize``d still reads back (at the stored or default frequency)."""
        if self._time_s is None:
            self._time_s = self.cycles / ((self.freq_ghz or 1.0) * 1e9)
        return self._time_s

    def finalize(self, freq_ghz: float) -> "SimResult":
        self.freq_ghz = freq_ghz
        self._time_s = self.cycles / (freq_ghz * 1e9)
        return self


PIPE_LATENCY = 64  # fill/drain cycles per instruction (amortised)


def simulate_stream(
    instrs: list[Instr],
    chip: ChipConfig,
    lanes: LaneSet,
    cache: LruCache | None = None,
    cache_bytes: float | None = None,
    key_prefix: str = "",
    tracer=None,
    trace_pid: int | None = None,
) -> SimResult:
    """Run one job's instruction stream on the granted lanes.

    ``tracer`` (an ``repro_torch.obs.Tracer``) records one occupancy slice per
    instruction per functional unit it charges, with timestamps = cumulative
    unit cycles — a per-unit utilisation timeline, not a global schedule
    (units overlap freely in the fused pipeline).  Each call gets its own
    trace process (``trace_pid`` overrides) so successive sims — whose unit
    clocks all start at 0 — never interleave on one track.
    """
    if cache is None:
        cache = LruCache(cache_bytes if cache_bytes is not None else chip.total_cache_mb * MB)
    unit = {"ntt": 0.0, "bconv": 0.0, "modmul": 0.0, "hbm": 0.0, "transpose": 0.0}
    wb = chip.word_bytes
    hbm_bytes = 0.0
    ksk_counter: dict[str, int] = {}

    trace = tracer is not None and bool(tracer)
    if trace:
        pid = trace_pid if trace_pid is not None else tracer.new_process(
            f"sim {lanes.label or chip.name}")
        tids = {u: tracer.track(pid, u) for u in unit}
        hbm_cursor = 0.0

    for ins in instrs:
        if trace:
            before = dict(unit)
            hbm_before = hbm_bytes
        n, limbs = ins.n, ins.limbs
        # Fig-2 saturation: a ring of degree N cannot keep more than ~N/16
        # lanes busy (four-step data-distribution limit) — this is WHY adding
        # clusters beyond one affiliation doesn't help a shallow job, and why
        # FLASH-FHE schedules one shallow job per affiliation instead.
        eff = max(256, n // 16)
        if lanes.coop_transpose:
            # The four-step distribution limit assumes clusters exchange NTT
            # tiles point-to-point; coop mode routes every (i)NTT through the
            # L3 transpose module instead, which re-distributes tiles to any
            # lane — so the grant is not eff-capped, and the cost shows up as
            # the explicit ``transpose`` unit charge below.
            eff = n
        ntt_l = min(lanes.ntt_lanes, eff)
        mm_l = min(lanes.modmul_lanes, eff)
        if ins.op in ("NTT", "INTT"):
            unit["ntt"] += 2.0 * limbs * n / ntt_l + PIPE_LATENCY
            if lanes.coop_transpose:
                # cross-cluster routing of both four-step passes via L3
                unit["transpose"] += 2.0 * limbs * n / TRANSPOSE_PORTS
            if not chip.fused_keyswitch:
                # unfused: (i)NTT results round-trip through the scratchpad/HBM
                hbm_bytes += 2 * limbs * n * wb
        elif ins.op == "BCONV":
            m = ins.meta.get("dst", limbs)
            unit["bconv"] += float(n) * limbs * m / lanes.bconv_macs + PIPE_LATENCY
            if not chip.fused_keyswitch:
                hbm_bytes += (limbs + m) * n * wb
        elif ins.op in ("PMULT", "PADD", "PSUB", "AUTO"):
            if chip.fused_exit_mac and ins.meta.get("mac"):
                continue  # streams through the NTT-exit MAC arrays (area cost)
            unit["modmul"] += float(limbs) * n / mm_l + PIPE_LATENCY
        elif ins.op in ("LOAD_KSK", "LOAD_PT"):
            nbytes = float(limbs) * n * wb
            if ins.op == "LOAD_KSK" and chip.on_chip_keygen:
                nbytes *= 0.5  # the uniform half of each key is re-generated on chip
            key = f"{key_prefix}{ins.op}:{n}:{limbs}:{ins.meta.get('tag','')}"
            if ins.op == "LOAD_KSK":
                # distinct keys of the same shape rotate through a small id space
                # (relin + ~2√slots galois keys per workload)
                idx = ksk_counter.get(key, 0)
                ksk_counter[key] = (idx + 1) % max(1, ins.meta.get("n_keys", 8))
                key = f"{key}#{idx}"
            hbm_bytes += cache.access(key, nbytes)
        elif ins.op in ("STORE_WS", "LOAD_WS"):
            # staged-software dispatch boundary: the intermediate polynomial
            # round-trips through HBM-equivalent buffers between kernel
            # launches (the fused key-switch pipeline emits none of these).
            # On chips WITHOUT a fused key-switch pipeline the NTT/BCONV
            # branches above already charge the same round-trips implicitly,
            # so the explicit records only bill fused-pipeline chips.
            if chip.fused_keyswitch:
                hbm_bytes += float(limbs) * n * wb
        elif ins.op == "TOUCH_WS":
            # key-switch working set vs on-chip capacity (Fig 8 mechanism):
            # whatever doesn't fit spills to HBM and returns
            ws_bytes = float(limbs) * n * wb
            ksk_bytes = float(ins.meta.get("ksk_limbs", 0)) * n * wb
            spill = max(0.0, ws_bytes + ksk_bytes - cache.capacity)
            hbm_bytes += 2.0 * spill
        elif ins.op in ("MODRAISE", "BOOTSTRAP_BEGIN", "BOOTSTRAP_END", "KSKGEN"):
            continue
        else:
            raise ValueError(f"unknown instruction {ins.op}")
        if trace:
            for u in ("ntt", "bconv", "modmul", "transpose"):
                if unit[u] > before[u]:
                    tracer.complete(ins.op, before[u], unit[u], pid=pid,
                                    tid=tids[u], n=ins.n, limbs=ins.limbs)
            if hbm_bytes > hbm_before:
                dt = (hbm_bytes - hbm_before) / chip.hbm_bytes_per_cycle
                tracer.complete(ins.op, hbm_cursor, hbm_cursor + dt, pid=pid,
                                tid=tids["hbm"], bytes=hbm_bytes - hbm_before)
                hbm_cursor += dt

    unit["hbm"] = hbm_bytes / chip.hbm_bytes_per_cycle
    if chip.fused_keyswitch:
        cycles = max(unit.values())  # pipelined: bottleneck unit governs
    else:
        cycles = unit["ntt"] + unit["bconv"] + unit["modmul"] + unit["hbm"]
    return SimResult(
        cycles=cycles, hbm_bytes=hbm_bytes, unit_cycles=dict(unit),
        cache_hit_ratio=cache.hit_ratio, instr_count=len(instrs),
    ).finalize(chip.freq_ghz)
