"""Hardware models: FLASH-FHE chip parameters + baseline accelerator configs.

Everything the cycle-level simulator (repro_torch.core.simulator) needs is declared
here as data, so baseline accelerators (CraterLake, F1+) are just different
``ChipConfig`` instances — their speed differences *emerge* from architecture
(cluster inventory, cache volume, fused key-switch pipeline, scheduling policy)
rather than being hard-coded, mirroring how the paper attributes its gains.

Area/power tables reproduce the paper's Table 3 and Fig. 13 breakdowns.
"""

from __future__ import annotations

import dataclasses

MB = 1 << 20
GB = 1 << 30


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """One computation cluster's pipeline shape."""

    kind: str  # "bootstrappable" | "swift"
    ntt_points: int  # R-point (i)NTT circuit width (256 or 128)
    max_n: int  # largest ring degree the pipeline natively supports
    has_bconv: bool
    bconv_lanes: int = 0  # l_sub parallel modular-mul pipelines
    modmul_lanes: int = 256  # pointwise Mod M/A datapath width


BOOTSTRAPPABLE = ClusterSpec("bootstrappable", 256, 1 << 16, True, bconv_lanes=60, modmul_lanes=512)
SWIFT = ClusterSpec("swift", 128, 1 << 14, False, modmul_lanes=256)


@dataclasses.dataclass(frozen=True)
class ChipConfig:
    name: str
    freq_ghz: float
    n_affiliations: int  # cluster-affiliation count (FLASH-FHE: 8)
    bootstrappable_per_aff: int
    swift_per_aff: int
    l1_mb_per_aff: float  # shared L1 SRAM per affiliation
    total_cache_mb: float  # L1×affiliations + global L2
    hbm_gbps: float  # off-chip bandwidth (2× HBM2e = 1024 GB/s)
    fused_keyswitch: bool  # dedicated iNTT→BConv→NTT pipeline?
    multi_exit_ntt: bool  # bootstrappable circuit decomposable into small NTTs?
    multi_job: bool  # scheduler can co-run shallow jobs (1 per affiliation)?
    on_chip_keygen: bool = True  # real-time key generation (halves KSK traffic)
    fused_exit_mac: bool = False  # beyond-paper: ksk MACs at the NTT pipeline exit
    word_bytes: int = 4  # RNS limb word width in memory

    @property
    def n_bootstrappable(self) -> int:
        return self.n_affiliations * self.bootstrappable_per_aff

    @property
    def n_swift(self) -> int:
        return self.n_affiliations * self.swift_per_aff

    @property
    def l2_mb(self) -> float:
        return self.total_cache_mb - self.n_affiliations * self.l1_mb_per_aff

    @property
    def hbm_bytes_per_cycle(self) -> float:
        return self.hbm_gbps / self.freq_ghz  # GB/s over Gcycle/s


# --- FLASH-FHE (the paper, §4/§5): 8 affiliations × (1 bootstrappable + 2 swift),
#     320 MB total SRAM (8 MB L1 × 8 + 256 MB L2), 2×HBM2e, 1 GHz ---------------
FLASH_FHE = ChipConfig(
    name="flash-fhe", freq_ghz=1.0, n_affiliations=8,
    bootstrappable_per_aff=1, swift_per_aff=2,
    l1_mb_per_aff=8.0, total_cache_mb=320.0, hbm_gbps=1024.0,
    fused_keyswitch=True, multi_exit_ntt=True, multi_job=True,
)

# --- CraterLake (§6.1): 8 homogeneous 256-lane bootstrappable groups, 256 MB,
#     fused key-switch, single-job scheduling ----------------------------------
CRATERLAKE = ChipConfig(
    name="craterlake", freq_ghz=1.0, n_affiliations=8,
    bootstrappable_per_aff=1, swift_per_aff=0,
    l1_mb_per_aff=8.0, total_cache_mb=256.0, hbm_gbps=1024.0,
    fused_keyswitch=True, multi_exit_ntt=False, multi_job=False,
)

# --- F1+ (§6.1): 16 compute clusters with 256 lanes, 256 MB scratchpad, but an
#     UNOPTIMISED key-switch (no fused pipeline ⇒ intermediate polys round-trip
#     through memory), single-job ----------------------------------------------
F1PLUS = ChipConfig(
    name="f1plus", freq_ghz=1.0, n_affiliations=32,  # 32 clusters × 256 lanes (§6.1)
    bootstrappable_per_aff=1, swift_per_aff=0,
    l1_mb_per_aff=1.0, total_cache_mb=256.0, hbm_gbps=1024.0,
    fused_keyswitch=False, multi_exit_ntt=False, multi_job=False,
    on_chip_keygen=False,  # F1 predates real-time key generation
)

# Beyond-paper variant for the §Perf hillclimb: MAC units at the (i)NTT
# pipeline exits absorb the key-switch inner products (same philosophy as the
# paper's fused iNTT→BConv→NTT pipeline, one stage further).
import dataclasses as _dc

FLASH_FHE_FUSED_MAC = _dc.replace(FLASH_FHE, name="flash-fhe-fmac", fused_exit_mac=True)

CHIPS = {c.name: c for c in (FLASH_FHE, CRATERLAKE, F1PLUS, FLASH_FHE_FUSED_MAC)}


# ---------------------------------------------------------------------------
# Area model (paper Table 3, mm²) and power model (Fig 13, W)
# ---------------------------------------------------------------------------

AREA_TABLE_MM2 = {
    # component: (7nm, 14/12nm)
    "ntt_128pt": (0.50, 1.42),
    "modmul_add_swift": (0.31, 0.91),
    "swift_clusters_total": (12.96, 37.28),  # 16×NTT + 16×Mod M/A
    "ntt_256pt": (0.99, 2.81),
    "modmul_add_boot": (0.63, 1.81),
    "bconv": (0.69, 2.01),
    "bootstrappable_clusters_total": (55.09, 160.56),
    "key_generation": (0.73, 3.00),
    "automorphism": (3.21, 9.23),
    "transpose": (0.13, 0.37),
    "srams_in_clusters": (19.50, 96.6),
    "hierarchical_cache": (58.00, 185.5),
    "hbm2e_x2": (29.80, 29.80),
    "total": (178.69, 519.34),
}

BASELINE_AREAS_MM2 = {  # §6.1
    "f1plus": 636.0,  # 14/12nm
    "craterlake": 472.0,  # 14/12nm
    "ark": 418.0,  # 7nm
    "sharp": 179.0,  # 7nm
}

POWER_BREAKDOWN_W = {
    # Fig 13: total 152.11 W; bootstrappable clusters 60%, swift 11%
    "bootstrappable_clusters": 91.3,
    "swift_clusters": 16.7,
    "transpose": 2.1,
    "l1_cache": 12.4,
    "l2_cache": 18.6,
    "hbm": 11.0,
}
TOTAL_POWER_W = 152.11
BASELINE_POWER_W = {"craterlake": 317.0, "ark": 281.3, "bts": 163.2}


def area_total_mm2(node: str = "14nm") -> float:
    col = 0 if node == "7nm" else 1
    return AREA_TABLE_MM2["total"][col]


def swift_logic_fraction(node: str = "14nm") -> float:
    """Paper claim: swift-cluster logic < 7% of total chip area."""
    col = 0 if node == "7nm" else 1
    return AREA_TABLE_MM2["swift_clusters_total"][col] / AREA_TABLE_MM2["total"][col]


# ---------------------------------------------------------------------------
# H100 roofline constants (the port's runtime target: one H100 SXM5 80 GB)
# ---------------------------------------------------------------------------

# NVIDIA H100 Tensor Core GPU datasheet, SXM5 column, at the 700 W power
# limit.  Dense rates: the datasheet's sparse figures are twice these.
H100_PEAK_FLOPS_BF16 = 989e12  # FLOP/s per card, bf16 tensor cores, dense; a multiply-add counts 2
H100_HBM_BPS = 3.35e12  # bytes/s per card, HBM3 (chip_smoke.PEAK_BYTES_PER_S)
# NVLink 4: 900 GB/s per card over 18 links, counting both directions; one
# link carries 25 GB/s each way.  The roofline's collective term divides by
# one link's rate in one direction, as the reference's ICI figure is per link.
H100_NVLINK_BPS = 25e9  # bytes/s per link, per direction
