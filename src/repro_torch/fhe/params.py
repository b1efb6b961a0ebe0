"""CKKS parameter sets — the paper's crypto-parameter policy (§3.2, §6.1).

Shallow workloads: N ≤ 2^14, small L, 80-bit security (paper §6.3).
Deep workloads:   2^15 ≤ N ≤ 2^16, large L, hybrid key-switching, 128-bit.

We use ≤30-bit NTT-friendly primes (q ≡ 1 mod 2N_max) so the u32 Montgomery
path of the CUDA kernels stays exact.  Word-size assumption change: the paper's deep
workloads use 28-bit scale words; with uniform 30-bit words the L=57/L=41 chains
exceed the 128-bit logPQ budget by ~10-60%, so those two presets keep the paper's
*limb counts* (which drive the performance model) and carry check=False; logreg
and lstm fit the budget exactly with dnum=2.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from . import modmath as mm

# Paper Table 2: max log PQ at 128-bit security per log2(N).
MAX_LOGPQ_128 = {12: 101, 13: 192, 14: 399, 15: 816, 16: 1550, 17: 3125}
# 80-bit budget (paper §6.3 uses 80-bit for shallow): N/logPQ heuristic × 128/80.
MAX_LOGPQ_80 = {k: int(v * 1.6) for k, v in MAX_LOGPQ_128.items()}

PRIME_BITS = 30  # word size of the u32 Montgomery path (q < 2^31)
DEFAULT_SCALE_BITS = 30  # ≈ prime size so rescale keeps the scale stationary


@dataclasses.dataclass(frozen=True)
class CkksParams:
    """One CKKS parameter set over a shared RNS prime chain.

    q_primes[0..L] are the ciphertext chain (level ℓ uses q_primes[:ℓ+1]);
    p_primes[0..α-1] are the special (key) moduli; ⌈(L+1)/α⌉ digits of ≤ α
    primes each cover the chain for hybrid key-switching.
    """

    n: int
    L: int  # multiplicative depth of a fresh ciphertext (levels L..0)
    dnum: int
    scale_bits: int
    q_primes: tuple[int, ...]  # len L+1
    p_primes: tuple[int, ...]  # len alpha
    security_bits: int = 128
    # BGV plaintext modulus t, or None for CKKS.  Restricted to powers of two
    # dividing 2·N_MAX = 2^17: every master-chain prime satisfies q ≡ 1
    # (mod 2^17), hence q ≡ 1 (mod t) and P ≡ 1 (mod t) — modulus switching
    # and key switching then preserve the message mod t with no scale-factor
    # bookkeeping (see the BGV scheme of the reference package).
    plain_modulus: int | None = None

    def __post_init__(self):
        t = self.plain_modulus
        if t is not None:
            if t < 2 or (t & (t - 1)) or (2 * N_MAX) % t:
                raise ValueError(
                    f"plain_modulus {t} must be a power of two dividing 2^17 "
                    "(so every chain prime is ≡ 1 mod t)"
                )

    @property
    def scheme(self) -> str:
        """Which scheme these params encode for: "bgv" iff a plaintext modulus
        is set, "ckks" otherwise."""
        return "bgv" if self.plain_modulus is not None else "ckks"

    @property
    def alpha(self) -> int:
        return len(self.p_primes)

    @property
    def slots(self) -> int:
        return self.n // 2

    @property
    def scale(self) -> float:
        return float(2**self.scale_bits)

    @property
    def all_primes(self) -> tuple[int, ...]:
        """q chain followed by the special block — the master kernel-plan chain."""
        return self.q_primes + self.p_primes

    @property
    def log_pq(self) -> float:
        return float(sum(np.log2(np.array(self.all_primes, dtype=np.float64))))

    def digit(self, j: int) -> tuple[int, ...]:
        """Indices (into q_primes) of hybrid key-switching digit j."""
        a = self.alpha
        return tuple(range(j * a, min((j + 1) * a, self.L + 1)))

    @property
    def num_digits(self) -> int:
        return -(-(self.L + 1) // self.alpha)

    def beta(self, level: int) -> int:
        """Number of key-switch digits active at ``level``."""
        return -(-(level + 1) // self.alpha)

    def is_shallow(self) -> bool:
        """Paper §3.2: shallow ⇔ N ≤ 2^14 (no bootstrapping budget)."""
        return self.n <= 2**14

    def check_security(self) -> bool:
        logn = self.n.bit_length() - 1
        table = MAX_LOGPQ_80 if self.security_bits <= 80 else MAX_LOGPQ_128
        budget = table.get(logn)
        return budget is not None and self.log_pq <= budget


# The master ring degree all prime chains are NTT-friendly for.  Every plan for a
# smaller N reuses the same primes (q ≡ 1 mod 2^17 ⇒ ≡ 1 mod 2N for all N ≤ 2^16).
N_MAX = 1 << 16


@functools.lru_cache(maxsize=8)
def master_chain(count: int, nbits: int = PRIME_BITS) -> tuple[int, ...]:
    return tuple(mm.gen_ntt_primes(nbits, count, 2 * N_MAX))


def make_params(
    n: int,
    L: int,
    dnum: int = 1,
    scale_bits: int = DEFAULT_SCALE_BITS,
    security_bits: int = 128,
    check_security: bool = True,
    plain_modulus: int | None = None,
) -> CkksParams:
    """Build a parameter set: L+1 chain primes + α = ⌈(L+1)/dnum⌉ special primes.

    ``plain_modulus`` selects BGV over the same RNS tower (see
    ``CkksParams.scheme``); leave it ``None`` for CKKS.
    """
    alpha = -(-(L + 1) // dnum)
    chain = master_chain(L + 1 + alpha)
    p = CkksParams(
        n=n,
        L=L,
        dnum=dnum,
        scale_bits=scale_bits,
        q_primes=chain[: L + 1],
        p_primes=chain[L + 1 : L + 1 + alpha],
        security_bits=security_bits,
        plain_modulus=plain_modulus,
    )
    if check_security and not p.check_security():
        raise ValueError(
            f"params N=2^{n.bit_length()-1} L={L} dnum={dnum}: "
            f"logPQ={p.log_pq:.0f} exceeds {security_bits}-bit budget"
        )
    return p


# ---------------------------------------------------------------------------
# Paper workload presets (§6.1).
# ---------------------------------------------------------------------------


def _preset(n_log2: int, L: int, dnum: int, kind: str, sec: int = 128, check: bool = True,
            t: int | None = None) -> dict:
    return dict(n=1 << n_log2, L=L, dnum=dnum, kind=kind, sec=sec, check=check,
                scheme="bgv" if t is not None else "ckks", t=t)


WORKLOAD_PRESETS: dict[str, dict] = {
    # --- shallow CKKS: 80-bit security (paper §6.3) ---
    "matmul": _preset(13, 2, 3, "shallow", sec=80),  # Fig 1a sweet spot N=2^13
    "dblookup": _preset(14, 8, 3, "shallow", sec=80),  # Fig 1b sweet spot N=2^14
    "lola_mnist_plain": _preset(13, 6, 3, "shallow", sec=80),  # §6.1: L=6
    "lola_mnist_enc": _preset(13, 6, 3, "shallow", sec=80),
    "lola_cifar_plain": _preset(13, 7, 4, "shallow", sec=80),  # §6.1: L=7
    # --- shallow BGV: exact integer workloads (APACHE-style mixed deployments).
    #     psi: private set intersection — depth-log equality circuits over
    #     binary-packed identifiers (t=2); exact_count: private aggregation
    #     with 16-bit exact counters (t=2^16).  Both ride swift clusters.
    "psi": _preset(13, 6, 3, "shallow", sec=80, t=2),
    "exact_count": _preset(13, 4, 3, "shallow", sec=80, t=1 << 16),
    # --- deep: 128-bit; L matches the paper so limb counts (what the perf model counts)
    #     match; the two check=False chains exceed the budget only because of
    #     our wider 30-bit words (see module docstring).
    "packed_bootstrap": _preset(16, 57, 1, "deep", check=False),
    "resnet20": _preset(16, 41, 1, "deep", check=False),
    "lstm": _preset(16, 13, 2, "deep"),
    "logreg": _preset(16, 33, 2, "deep"),
}

SHALLOW_WORKLOADS = tuple(k for k, v in WORKLOAD_PRESETS.items() if v["kind"] == "shallow")
DEEP_WORKLOADS = tuple(k for k, v in WORKLOAD_PRESETS.items() if v["kind"] == "deep")
BGV_WORKLOADS = tuple(k for k, v in WORKLOAD_PRESETS.items() if v["scheme"] == "bgv")


def workload_params(name: str) -> CkksParams:
    cfg = WORKLOAD_PRESETS[name]
    return make_params(
        cfg["n"], cfg["L"], cfg["dnum"], security_bits=cfg["sec"], check_security=cfg["check"],
        plain_modulus=cfg["t"],
    )


def workload_kind(name: str) -> str:
    return WORKLOAD_PRESETS[name]["kind"]


def workload_scheme(name: str) -> str:
    return WORKLOAD_PRESETS[name]["scheme"]
