"""Negacyclic NTT plans for RNS-CKKS.

The ring is Z_q[x]/(x^N + 1).  With psi a primitive 2N-th root of unity mod q and
w = psi^2, the negacyclic NTT is a twist by psi^i followed by a cyclic N-point NTT;
slot j of the result is the evaluation a(psi^(2j+1)) (natural order).

A plan holds, per limb, exactly the tables the radix-2 butterfly NTT needs —
the twist powers, the cyclic root powers and the Montgomery constants — and is
shared by the plain PyTorch version (``repro_torch.kernels.ntt.ref``) and the
CUDA kernel (``csrc/ntt.cu``).  Plans are tables (``kernels.tables``) per
(N, primes); all their arrays are host numpy, and ``repro_torch.kernels.ntt.ops``
moves them to a device once.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.kernels.tables import table

from . import modmath as mm


def _pow_table(w: int, n: int, q: int) -> np.ndarray:
    """[w^0, ..., w^(n-1)] mod q as uint64, via log-doubling."""
    t = np.ones(n, dtype=np.uint64)
    if n == 1:
        return t
    t[1] = w % q
    filled = 2
    step = np.uint64(w % q)
    qq = np.uint64(q)
    while filled < n:
        take = min(filled, n - filled)
        # two exact sub-2^62 steps: t[i]·w^(filled-1) then ·w
        block = (t[:take] * t[filled - 1]) % qq
        block = (block * step) % qq
        t[filled : filled + take] = block
        filled += take
    return t


def bit_reverse_indices(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


@dataclasses.dataclass(frozen=True, eq=False)
class NttPlan:
    """All tables for one ring degree N over one RNS prime chain."""

    n: int
    primes: tuple[int, ...]  # the limbs' moduli, in order
    qs: np.ndarray  # (L,) uint32
    qinv_neg: np.ndarray  # (L,) uint32
    r2: np.ndarray  # (L,) uint32
    w_pows: np.ndarray  # (L, N) uint64  powers of w
    winv_pows: np.ndarray  # (L, N)
    psi_pows: np.ndarray  # (L, N)  twist
    psiinv_ninv: np.ndarray  # (L, N)  psi^{-i}·N^{-1}

    @property
    def num_limbs(self) -> int:
        return len(self.qs)


@table("build_plan")
def build_plan(n: int, primes: tuple[int, ...]) -> NttPlan:
    assert n >= 2 and n & (n - 1) == 0, f"N={n} must be a power of two"
    L = len(primes)
    consts = mm.mont_constants_array(primes)
    w_pows = np.zeros((L, n), np.uint64)
    winv_pows = np.zeros((L, n), np.uint64)
    psi_pows = np.zeros((L, n), np.uint64)
    psiinv_ninv = np.zeros((L, n), np.uint64)
    for li, q in enumerate(primes):
        psi = mm.root_of_unity(2 * n, q)
        psi_inv = pow(psi, -1, q)
        w = psi * psi % q
        n_inv = pow(n, -1, q)
        w_pows[li] = _pow_table(w, n, q)
        winv_pows[li] = _pow_table(pow(w, -1, q), n, q)
        psi_pows[li] = _pow_table(psi, n, q)
        psiinv_ninv[li] = (_pow_table(psi_inv, n, q) * np.uint64(n_inv)) % np.uint64(q)
    return NttPlan(
        n=n,
        primes=tuple(int(q) for q in primes),
        qs=np.array(primes, np.uint32),
        qinv_neg=consts["qinv_neg"],
        r2=consts["r2"],
        w_pows=w_pows,
        winv_pows=winv_pows,
        psi_pows=psi_pows,
        psiinv_ninv=psiinv_ninv,
    )


_PER_LIMB_FIELDS = ("qs", "qinv_neg", "r2", "w_pows", "winv_pows", "psi_pows", "psiinv_ninv")


def subplan(n: int, primes: tuple[int, ...], idx: tuple[int, ...]) -> NttPlan:
    """A view of build_plan(n, primes) restricted to the limb subset ``idx``.

    Ciphertexts live on arbitrary sub-chains of the master prime chain (levels,
    key-switch digits, the special-modulus block); this selects the matching
    rows of every per-limb table.  ``fhe.poly.plan_for`` keeps each one — the
    set of distinct subsets during a workload is O(L·dnum).
    """
    base = build_plan(n, primes)
    sel = np.array(idx, np.int64)
    return dataclasses.replace(
        base,
        primes=tuple(base.primes[i] for i in idx),
        **{f: getattr(base, f)[sel] for f in _PER_LIMB_FIELDS},
    )


def galois_eval_perm(n: int, t: int) -> np.ndarray:
    """Permutation p with NTT(σ_t(a))[j] = NTT(a)[p[j]] (natural slot order).

    σ_t : a(x) → a(x^t), t odd.  Slot j evaluates at psi^(2j+1), so
    σ_t(a)(psi^(2j+1)) = a(psi^(t(2j+1))) = slot ((t(2j+1) mod 2N) - 1)/2 of a.
    """
    assert t % 2 == 1
    j = np.arange(n, dtype=np.int64)
    src = ((t * (2 * j + 1)) % (2 * n) - 1) // 2
    return src.astype(np.int32)
