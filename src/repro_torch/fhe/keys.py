"""Key generation: secret/public keys and hybrid key-switching keys.

Hybrid KSK layout (Han–Ki / Lattigo convention): the chain q_0..q_L is
partitioned into dnum digits of ≤ α consecutive primes.  The key for digit j
encrypts  P·F_j·s'  under s over the extended basis Q∪P, where
F_j = Q̂_j·[Q̂_j^{-1}]_{Q_j}  satisfies  F_j ≡ 1 (mod q∈D_j), ≡ 0 (mod q∉D_j).
Level restriction is pure limb-dropping — the congruences hold per limb.

Every random draw is the reference package's, from the same numpy seeds, so
the same params and seed give bit-identical keys.  Key tensors live on the
``device`` they are generated for ("cuda" unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.modops import ops as mo

from . import poly, trace
from .params import CkksParams


@dataclasses.dataclass
class SecretKey:
    s_coeff: np.ndarray  # (N,) int64 ternary
    s_eval: torch.Tensor  # (L+1+α, N) int32, eval domain over the master chain


@dataclasses.dataclass
class PublicKey:
    b: torch.Tensor  # (L+1, N) eval domain over Q
    a: torch.Tensor


@dataclasses.dataclass
class SwitchingKey:
    """(dnum, 2, L+1+α, N) int32 — eval domain over the full extended basis."""

    k: torch.Tensor

    @property
    def nbytes(self) -> int:
        return self.k.numel() * 4


@dataclasses.dataclass
class KeySet:
    sk: SecretKey
    pk: PublicKey
    rlk: SwitchingKey
    gks: dict[int, SwitchingKey] = dataclasses.field(default_factory=dict)  # galois element t → key for σ_t(s) → s
    # (t, level) → σ_t^{-1}-pre-permuted level-restricted key, filled lazily by
    # ``keyswitch.hoisted_ksk`` — a keygen-time precompute for hoisted rotations
    hoist_cache: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.sk.s_eval.device

    def galois(self, t: int) -> SwitchingKey:
        if t not in self.gks:
            raise KeyError(f"galois key for t={t} not generated")
        return self.gks[t]


def _uniform_rns(rng: np.random.Generator, primes, n: int) -> np.ndarray:
    out = np.empty((len(primes), n), np.uint32)
    for i, p in enumerate(primes):
        out[i] = rng.integers(0, int(p), size=n, dtype=np.uint64).astype(np.uint32)
    return out


def _err_scale(params: CkksParams) -> int:
    """Error multiplier for key material: BGV keys carry t·e errors (message in
    the low-order bits), CKKS keys plain e."""
    return int(params.plain_modulus) if params.plain_modulus is not None else 1


def keygen(params: CkksParams, seed: int = 0, h: int | None = None, device="cuda") -> SecretKey:
    rng = np.random.default_rng(seed)
    if h is None:
        h = min(192, params.n // 4)
    s = poly.sample_ternary(rng, params.n, h)
    all_primes = params.all_primes
    s_rns = poly.residues(poly.to_rns_signed(s, all_primes), device)
    s_eval = poly.to_eval(s_rns, params, tuple(range(len(all_primes))))
    return SecretKey(s_coeff=s, s_eval=s_eval)


def pkgen(params: CkksParams, sk: SecretKey, seed: int = 1) -> PublicKey:
    rng = np.random.default_rng(seed)
    qp = params.q_primes
    dev = sk.s_eval.device
    idx = poly.q_idx(params, params.L)
    a = poly.residues(_uniform_rns(rng, qp, params.n), dev)
    e_coeff = _err_scale(params) * poly.sample_gaussian(rng, params.n)
    e = poly.to_eval(poly.residues(poly.to_rns_signed(e_coeff, qp), dev), params, idx)
    s_q = sk.s_eval[: params.L + 1]
    b = mo.pointwise_submod(e, mo.pointwise_mulmod(a, s_q, qp), qp)
    return PublicKey(b=b, a=a)


def kskgen(params: CkksParams, sk: SecretKey, s_prime_eval: torch.Tensor, seed: int) -> SwitchingKey:
    """Key switching s' → s.  s_prime_eval: (L+1+α, N) over the master chain."""
    rng = np.random.default_rng(seed)
    all_primes = params.all_primes
    dev = sk.s_eval.device
    n = params.n
    L = params.L
    next_ = len(all_primes)
    idx_full = tuple(range(next_))
    P = 1
    for p in params.p_primes:
        P *= int(p)
    Q = 1
    for i in range(L + 1):
        Q *= int(all_primes[i])

    dnum = params.num_digits
    out = torch.empty((dnum, 2, next_, n), dtype=torch.int32, device=dev)
    for j in range(dnum):
        Qj = 1
        for i in params.digit(j):
            Qj *= int(all_primes[i])
        Qhat = Q // Qj
        Fj = Qhat * pow(Qhat, -1, Qj)  # ≡ 1 mod Q_j, ≡ 0 mod q∉D_j
        pfj = np.array([P * Fj % int(p) for p in all_primes], np.uint32)

        a = poly.residues(_uniform_rns(rng, all_primes, n), dev)
        e_coeff = _err_scale(params) * poly.sample_gaussian(rng, n)
        e = poly.to_eval(poly.residues(poly.to_rns_signed(e_coeff, all_primes), dev), params, idx_full)
        # b = -a·s + e + PFj·s'  (eval domain, per limb)
        asq = mo.pointwise_mulmod(a, sk.s_eval, all_primes)
        pf = mo.pointwise_mulmod(s_prime_eval, poly.residues(pfj, dev)[:, None].expand(next_, n), all_primes)
        out[j, 0] = mo.pointwise_submod(mo.pointwise_addmod(e, pf, all_primes), asq, all_primes)
        out[j, 1] = a
    trace.record("KSKGEN", n, dnum * 2 * next_)
    return SwitchingKey(k=out)


def relin_keygen(params: CkksParams, sk: SecretKey, seed: int = 2) -> SwitchingKey:
    s2 = mo.pointwise_mulmod(sk.s_eval, sk.s_eval, params.all_primes)
    return kskgen(params, sk, s2, seed)


def galois_keygen(params: CkksParams, sk: SecretKey, t: int, seed: int = 3) -> SwitchingKey:
    s_t = poly.automorphism_eval(sk.s_eval, params.n, t)
    return kskgen(params, sk, s_t, seed + t)


def galois_elements(params: CkksParams, rotations: tuple[int, ...] = (),
                    conjugate: bool = False) -> tuple[int, ...]:
    """Deduplicated Galois elements a rotation set needs keys for.

    Rotations congruent mod ``slots`` share one element, so precomputing this
    union (e.g. over every BSGS plan of a context) keeps keygen from
    over-generating switching keys."""
    ts = {pow(5, r % params.slots, 2 * params.n) for r in rotations if r % params.slots}
    if conjugate:
        ts.add(2 * params.n - 1)
    return tuple(sorted(ts))


def full_keyset(params: CkksParams, seed: int = 0, rotations: tuple[int, ...] = (), conjugate: bool = False,
                h: int | None = None, device="cuda") -> KeySet:
    """Generate sk/pk/rlk plus exactly one Galois key per needed element, on ``device``."""
    sk = keygen(params, seed, h=h, device=device)
    pk = pkgen(params, sk, seed + 1)
    rlk = relin_keygen(params, sk, seed + 2)
    gks = {t: galois_keygen(params, sk, t, seed + 100) for t in galois_elements(params, rotations, conjugate)}
    return KeySet(sk=sk, pk=pk, rlk=rlk, gks=gks)
