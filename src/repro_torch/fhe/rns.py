"""RNS (residue number system) helpers: CRT reconstruction and BConv table builders.

All functions here are host-side Python-int exact computations producing small
numpy tables; the heavy per-coefficient work happens in repro_torch.kernels.
``digit_tables`` and ``moddown_tables`` are the one source of a key-switch's
B̂⁻¹, W and P⁻¹: the staged pipeline, the plain versions of the fused kernels
and the kernels' device tables all read them.
"""

from __future__ import annotations

import numpy as np

from repro_torch.kernels.tables import table

from .params import CkksParams


def product(primes) -> int:
    out = 1
    for p in primes:
        out *= int(p)
    return out


@table("bconv_tables")
def bconv_tables(src: tuple[int, ...], dst: tuple[int, ...]):
    """Tables for Conv_{src→dst}.

    Returns (bhat_inv, w):
      bhat_inv[i] = [ (B/b_i)^{-1} ]_{b_i}            — (k,) uint32 (pre-scale)
      w[i, j]     = (B/b_i) mod c_j                   — (k, m) uint32
    """
    B = product(src)
    bhat_inv = np.array([pow(B // b, -1, b) for b in src], np.uint32)
    w = np.array([[(B // b) % c for c in dst] for b in src], np.uint32)
    return bhat_inv, w


@table("digit_tables")
def digit_tables(params: CkksParams, level: int, j: int):
    """Digit j of a key-switch at ``level``: (its q limbs, their primes, the
    extended basis q_0..q_level ∪ P, bhat_inv, w) — ``bconv_tables`` of the
    digit's primes to the extended basis."""
    limbs = tuple(i for i in params.digit(j) if i <= level)
    src = tuple(params.q_primes[i] for i in limbs)
    dst = params.q_primes[: level + 1] + params.p_primes
    return (limbs, src, dst, *bconv_tables(src, dst))


@table("moddown_tables")
def moddown_tables(params: CkksParams, level: int):
    """ModDown at ``level``: (p primes, q primes, bhat_inv, w, pinv) —
    ``bconv_tables`` of P to q_0..q_level and pinv[e] = [P⁻¹]_{q_e}, uint32."""
    p_primes, q_primes = params.p_primes, params.q_primes[: level + 1]
    P = product(p_primes)
    pinv = np.array([pow(P % q, -1, q) for q in q_primes], np.uint32)
    return (p_primes, q_primes, *bconv_tables(p_primes, q_primes), pinv)


def crt_reconstruct_centered(residues: np.ndarray, primes, max_limbs: int = 4) -> np.ndarray:
    """Centered CRT over the first ≤ max_limbs primes (object-int array).

    residues: (k, N) uint array.  Valid when the true centered value fits in
    ±Π_{i<k'} q_i / 2 — guaranteed for decode-scale magnitudes.
    """
    k = min(len(primes), max_limbs)
    ps = [int(p) for p in primes[:k]]
    Q = product(ps)
    # m = Σ r_i · Q̂_i · [Q̂_i^{-1}]_{q_i}  mod Q, vectorised with object ints
    acc = np.zeros(residues.shape[1], dtype=object)
    for i, p in enumerate(ps):
        qhat = Q // p
        coef = qhat * pow(qhat, -1, p)
        acc = acc + residues[i].astype(object) * coef
    acc = acc % Q
    return np.where(acc > Q // 2, acc - Q, acc)


def to_rns_i64(values: np.ndarray, primes) -> np.ndarray:
    """Int64-range coefficients → (k, N) uint32 residues."""
    v = values.astype(np.int64)
    out = np.zeros((len(primes), v.shape[-1]), np.uint32)
    for i, p in enumerate(primes):
        out[i] = np.mod(v, np.int64(p)).astype(np.uint32)
    return out
