"""RNS (residue number system) helpers: CRT reconstruction and BConv table builders.

All functions here are host-side Python-int exact computations producing small
numpy tables; the heavy per-coefficient work happens in repro_torch.kernels.
"""

from __future__ import annotations

import functools

import numpy as np


def product(primes) -> int:
    out = 1
    for p in primes:
        out *= int(p)
    return out


@functools.lru_cache(maxsize=512)
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


def to_rns(values: np.ndarray, primes) -> np.ndarray:
    """Signed integer coefficients (object/int64) → (k, N) uint32 residues."""
    out = np.zeros((len(primes), values.shape[-1]), np.uint32)
    for i, p in enumerate(primes):
        p = int(p)
        r = np.mod(values.astype(object), p)  # python % is non-negative
        out[i] = np.array([int(v) for v in r], np.uint32)
    return out


def to_rns_i64(values: np.ndarray, primes) -> np.ndarray:
    """Fast path for int64-range coefficients."""
    v = values.astype(np.int64)
    out = np.zeros((len(primes), v.shape[-1]), np.uint32)
    for i, p in enumerate(primes):
        out[i] = np.mod(v, np.int64(p)).astype(np.uint32)
    return out
