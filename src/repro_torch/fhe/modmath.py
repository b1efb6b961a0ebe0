"""Host-side number theory for RNS-CKKS (Python ints and numpy).

NTT-friendly primes (q ≡ 1 mod 2^(log2N+1)), roots of unity and the per-prime
Montgomery constants (R = 2^32, q < 2^31) that the CUDA kernels use.  The
element-wise arithmetic itself lives in the kernels (``csrc/montgomery.cuh``)
and in their plain PyTorch versions, which compute in int64.
"""

from __future__ import annotations

import functools

import numpy as np

U32_MOD = 1 << 32

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)  # deterministic < 3.3e24


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def gen_ntt_primes(nbits: int, count: int, two_n: int, skip: tuple[int, ...] = ()) -> list[int]:
    """``count`` primes of ~``nbits`` bits with q ≡ 1 (mod two_n), descending from 2^nbits.

    ``two_n`` should be 2N for the largest supported ring degree so the same primes work
    for every smaller power-of-two ring.
    """
    assert nbits < 31, "u32 Montgomery path requires q < 2^31"
    out: list[int] = []
    q = (1 << nbits) + 1
    # descend over the arithmetic progression 1 mod two_n
    q -= (q - 1) % two_n
    while len(out) < count:
        if q < (1 << (nbits - 1)):
            raise ValueError(f"not enough {nbits}-bit NTT primes for 2N={two_n}")
        if q not in skip and is_prime(q):
            out.append(q)
        q -= two_n
    return out


def find_primitive_root(q: int) -> int:
    """Smallest primitive root of prime q."""
    phi = q - 1
    factors = set()
    n = phi
    d = 2
    while d * d <= n:
        while n % d == 0:
            factors.add(d)
            n //= d
        d += 1
    if n > 1:
        factors.add(n)
    for g in range(2, q):
        if all(pow(g, phi // f, q) != 1 for f in factors):
            return g
    raise ValueError(f"no primitive root for {q}")


@functools.lru_cache(maxsize=None)
def root_of_unity(order: int, q: int) -> int:
    """A primitive ``order``-th root of unity mod prime q (order | q-1)."""
    assert (q - 1) % order == 0, f"{order} does not divide {q}-1"
    g = find_primitive_root(q)
    w = pow(g, (q - 1) // order, q)
    assert pow(w, order, q) == 1 and pow(w, order // 2, q) == q - 1
    return w


class MontConstants:
    """Per-prime Montgomery constants (R = 2^32).

    ``qinv_neg`` is a full 32-bit value, often ≥ 2^31: it reaches a kernel as
    a uint32 bit pattern (``mont_constants_array``), never through a signed cast.
    """

    __slots__ = ("q", "qinv_neg", "r1", "r2")

    def __init__(self, q: int):
        assert q % 2 == 1 and q < (1 << 31)
        self.q = q
        self.qinv_neg = (-pow(q, -1, U32_MOD)) % U32_MOD  # -q^{-1} mod 2^32
        self.r1 = U32_MOD % q  # R mod q   (Montgomery form of 1)
        self.r2 = (U32_MOD * U32_MOD) % q  # R^2 mod q (to_mont multiplier)


def mont_constants_array(qs) -> dict[str, np.ndarray]:
    cs = [MontConstants(int(q)) for q in qs]
    return {
        "q": np.array([c.q for c in cs], np.uint32),
        "qinv_neg": np.array([c.qinv_neg for c in cs], np.uint32),
        "r1": np.array([c.r1 for c in cs], np.uint32),
        "r2": np.array([c.r2 for c in cs], np.uint32),
    }
