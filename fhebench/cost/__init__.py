"""The frozen work count: the least time of each homomorphic operation on one H100.

An operation's least time is the larger of two terms, from its shape alone
(N, the level, and α = ⌈(L+1)/dnum⌉ special primes):

  * its HBM bytes ÷ 3.35e12 B/s: each input read once (ciphertexts,
    plaintexts, the switching key once), each output written once;
    intermediates do not count, so no fusion can make the count stale;
  * its integer operations at the fastest published rate that could carry
    them: 32-bit ALU work at 33.5e12 a second, and the products that a
    tensor-core formulation can carry (the NTT's butterflies and twists,
    BConv's products) at 1,979e12 int8 operations a second, one 32-bit
    product counted as 16 int8 multiply-adds of two operations each.  A
    product moved to the tensor cores still leaves its modular reduction
    (``REDC``) on the ALU; BConv reduces once per output.

The count is of the mathematics, not of any kernel: a fused and a staged
key-switch, a hoisted and a per-rotation group of the same rotations at the
same shapes, all count the same work.  Encoding plaintexts and copies between
host and card are not homomorphic operations and count nothing.  A job's least
time is the sum of its operations' least times.

The per-kernel bounds of PERF.md's kernel table stay with the port's smoke
script, which prints them; the tests hold this count to that table.
"""

from __future__ import annotations

import dataclasses

PEAK_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
PEAK_OPS_PER_S = 33.5e12  # 132 SMs × 128 integer lanes × 1.98 GHz
PEAK_INT8_OPS_PER_S = 1979e12  # int8 tensor cores, dense, a multiply-add counted as two
MONTMUL, MULMOD, ADDMOD = 8, 16, 3  # integer operations per Montgomery product, modular product, modular add
REDC = MONTMUL - 2  # a Montgomery product less its 32×32 product, which the tensor cores can take
INT8_PER_PRODUCT = 2 * 16  # 16 int8 multiply-adds of two operations each
WORD = 4  # bytes per residue


@dataclasses.dataclass(frozen=True)
class Work:
    """Bytes, ALU operations and int8 tensor-core operations of one operation."""

    nbytes: float = 0.0
    alu: float = 0.0
    int8: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.nbytes + other.nbytes, self.alu + other.alu, self.int8 + other.int8)

    def scaled(self, k: float) -> "Work":
        return Work(self.nbytes * k, self.alu * k, self.int8 * k)

    @property
    def seconds(self) -> float:
        """The least time: bytes at the memory rate, or operations at their rates, the larger."""
        return max(self.nbytes / PEAK_BYTES_PER_S, self.alu / PEAK_OPS_PER_S + self.int8 / PEAK_INT8_OPS_PER_S)


def _log2(n: int) -> int:
    return n.bit_length() - 1


# -- arithmetic of the pieces (no bytes: the whole operation counts those) ------


def ntt(n: int, rows: int) -> Work:
    """A forward or inverse negacyclic NTT of ``rows`` limbs: (n/2)·log n butterflies
    and n twist products a limb on the tensor cores, each reduced on the ALU, and
    two modular adds a butterfly."""
    products = rows * (n // 2 * _log2(n) + n)
    return Work(alu=products * REDC + rows * (n // 2 * _log2(n)) * 2 * ADDMOD, int8=products * INT8_PER_PRODUCT)


def bconv(n: int, k: int, m: int) -> Work:
    """Base conversion of k source limbs to m target limbs: the prescale of each
    source word, k·m·n products on the tensor cores, one reduction an output."""
    return Work(alu=k * n * MULMOD + m * n * MONTMUL, int8=k * m * n * INT8_PER_PRODUCT)


def pointwise(n: int, rows: int, products: int = 0, adds: int = 0) -> Work:
    return Work(alu=rows * n * (products * MULMOD + adds * ADDMOD))


def digits(level: int, alpha: int) -> list[int]:
    """Limbs of each key-switch digit at ``level``: α each, the last ragged."""
    limbs = level + 1
    return [min(alpha, limbs - j) for j in range(0, limbs, alpha)]


def _mod_up(n: int, level: int, alpha: int) -> Work:
    """INTT of the input, then each digit converted to the rest of the extended basis and NTT'd there."""
    l, m = level + 1, level + 1 + alpha
    w = ntt(n, l)
    for k in digits(level, alpha):
        w = w + bconv(n, k, m - k) + ntt(n, m - k)
    return w


def _mac(n: int, level: int, alpha: int) -> Work:
    """Two accumulators over the extended basis: β products each and β − 1 adds."""
    beta, m = len(digits(level, alpha)), level + 1 + alpha
    return pointwise(n, 2 * m, products=beta, adds=beta - 1)


def _mod_down(n: int, level: int, alpha: int) -> Work:
    """One accumulator divided by P: INTT of its α special limbs, BConv to the l
    ciphertext limbs, NTT there, subtract and multiply by P^{-1}."""
    l = level + 1
    return ntt(n, alpha) + bconv(n, alpha, l) + ntt(n, l) + pointwise(n, l, products=1, adds=1)


def _key_bytes(level: int, alpha: int, n: int) -> float:
    return len(digits(level, alpha)) * 2 * (level + 1 + alpha) * n * WORD


def key_switch(n: int, level: int, alpha: int) -> Work:
    """d ↦ (ks0, ks1): read d and the key once, write the pair."""
    l = level + 1
    arith = _mod_up(n, level, alpha) + _mac(n, level, alpha) + _mod_down(n, level, alpha).scaled(2)
    return arith + Work(nbytes=l * n * WORD + _key_bytes(level, alpha, n) + 2 * l * n * WORD)


def _rescale_arith(n: int, level: int) -> Work:
    """Both polynomials: INTT of the dropped limb, its centred re-embedding in the
    l − 1 others, NTT there, subtract and multiply by q_l^{-1}."""
    r = level  # limbs that remain
    one = ntt(n, 1) + pointwise(n, r, adds=1) + ntt(n, r) + pointwise(n, r, products=1, adds=1)
    return one.scaled(2)


def _ct(n: int, level: int) -> float:
    return 2 * (level + 1) * n * WORD


# -- whole operations -----------------------------------------------------------


def op(name: str, n: int, level: int, alpha: int, k: int = 1) -> Work:
    """The work of one homomorphic operation on ciphertexts at ``level``.

    mul, square: the tensor product, relinearisation and rescale.  mul_plain:
    by an evaluation-domain plaintext, no rescale; mul_plain_rescale: with it.
    rotate: one key-switched automorphism.  rotate_group: k rotations of one
    ciphertext, one ModUp shared (``k`` is the group's size).  add, negate,
    add_plain, rescale: as named.
    """
    l = level + 1
    pt = l * n * WORD
    if name in ("mul", "square"):
        products = 4 if name == "mul" else 3
        arith = (pointwise(n, l, products=products, adds=1) + key_switch(n, level, alpha)
                 + pointwise(n, 2 * l, adds=1) + _rescale_arith(n, level))
        inputs = _ct(n, level) * (2 if name == "mul" else 1) + _key_bytes(level, alpha, n)
        return Work(inputs + _ct(n, level - 1), arith.alu, arith.int8)
    if name == "mul_plain":
        return pointwise(n, 2 * l, products=1) + Work(nbytes=_ct(n, level) + pt + _ct(n, level))
    if name == "mul_plain_rescale":
        arith = pointwise(n, 2 * l, products=1) + _rescale_arith(n, level)
        return Work(_ct(n, level) + pt + _ct(n, level - 1), arith.alu, arith.int8)
    if name == "rescale":
        arith = _rescale_arith(n, level)
        return Work(_ct(n, level) + _ct(n, level - 1), arith.alu, arith.int8)
    if name == "add":
        return pointwise(n, 2 * l, adds=1) + Work(nbytes=3 * _ct(n, level))
    if name == "negate":
        return pointwise(n, 2 * l, adds=1) + Work(nbytes=2 * _ct(n, level))
    if name == "add_plain":
        return pointwise(n, l, adds=1) + Work(nbytes=3 * pt)
    if name == "rotate":
        arith = key_switch(n, level, alpha) + pointwise(n, l, adds=1)
        return Work(_ct(n, level) + _key_bytes(level, alpha, n) + _ct(n, level), arith.alu, arith.int8)
    if name == "rotate_group":
        each = _mac(n, level, alpha) + _mod_down(n, level, alpha).scaled(2) + pointwise(n, l, adds=1)
        arith = _mod_up(n, level, alpha) + each.scaled(k)
        nbytes = _ct(n, level) + k * (_key_bytes(level, alpha, n) + _ct(n, level))
        return Work(nbytes, arith.alu, arith.int8)
    raise KeyError(f"no work count for operation {name!r}")


def least_seconds(ops, n: int, alpha: int) -> float:
    """Σ over (name, level[, k]) of each operation's least time."""
    return sum(op(o[0], n, o[1], alpha, *o[2:]).seconds for o in ops)
