"""CKKS encoder: C^{N/2} ↔ R_q via the canonical embedding.

Slot ordering follows the standard generator-5 convention: slot j evaluates the
message polynomial at ζ^{5^j mod 2N} (ζ = e^{iπ/N}), with conjugate slots at the
negated exponents.  Under this ordering the Galois automorphism σ_{5^r} is a
cyclic left-rotation of the slot vector by r — which is what `ctx.rotate`
key-switches.

Both directions are O(N log N): the evaluation at all odd powers ζ^{2k+1}
(natural order) is an FFT with a ζ^i pre-twist; the generator ordering is a
permutation on top.
"""

from __future__ import annotations

import numpy as np

from repro_torch.kernels.tables import table

from . import rns


@table("encoder_tables")
def slot_tables(n: int):
    """(zeta_pows, slot_to_nat, conj_to_nat) for ring degree n."""
    i = np.arange(n)
    zeta = np.exp(1j * np.pi * i / n)  # ζ^i, ζ = e^{iπ/N}
    # generator-5 exponents g_j = 5^j mod 2N for j < N/2
    g = np.empty(n // 2, dtype=np.int64)
    cur = 1
    for j in range(n // 2):
        g[j] = cur
        cur = (cur * 5) % (2 * n)
    slot_to_nat = (g - 1) // 2  # natural index k with 2k+1 = g_j
    conj_to_nat = (2 * n - g - 1) // 2
    return zeta, slot_to_nat, conj_to_nat


def _eval_all_odd(a: np.ndarray) -> np.ndarray:
    """a(ζ^{2k+1}) for k = 0..N-1 from real coefficient vector a (length N)."""
    n = a.shape[-1]
    zeta, _, _ = slot_tables(n)
    return n * np.fft.ifft(a * zeta)


def decode(coeffs_rns: np.ndarray, primes, scale: float, max_limbs: int = 4) -> np.ndarray:
    """(limbs, N) uint32 coefficient-domain RNS → complex slot vector (N/2,)."""
    n = coeffs_rns.shape[-1]
    vals = rns.crt_reconstruct_centered(np.asarray(coeffs_rns), primes, max_limbs=max_limbs)
    a = np.array([float(v) for v in vals]) / scale
    nat = _eval_all_odd(a)
    _, s2n, _ = slot_tables(n)
    return nat[s2n]


def encode_coeffs(z: np.ndarray, n: int, scale: float) -> np.ndarray:
    """Complex slots (≤ N/2,) → integer coefficient vector (N,) int64.

    Shorter vectors are zero-padded (standard sparse packing is NOT applied —
    full-slot packing per the paper's packed bootstrapping).
    """
    zeta, s2n, c2n = slot_tables(n)
    zfull = np.zeros(n, dtype=np.complex128)
    z = np.asarray(z, dtype=np.complex128).ravel()
    assert z.shape[0] <= n // 2, "too many slots"
    zfull[s2n[: z.shape[0]]] = z
    zfull[c2n[: z.shape[0]]] = np.conj(z)
    b = np.fft.fft(zfull) / n
    a = np.real(b * np.conj(zeta))
    return np.rint(a * scale).astype(np.int64)


def encode(z: np.ndarray, n: int, scale: float, primes) -> np.ndarray:
    """Complex slots → (limbs, N) uint32 RNS coefficients over ``primes``."""
    return rns.to_rns_i64(encode_coeffs(z, n, scale), primes)


def const_integer(c: complex, scale: float) -> int | None:
    """round(c·scale) of a real scalar c, the constant coefficient it encodes
    to; None for a complex one, which encodes through the slots."""
    if abs(complex(c).imag) < 1e-300:
        return int(round(float(np.real(c)) * scale))
    return None


def encode_const(c: complex, n: int, scale: float, primes) -> np.ndarray:
    """Scalar broadcast to all slots.  Real scalars encode to a constant poly."""
    v = const_integer(c, scale)
    if v is not None:
        out = np.zeros((len(primes), n), np.uint32)
        for i, p in enumerate(primes):
            out[i, 0] = v % int(p)
        return out
    return encode(np.full(n // 2, c), n, scale, primes)


def max_encode_error(n: int, scale: float) -> float:
    """Rounding bound: |decode(encode(z)) - z|_∞ ≤ N/(2·scale) (loose)."""
    return n / (2.0 * scale)
