"""Plain NumPy RNS-CKKS: what the benchmark's references need to judge a ciphertext.

Nothing here comes from the program under test.  The prime chain, the roots of
unity and every table are worked out again from (N, L, dnum); the secret key
is the one the benchmark sampled from ``--seed``.  The only thing shared with
the program is the format of a ciphertext: two (limbs, N) residue arrays in the
evaluation domain, where slot j of limb i holds a(psi_i^(2j+1)) mod q_i with
psi_i = g_i^((q_i - 1) / 2N) for the least primitive root g_i of q_i.

``decrypt_decode`` is what a client does: it evaluates c0 + c1·s in every limb,
goes back to coefficients, reconstructs the signed integers through the whole
chain (Garner's mixed radix, so a wrong residue in any limb shows), and decodes
the slots at the scale the reference expects.
"""

from __future__ import annotations

import functools

import numpy as np

PRIME_BITS = 30
N_MAX = 1 << 16  # every chain prime is ≡ 1 mod 2·N_MAX, so one chain serves every N ≤ N_MAX


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
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
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


@functools.lru_cache(maxsize=8)
def chain(count: int) -> tuple[int, ...]:
    """The first ``count`` primes q ≡ 1 (mod 2·N_MAX) below 2^30, descending."""
    step = 2 * N_MAX
    q = (1 << PRIME_BITS) + 1
    q -= (q - 1) % step
    out = []
    while len(out) < count:
        if is_prime(q):
            out.append(q)
        q -= step
    return tuple(out)


def moduli(L: int, dnum: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(q_0..q_L, p_0..p_{α-1}) with α = ⌈(L+1)/dnum⌉ special primes after the chain."""
    alpha = -(-(L + 1) // dnum)
    c = chain(L + 1 + alpha)
    return c[: L + 1], c[L + 1:]


@functools.lru_cache(maxsize=None)
def psi(n: int, q: int) -> int:
    """psi = g^((q-1)/2n) for the least primitive root g of q."""
    phi = q - 1
    factors, m, d = set(), phi, 2
    while d * d <= m:
        while m % d == 0:
            factors.add(d)
            m //= d
        d += 1
    if m > 1:
        factors.add(m)
    g = 2
    while any(pow(g, phi // f, q) == 1 for f in factors):
        g += 1
    return pow(g, phi // (2 * n), q)


def _powers(base: np.ndarray, n: int, q: np.ndarray) -> np.ndarray:
    """(limbs, n) table of base^i mod q, each row its own base and modulus."""
    out = np.ones((len(q), n), np.uint64)
    out[:, 1 % n] = base % q if n > 1 else 1
    filled = 2
    while filled < n:
        take = min(filled, n - filled)
        step = np.array([pow(int(b), filled, int(m)) for b, m in zip(base, q)], np.uint64)
        out[:, filled:filled + take] = (out[:, :take] * step[:, None]) % q[:, None]
        filled += take
    return out


@functools.lru_cache(maxsize=16)
def _tables(n: int, primes: tuple[int, ...]):
    q = np.array(primes, np.uint64)
    ps = np.array([psi(n, p) for p in primes], np.uint64)
    ps_inv = np.array([pow(int(x), -1, int(p)) for x, p in zip(ps, primes)], np.uint64)
    w = ps * ps % q
    w_inv = ps_inv * ps_inv % q
    n_inv = np.array([pow(n, -1, p) for p in primes], np.uint64)
    twist = _powers(ps, n, q)
    untwist = _powers(ps_inv, n, q) * n_inv[:, None] % q[:, None]
    rev = np.zeros(n, np.int64)
    idx = np.arange(n)
    for b in range(n.bit_length() - 1):
        rev |= ((idx >> b) & 1) << (n.bit_length() - 2 - b)
    return q, twist, untwist, _powers(w, n, q), _powers(w_inv, n, q), rev


def _cyclic(x: np.ndarray, w_pows: np.ndarray, q: np.ndarray, rev: np.ndarray) -> np.ndarray:
    """Cyclic DFT per limb, natural order in and out: X_j = Σ_i x_i·w^(ij) mod q."""
    limbs, n = x.shape
    x = x[:, rev]
    qq = q[:, None, None]
    half = 1
    while half < n:
        tw = w_pows[:, np.arange(half) * (n // (2 * half))][:, None, :]
        x = x.reshape(limbs, n // (2 * half), 2, half)
        u = x[:, :, 0, :]
        v = x[:, :, 1, :] * tw % qq
        x = np.stack(((u + v) % qq, (u + qq - v) % qq), axis=2)
        half *= 2
    return x.reshape(limbs, n)


def ntt(a: np.ndarray, primes) -> np.ndarray:
    """Coefficients (limbs, n) → evaluation domain: slot j = a(psi^(2j+1))."""
    q, twist, _, w, _, rev = _tables(a.shape[-1], tuple(int(p) for p in primes))
    b = np.asarray(a, np.uint64) % q[:, None] * twist % q[:, None]
    return _cyclic(b, w, q, rev)


def intt(a: np.ndarray, primes) -> np.ndarray:
    """Evaluation domain (limbs, n) → coefficients in [0, q)."""
    q, _, untwist, _, w_inv, rev = _tables(a.shape[-1], tuple(int(p) for p in primes))
    b = _cyclic(np.asarray(a, np.uint64) % q[:, None], w_inv, q, rev)
    return b * untwist % q[:, None]


def residues(v: np.ndarray, primes) -> np.ndarray:
    """Signed integers (n,) → (limbs, n) residues in [0, q) as uint64."""
    return np.stack([np.mod(np.asarray(v, np.int64), np.int64(p)) for p in primes]).astype(np.uint64)


def _garner(r: np.ndarray, primes) -> np.ndarray:
    """Mixed-radix digits d with value Σ d_i·q_0···q_{i-1}, from residues r (limbs, n)."""
    ps = [int(p) for p in primes]
    d = np.empty(r.shape, np.int64)
    for i, qi in enumerate(ps):
        t = r[i].astype(np.int64)
        for j in range(i):
            t -= d[j]
            t %= qi
            t *= pow(ps[j], -1, qi)
            t %= qi
        d[i] = t
    return d


def _horner(d: np.ndarray, primes) -> np.ndarray:
    with np.errstate(over="ignore", invalid="ignore"):
        v = d[-1].astype(np.float64)
        for i in range(len(primes) - 2, -1, -1):
            v = v * float(primes[i]) + d[i]
    return v


def crt_signed(r: np.ndarray, primes) -> np.ndarray:
    """The centred value in (−Q/2, Q/2] of residues r (limbs, n), as float64.

    Exact in sign and to float64's precision in size; a residue vector that
    is no small integer in every limb comes out at ±inf or near ±Q/2."""
    q = np.array([int(p) for p in primes], np.int64)[:, None]
    r = np.asarray(r, np.int64) % q
    n = r.shape[1]
    both = _garner(np.concatenate([r, (q - r) % q], axis=1), primes)
    pos, neg = both[:, :n], both[:, n:]
    smaller = np.zeros(n, bool)  # value(r) < value(−r): r is the non-negative side
    open_ = np.ones(n, bool)
    for i in range(len(primes) - 1, -1, -1):
        differ = open_ & (pos[i] != neg[i])
        smaller[differ] = pos[i][differ] < neg[i][differ]
        open_ &= ~differ
    return np.where(smaller | open_, _horner(pos, primes), -_horner(neg, primes))


@functools.lru_cache(maxsize=8)
def _slot_index(n: int) -> np.ndarray:
    g = np.empty(n // 2, np.int64)
    cur = 1
    for j in range(n // 2):
        g[j] = cur
        cur = cur * 5 % (2 * n)
    return (g - 1) // 2


def decode(coeffs: np.ndarray, scale: float) -> np.ndarray:
    """Real coefficients (n,) at ``scale`` → the N/2 complex slots (generator-5 order)."""
    n = coeffs.shape[-1]
    zeta = np.exp(1j * np.pi * np.arange(n) / n)
    nat = n * np.fft.ifft(np.asarray(coeffs, np.float64) / scale * zeta)
    return nat[_slot_index(n)]


def encode(z: np.ndarray, n: int, scale: float) -> np.ndarray:
    """N/2 complex slots → rounded integer coefficients (n,) at ``scale``."""
    s = _slot_index(n)
    full = np.zeros(n, np.complex128)
    z = np.asarray(z, np.complex128).ravel()
    full[s[: z.shape[0]]] = z
    full[(2 * n - 2 * s[: z.shape[0]] - 2) // 2] = np.conj(z)
    zeta = np.exp(1j * np.pi * np.arange(n) / n)
    a = np.real(np.fft.fft(full) / n * np.conj(zeta))
    return np.rint(a * scale).astype(np.int64)


def sample_ternary(rng: np.random.Generator, n: int, h: int) -> np.ndarray:
    """A ternary secret of Hamming weight h."""
    s = np.zeros(n, np.int64)
    pos = rng.choice(n, size=h, replace=False)
    s[pos] = rng.choice(np.array([-1, 1]), size=h)
    return s


def decrypt_decode(c0: np.ndarray, c1: np.ndarray, s: np.ndarray, primes, scale: float) -> np.ndarray:
    """Slots of the ciphertext (c0, c1) over ``primes`` under the secret s, at ``scale``."""
    q = np.array([int(p) for p in primes], np.uint64)[:, None]
    s_hat = ntt(residues(s, primes), primes)
    m = (np.asarray(c0, np.int64).astype(np.uint64) % q
         + np.asarray(c1, np.int64).astype(np.uint64) % q * s_hat % q) % q
    return decode(crt_signed(intt(m, primes), primes), scale)


def encrypt_sk(z: np.ndarray, s: np.ndarray, primes, scale: float, rng: np.random.Generator,
               float_products: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """A symmetric encryption of the slots z: c1 = a uniform, c0 = −a·s + (m + e).

    With ``float_products`` the residue products a·ŝ are taken in float64 (53
    bits of a 60-bit product) in place of exact integer products: the control
    that breaks the exact residue arithmetic the configurations state."""
    n = s.shape[0]
    q = np.array([int(p) for p in primes], np.uint64)[:, None]
    a = np.stack([rng.integers(0, int(p), size=n, dtype=np.uint64) for p in primes])
    e = np.rint(rng.normal(0.0, 3.2, size=n)).astype(np.int64)
    s_hat = ntt(residues(s, primes), primes)
    if float_products:
        qf = q.astype(np.float64)
        as_ = np.fmod(a.astype(np.float64) * s_hat.astype(np.float64), qf).astype(np.uint64) % q
    else:
        as_ = a * s_hat % q
    me = ntt(residues(encode(z, n, scale) + e, primes), primes)
    return (me + q - as_) % q, a
