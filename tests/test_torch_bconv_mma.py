"""The int8 tensor-core BConv of ``csrc/bconv.cu``, rehearsed in plain torch.

A model of the kernel's arithmetic and index math in int64: the A fragments
each lane (g, t) loads from x̂ and byte-transposes into four byte planes with
byte permutes, the B words the host lays out per target and each lane reads
from shared memory, the m16n8k32 u8 × u8 → s32 product as the PTX ISA lays its
fragments out, the 64-bit sums of the byte products by diagonal against C_m,
the shuffle between lane pairs and the one REDC per output.  The model must
equal the port's and the reference package's plain versions exactly, and the
reference's Pallas kernel in interpret mode; the kernel itself is held against
the same plain version on the card (``tests/test_torch_gpu.py``).  Edit this
file with the kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bconv import kernel as R_bkernel
from repro.kernels.bconv import ops as R_bops
from repro.kernels.bconv import ref as R_bref
from repro_torch.fhe import modmath as T_mm
from repro_torch.fhe import params as T_P
from repro_torch.fhe import poly as T_poly
from repro_torch.fhe import rns as T_rns
from repro_torch.kernels.bconv import ops as T_bops
from repro_torch.kernels.bconv import ref as T_bref

torch.set_num_threads(1)
M32 = 0xFFFFFFFF
LANE = torch.arange(32)
G, T = LANE // 4, LANE % 4  # groupID and threadID_in_group of each lane
KSTEP = T_bops.KSTEP


def _residues(rng, shape, primes):
    q = np.array(primes, np.uint64).reshape(-1, 1)
    return (rng.integers(0, 1 << 31, size=shape, dtype=np.uint64) % q).astype(np.uint32)


# ---------------------------------------------------------------------------
# the kernel's pieces
# ---------------------------------------------------------------------------


def byte_perm(x: torch.Tensor, y: torch.Tensor, sel: int) -> torch.Tensor:
    """__byte_perm(x, y, sel) on uint32 values held in int64: nibble n of sel
    picks byte n of the result from the 8 bytes of {y : x} (x holds 0..3)."""
    out = torch.zeros_like(x)
    for n in range(4):
        b = (sel >> (4 * n)) & 7
        src = x if b < 4 else y
        out = out | (((src >> (8 * (b & 3))) & 0xFF) << (8 * n))
    return out


def byte_transpose(v):
    """The kernel's 4 × 4 byte transpose of words v[0..3]: plane a holds byte a of v[0..3]."""
    lo01, lo23 = byte_perm(v[0], v[1], 0x5140), byte_perm(v[2], v[3], 0x5140)
    hi01, hi23 = byte_perm(v[0], v[1], 0x7362), byte_perm(v[2], v[3], 0x7362)
    return [byte_perm(lo01, lo23, 0x5410), byte_perm(lo01, lo23, 0x7632),
            byte_perm(hi01, hi23, 0x5410), byte_perm(hi01, hi23, 0x7632)]


def redc64(v: torch.Tensor, c: torch.Tensor, cinv: torch.Tensor) -> torch.Tensor:
    """montredc64 of montgomery.cuh in int64: v·2^-32 mod c for v < c·2^32."""
    assert bool((v >= 0).all()) and bool((v < c << 32).all())
    lo = v & M32
    m = ((lo & 0xFFFF) * cinv + ((((lo >> 16) * cinv) & 0xFFFF) << 16)) & M32  # lo·cinv mod 2^32
    res = (v >> 32) + ((m * c) >> 32) + (lo != 0).long()
    assert bool((res < 2 * c).all())
    return torch.where(res >= c, res - c, res)


def _frag_index():
    """Row and column of each fragment element (PTX ISA, mma.m16n8k32 .u8):
    A (lane, reg, byte) → (row, col) of 16 × 32; B (lane, reg, byte) → (k, col)
    of 32 × 8; C (lane, reg) → (row, col) of 16 × 8."""
    g, t = G[:, None, None], T[:, None, None]
    ra, ea = torch.arange(4)[None, :, None], torch.arange(4)[None, None, :]
    a_row = (g + 8 * (ra & 1)).expand(32, 4, 4)
    a_col = 4 * t + 16 * (ra >> 1) + ea
    rb = torch.arange(2)[None, :, None]
    b_k = 4 * t + 16 * rb + ea
    b_col = g.expand(32, 2, 4)
    rc = torch.arange(4)[None, :]
    c_row = G[:, None] + 8 * (rc >> 1)
    c_col = 2 * T[:, None] + (rc & 1)
    return (a_row, a_col), (b_k, b_col), (c_row, c_col)


(A_ROW, A_COL), (B_K, B_COL), (C_ROW, C_COL) = _frag_index()


def _bytes(words: torch.Tensor) -> torch.Tensor:
    return (words[..., None] >> (8 * torch.arange(4))) & 0xFF


def a_matrix(a: torch.Tensor) -> torch.Tensor:
    """The 16 × 32 u8 A of the lanes' A registers a (..., 32, 4)."""
    amat = torch.zeros(a.shape[:-2] + (16, 32), dtype=torch.int64)
    amat[..., A_ROW, A_COL] = _bytes(a)
    return amat


def b_matrix(b: torch.Tensor) -> torch.Tensor:
    """The 32 × 8 u8 B of the lanes' B registers b (..., 32, 2)."""
    bmat = torch.zeros(b.shape[:-2] + (32, 8), dtype=torch.int64)
    bmat[..., B_K, B_COL] = _bytes(b)
    return bmat


def mma_u8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mma.sync m16n8k32 u8 × u8 → s32 for every (tile, target pair): a (tiles,
    32, 4) and b (pairs, 32, 2) are the lanes' words; returns the C fragments
    (tiles, pairs, 32, 4)."""
    d = torch.einsum("xik,jkc->xjic", a_matrix(a), b_matrix(b))
    return d[:, :, C_ROW, C_COL]


def a_registers(x: torch.Tensor, k: int, ks: int) -> torch.Tensor:
    """The lanes' A registers of k-step ks for every 16-coefficient tile:
    (tiles, 32, 4 planes, 4 registers).  Register r of lane (g, t) transposes the
    words at source limbs 32ks + 16(r >> 1) + 4t + e, coefficient g + 8(r & 1)."""
    n = x.shape[1]
    reg, e = torch.arange(4)[None, :, None], torch.arange(4)[None, None, :]
    s = KSTEP * ks + 16 * (reg >> 1) + 4 * T[:, None, None] + e  # (32, 4 r, 4 e)
    i = 16 * torch.arange(n // 16)[:, None, None, None] + (G[:, None, None] + 8 * (reg & 1))[None]  # (tiles, 32, 4, 1)
    v = torch.where(s < k, x[s.clamp(max=k - 1), i], 0)  # (tiles, 32, 4 r, 4 e)
    return torch.stack(byte_transpose([v[..., e] for e in range(4)]), dim=2)


def b_registers(s_b: torch.Tensor, jb: torch.Tensor, nt: int, ks: int) -> torch.Tensor:
    """The lanes' B registers of k-step ks for target pairs starting at jb:
    (pairs, 32, 2), one 8-byte load at 8t + 2(g & 3) in target jb + (g >> 2)'s row."""
    jw = torch.clamp(jb[:, None] + (G >> 2)[None], max=nt - 1)  # (pairs, 32)
    off = KSTEP * ks + 8 * T + 2 * (G & 3)
    return torch.stack([s_b[jw, off[None]], s_b[jw, off[None] + 1]], dim=-1)


def kernel_model(xhat: torch.Tensor, w: np.ndarray, cs) -> torch.Tensor:
    """bconv_kernel of csrc/bconv.cu over every 16-coefficient warp tile and
    every target pair: xhat (k, N) int32, w (k, m), cs (m,) → (m, N) int32."""
    k, n = xhat.shape
    m = len(cs)
    assert 1 <= k <= T_bops.MAX_K and n % T_bops.COEFFS == 0
    kss = -(-k // KSTEP)
    tab = T_bops.device_table(np.asarray(w, np.uint64).tobytes(), k, tuple(int(v) for v in cs), torch.device("cpu"))
    tab = tab.long() & M32  # the staged table rows of one chunk of all m targets
    kpad = kss * KSTEP
    s_b, cm, c, cinv = tab[:, :kpad], tab[:, kpad: kpad + 8], tab[:, kpad + 8], tab[:, kpad + 9]
    x = xhat.long() & M32
    jb = torch.arange(0, m, 2)
    acc = torch.zeros((4, n // 16, len(jb), 32, 4), dtype=torch.int64)  # [plane, tile, pair, lane, reg]
    for ks in range(kss):
        a = a_registers(x, k, ks)
        b = b_registers(s_b, jb, m, ks)
        for p in range(4):
            acc[p] += mma_u8(a[:, :, p], b)
    assert int(acc.max()) < 1 << 22  # P_ab < k·255²: no s32 overflow
    # lane (g, t): target jb + (t >> 1), bytes b0 = 2(t & 1), b0 + 1 of W
    jj = torch.clamp(jb[:, None] + (T >> 1)[None], max=m - 1)[None]  # (1, pairs, 32)
    b0 = 2 * (T & 1)
    rows = []
    for r0 in (0, 2):  # registers of row g, then of row g + 8
        diag = [acc[0][..., r0], acc[1][..., r0] + acc[0][..., r0 + 1], acc[2][..., r0] + acc[1][..., r0 + 1],
                acc[3][..., r0] + acc[2][..., r0 + 1], acc[3][..., r0 + 1]]
        rows.append(sum(dg * cm[jj, b0 + e] for e, dg in enumerate(diag)))
    lo, hi = rows
    odd = (T & 1).bool()
    v = torch.where(odd, hi, lo) + torch.where(odd, lo, hi)[..., LANE ^ 1]
    res = redc64(v, c[jj], cinv[jj])  # (tiles, pairs, 32)
    out = torch.zeros((m, n), dtype=torch.int64)
    store = (jb[:, None] + (T >> 1)[None]) < m  # (pairs, 32)
    col = 16 * torch.arange(n // 16)[:, None, None] + (G + 8 * (T & 1))[None, None]  # (tiles, 1, 32)
    tgt = jj.expand(n // 16, -1, -1)
    out[tgt[:, store], col.expand_as(tgt)[:, store]] = res[:, store]
    return out.int()


# ---------------------------------------------------------------------------
# tables and pieces
# ---------------------------------------------------------------------------


def test_fragment_layouts_cover_each_matrix_once():
    for rows, cols, shape in ((A_ROW, A_COL, (16, 32)), (B_K, B_COL, (32, 8)), (C_ROW, C_COL, (16, 8))):
        flat = (rows * shape[1] + cols).reshape(-1)
        assert sorted(flat.tolist()) == list(range(shape[0] * shape[1]))


@pytest.mark.parametrize("seed", range(3))
def test_byte_transpose_gives_the_byte_planes(seed):
    """Plane a of the transpose holds byte a of the four source words, in order."""
    v = torch.from_numpy(np.random.default_rng(seed).integers(0, 1 << 32, size=(4, 50), dtype=np.int64))
    planes = byte_transpose([v[e] for e in range(4)])
    for a in range(4):
        want = sum(((v[e] >> (8 * a)) & 0xFF) << (8 * e) for e in range(4))
        assert torch.equal(planes[a], want)


@pytest.mark.parametrize("k", [1, 7, 32, 33, 58, 64])
def test_b_words_equal_the_table_built_byte_by_byte(k):
    """b_words(W)[j, ks, t, b, h] has byte e = byte b of W[32ks + 16h + 4t + e, j], 0 past row k."""
    rng = np.random.default_rng(k)
    m = 3
    w = rng.integers(0, 1 << 32, size=(k, m), dtype=np.uint64)
    w[0, 0] = 0xFFFFFFFF
    kss = -(-k // KSTEP)
    want = np.zeros((m, kss, 4, 4, 2), np.uint64)
    for j in range(m):
        for ks in range(kss):
            for t in range(4):
                for b in range(4):
                    for h in range(2):
                        for e in range(4):
                            s = KSTEP * ks + 16 * h + 4 * t + e
                            if s < k:
                                want[j, ks, t, b, h] |= ((int(w[s, j]) >> (8 * b)) & 0xFF) << (8 * e)
    got = T_bops.b_words(w)
    assert got.dtype == np.uint32 and np.array_equal(got.astype(np.uint64), want)


def test_lane_fragments_hold_the_gemm_operands():
    """The A and B registers the lanes load, laid out as the PTX ISA places
    them, are A_a[i, s] = byte a of x̂[s, i] and B[s, 4jl + b] = byte b of
    W[s, j + jl], for every k-step, byte plane and target pair (m odd: the
    last pair repeats target m − 1)."""
    rng = np.random.default_rng(5)
    k, m, n = 45, 5, 32
    x = torch.from_numpy(rng.integers(0, 1 << 31, size=(k, n), dtype=np.int64))
    w = rng.integers(0, 1 << 31, size=(k, m), dtype=np.uint64)
    s_b = torch.from_numpy(T_bops.b_words(w).astype(np.int64).reshape(m, -1))
    jb = torch.arange(0, m, 2)
    xpad = torch.zeros((2 * KSTEP, n), dtype=torch.int64)
    xpad[:k] = x
    wpad = torch.zeros((2 * KSTEP, m), dtype=torch.int64)
    wpad[:k] = torch.from_numpy(w.astype(np.int64))
    for ks in range(2):
        rows = slice(KSTEP * ks, KSTEP * ks + KSTEP)
        amat = a_matrix(a_registers(x, k, ks).transpose(1, 2))  # (tiles, plane, 16, 32)
        for a in range(4):
            want = ((xpad[rows] >> (8 * a)) & 0xFF).T.reshape(n // 16, 16, KSTEP)
            assert torch.equal(amat[:, a], want)
        bmat = b_matrix(b_registers(s_b, jb, m, ks))  # (pairs, 32, 8)
        for pi, j in enumerate(jb.tolist()):
            for col in range(8):
                jt = min(j + col // 4, m - 1)
                assert torch.equal(bmat[pi, :, col], (wpad[rows, jt] >> (8 * (col % 4))) & 0xFF)


@pytest.mark.parametrize("m", [1, 9, 116])
def test_tables_and_diag_constants_equal_the_reference_wrappers(monkeypatch, m):
    """The kernel's table rows hold the B words, C_m, c and −c^{-1}; C_m[:, :7] is
    the reference wrapper's c_mont and its q, qinv the same constants."""
    cs = T_P.master_chain(m + 3)[3:]
    rng = np.random.default_rng(m)
    w = _residues(rng, (3, m), [cs[0]] * 3)
    xhat = _residues(rng, (3, 256), T_P.master_chain(3))
    seen = {}

    def capture(xp, wp, c_mont, q, qinv, *, interpret):
        seen.update(c_mont=np.asarray(c_mont), q=np.asarray(q), qinv=np.asarray(qinv))
        return jnp.zeros((wp.shape[1], xp.shape[1]), jnp.uint32)

    monkeypatch.setattr(R_bkernel, "bconv_pallas", capture)
    R_bops.bconv(jnp.asarray(xhat), jnp.asarray(w), np.array(cs, np.uint32), backend="kernel")
    tab = T_bops.device_table(w.astype(np.uint64).tobytes(), 3, tuple(cs), torch.device("cpu")).numpy().view(np.uint32)
    assert tab.shape == (m, KSTEP + T_bops.ROW_TAIL)
    wb, cm, rest = tab[:, :KSTEP], tab[:, KSTEP: KSTEP + 8], tab[:, KSTEP + 10:]
    c, cinv = tab[:, KSTEP + 8], tab[:, KSTEP + 9]
    assert np.array_equal(wb, T_bops.b_words(w.astype(np.uint64)).reshape(m, -1)) and not rest.any()
    assert cm.shape == (m, 8) and not cm[:, 7].any()
    assert np.array_equal(cm[:, :7], seen["c_mont"][:m])
    assert np.array_equal(c, seen["q"][:m, 0]) and np.array_equal(cinv, seen["qinv"][:m, 0])
    assert np.array_equal(cinv, T_mm.mont_constants_array(cs)["qinv_neg"])


@pytest.mark.parametrize("seed", range(3))
def test_redc64_is_a_montgomery_reduction(seed):
    rng = np.random.default_rng(seed)
    cs = T_P.master_chain(8)
    consts = T_mm.mont_constants_array(cs)
    c = torch.tensor(cs, dtype=torch.int64)[:, None]
    cinv = torch.from_numpy(consts["qinv_neg"].astype(np.int64))[:, None]
    hi = torch.from_numpy(rng.integers(0, np.array(cs)[:, None], size=(8, 64)).astype(np.int64))
    v = (hi << 32) | torch.from_numpy(rng.integers(0, 1 << 32, size=(8, 64), dtype=np.int64))
    v[:, 0] = 0
    v[:, 1] = (c[:, 0] << 32) - 1  # the largest input it takes
    rinv = torch.tensor([pow(1 << 32, -1, q) for q in cs])[:, None]
    want = torch.tensor([[int(v[i, j]) * int(rinv[i]) % cs[i] for j in range(64)] for i in range(8)])
    assert torch.equal(redc64(v, c, cinv), want)


# ---------------------------------------------------------------------------
# the model against the plain versions and the reference's kernel
# ---------------------------------------------------------------------------


def _case(k, m, n, seed):
    """Random x̂ and W over real primes; (58, 116) is packed_bootstrap's digit
    ModUp with its own tables."""
    rng = np.random.default_rng(seed)
    if (k, m) == (58, 116):
        p = T_P.workload_params("packed_bootstrap")
        src = T_poly.primes_for(p, p.digit(0))
        cs = T_poly.primes_for(p, T_poly.ext_idx(p, p.L))
        _, w = T_rns.bconv_tables(src, cs)
    else:
        chain = T_P.master_chain(k + m)
        src, cs = chain[:k], chain[k:]
        w = _residues(rng, (k, m), [max(cs)] * k) % np.array(cs, np.uint32)[None, :]
    return _residues(rng, (k, n), src), np.asarray(w, np.uint32), cs


@pytest.mark.parametrize("k,m", [(1, 4), (3, 9), (7, 21), (16, 20), (58, 116), (64, 8)])
def test_kernel_model_equals_plain_versions(k, m):
    xhat, w, cs = _case(k, m, 256, k * 1000 + m)
    assert len(cs) == m
    got = kernel_model(torch.from_numpy(xhat.view(np.int32)), w, cs)
    assert torch.equal(got, T_bref.bconv_ref(torch.from_numpy(xhat.view(np.int32)), w, cs))
    want = R_bref.bconv_ref(jnp.asarray(xhat), jnp.asarray(w), jnp.asarray(np.array(cs, np.uint32)))
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_kernel_model_at_the_largest_terms():
    """k = 64 with every x̂ and W at its modulus − 1: the diagonal sums and T
    at their largest for these primes."""
    chain = T_P.master_chain(72)
    src, cs = chain[:64], chain[64:]
    xhat = np.repeat(np.array(src, np.uint32)[:, None] - 1, 256, axis=1)
    w = np.repeat(np.array(cs, np.uint32)[None, :] - 1, 64, axis=0)
    got = kernel_model(torch.from_numpy(xhat.view(np.int32)), w, cs)
    assert torch.equal(got, T_bref.bconv_ref(torch.from_numpy(xhat.view(np.int32)), w, cs))


@pytest.mark.parametrize("k,m,n", [(3, 9, 256), (7, 21, 512), (13, 5, 256)])
def test_kernel_model_equals_the_reference_kernel(k, m, n):
    """The reference's Pallas kernel in interpret mode (its byte planes and
    seven diagonals) and the model give the same words."""
    xhat, w, cs = _case(k, m, n, k + m + n)
    got = kernel_model(torch.from_numpy(xhat.view(np.int32)), w, cs)
    want = R_bops.bconv(jnp.asarray(xhat), jnp.asarray(w), np.array(cs, np.uint32), backend="kernel")
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
