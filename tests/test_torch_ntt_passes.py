"""The two-pass schedule of ``csrc/ntt_passes.cuh``, rehearsed in plain torch.

A model of the CUDA kernels' index math in int64: the N = N1·N2 split, pass
1's column NTTs with the twist on its load and the inter-pass twiddle on its
store, pass 2's row NTTs with its stride-N1 store (and the inverse's
psi^-i·N^-1), and inside each sub-NTT the kernels' own groups of up to three
DIF stages, their task → position map and their twiddle index j << shift into
the M/2 sub-roots.  Every table is read from ``kernel_tables`` /
``ks_tables``, the tensors the kernels are given.  The model must equal the
plain versions (and the reference package's NTT) exactly; the kernels are held
against the same plain versions on the card (``tests/test_torch_gpu.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fhe import ntt as R_ntt
from repro.kernels.ntt import ref as R_nttref
from repro_torch.fhe import ntt as T_ntt
from repro_torch.fhe import params as T_P
from repro_torch.fhe import poly as T_poly
from repro_torch.kernels.fusedks import ops as T_fops
from repro_torch.kernels.fusedks import ref as T_fref
from repro_torch.kernels.ntt import ops as T_nttops
from repro_torch.kernels.ntt import ref as T_nttref

torch.set_num_threads(1)
CPU = torch.device("cpu")
TILE, SLOTS = 16, 8  # PASS_TILE and PASS_SLOTS of ntt_passes.cuh


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns → their uint32 values as int64."""
    return t.long() & 0xFFFFFFFF


def _residues(shape, primes, seed):
    rng = np.random.default_rng(seed)
    q = np.array(primes, np.uint64).reshape(-1, 1)
    a = (rng.integers(0, 1 << 31, size=shape, dtype=np.uint64) % q).astype(np.int32)
    return torch.from_numpy(a)


class Mod:
    """Arithmetic mod per-limb q of shape (L, 1, ..., 1): montmul is a·b·2^-32."""

    def __init__(self, qs: torch.Tensor, ndim: int):
        self.q = qs.reshape((-1,) + (1,) * (ndim - 1))
        self.rinv = torch.tensor([pow(1 << 32, -1, int(q)) for q in qs]).reshape(self.q.shape)

    def montmul(self, a, b):
        return a * b % self.q * self.rinv % self.q


def _rev(n_bits: int) -> torch.Tensor:
    return torch.as_tensor(T_ntt.bit_reverse_indices(1 << n_bits))


def dif_columns(a, sub, log_m, mod):
    """The M-point cyclic DIF NTT of every column of a (L, M, C), as dif_columns
    runs it: groups of g <= 3 stages from the top, PASS_SLOTS / 2^g tasks of
    2^g coefficients per thread at positions base + b·2^s0.  Position p of the
    result holds X[bitrev(p)].  sub: (L, M/2) root powers ·R."""
    m_pts = 1 << log_m
    top = log_m - 1
    seen = 0
    while top >= 0:
        g = 3 if top >= 2 else top + 1
        s0 = top - g + 1
        per_round = TILE * m_pts // SLOTS // TILE  # threads of one column: blockDim / PASS_TILE
        # task u of thread t: grp = t / PASS_TILE + u·per_round, the same for every column
        grp = (torch.arange(per_round)[:, None] + torch.arange(SLOTS >> g)[None, :] * per_round).reshape(-1)
        low = grp & ((1 << s0) - 1)
        base = ((grp >> s0) << (s0 + g)) | low
        pos = base[:, None] + (torch.arange(1 << g) << s0)[None, :]  # (tasks, 2^g)
        assert sorted(pos.reshape(-1).tolist()) == list(range(m_pts))  # each position once per group
        v = a[:, pos, :]  # (L, tasks, 2^g, C)
        for gg in range(g - 1, -1, -1):
            shift = log_m - 1 - (s0 + gg)
            for b in range(1 << g):
                if b & (1 << gg):
                    continue
                j = low + ((b & ((1 << gg) - 1)) << s0)
                assert int((j << shift).max()) < m_pts // 2
                tw = sub[:, j << shift][:, :, None]  # (L, tasks, 1)
                a0, a1 = v[:, :, b, :].clone(), v[:, :, b + (1 << gg), :].clone()
                v[:, :, b, :] = (a0 + a1) % mod.q
                v[:, :, b + (1 << gg), :] = mod.montmul((a0 - a1) % mod.q, tw)
        a = a.clone()
        a[:, pos, :] = v
        seen += g
        top -= 3
    assert seen == log_m
    return a


def sub_roots(roots, log_m, log_stride):
    """load_sub_roots: sub[e] = roots[e << log_stride], e < M/2."""
    return roots[:, torch.arange(1 << (log_m - 1)) << log_stride]


def pass1(x, twist, roots, tw, mod, n, inverse):
    """(L, N) → Y: column NTTs over n1 (stride N2), twist on load (forward), w^(k1·n2) on store."""
    n1, n2 = T_nttops.split(n)
    log_n1, log_n2 = n1.bit_length() - 1, n2.bit_length() - 1
    a = x.reshape(-1, n1, n2)  # (L, pos = n1, col = n2): x[n1·N2 + n2]
    if not inverse:
        a = mod.montmul(a, twist.reshape(-1, n1, n2))
    a = dif_columns(a, sub_roots(roots, log_n1, log_n2), log_n1, mod)
    y = torch.empty_like(a)
    y[:, _rev(log_n1), :] = a  # position p holds k1 = bitrev(p): Y[k1·N2 + n2]
    return mod.montmul(y, tw.reshape(-1, n1, n2)).reshape(-1, n)


def pass2_ntt(y, roots, mod, n):
    """Y (L, N) → the row NTTs over n2; returns (L, pos = bitrev(k2), col = k1)."""
    n1, n2 = T_nttops.split(n)
    log_n1, log_n2 = n1.bit_length() - 1, n2.bit_length() - 1
    a = y.reshape(-1, n1, n2).transpose(1, 2)  # (L, pos = n2, col = k1), the staged tile
    return dif_columns(a, sub_roots(roots, log_n2, log_n1), log_n2, mod)


def pass2_store_index(n):
    """(pos, col) → the natural-order index k1 + N1·k2 pass 2 stores to."""
    n1, n2 = T_nttops.split(n)
    k2 = _rev(n2.bit_length() - 1)[:, None]
    return torch.arange(n1)[None, :] + n1 * k2  # (N2, N1)


def two_pass_ntt(x, plan, inverse):
    l, n = x.shape
    t = {k: _u32(v) for k, v in T_nttops.kernel_tables(plan, l, CPU).items()}
    mod = Mod(t["q"], 3)
    twist, roots, tw = (t["psiinv_ninv"], t["winv"], t["twinv"]) if inverse else (t["psi"], t["w"], t["tw"])
    y = pass1(x.long(), twist, roots, tw, mod, n, inverse)
    a = pass2_ntt(y, roots, mod, n)
    out = torch.empty(l, n, dtype=torch.long)
    out[:, pass2_store_index(n).reshape(-1)] = a.reshape(l, -1)
    if inverse:
        out = Mod(t["q"], 2).montmul(out, twist)
    return out.int()


@pytest.mark.parametrize("logn", range(8, 17))
def test_two_pass_schedule_equals_the_plain_ntt(logn):
    n = 1 << logn
    primes = T_P.master_chain(2)
    plan = T_ntt.build_plan(n, primes)
    x = _residues((2, n), primes, logn)
    fwd = two_pass_ntt(x, plan, inverse=False)
    assert torch.equal(fwd, T_nttref.ntt_fwd_ref(x, plan))
    assert torch.equal(two_pass_ntt(x, plan, inverse=True), T_nttref.ntt_inv_ref(x, plan))
    assert torch.equal(two_pass_ntt(fwd, plan, inverse=True), x)


@pytest.mark.parametrize("logn", [8, 13])
def test_two_pass_schedule_equals_the_reference_ntt(logn):
    n = 1 << logn
    primes = T_P.master_chain(3)
    x = _residues((3, n), primes, 100 + logn)
    rplan = R_ntt.build_plan(n, primes)
    got = two_pass_ntt(x, T_ntt.build_plan(n, primes), inverse=False)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(R_nttref.ntt_fwd_ref(jnp.asarray(x.numpy()), rplan)).astype(np.int64))


def test_split_and_inter_pass_twiddles():
    assert [T_nttops.split(1 << k) for k in (8, 9, 13, 14, 16)] == [
        (16, 16), (16, 32), (64, 128), (128, 128), (256, 256)]
    plan = T_ntt.build_plan(1 << 9, T_P.master_chain(1))
    tw = T_nttops.inter_pass_twiddles(plan.w_pows, plan.n)
    n1, n2 = T_nttops.split(plan.n)
    k1, col = 5, 7
    assert tw[0, k1 * n2 + col] == plan.w_pows[0, k1 * col]
    assert tw.shape == plan.w_pows.shape
    with pytest.raises(ValueError):
        T_nttops.check_size(1 << 17)
    with pytest.raises(ValueError):
        T_nttops.check_size(1 << 7)


def two_pass_key_switch(d, ksk, params, level):
    """fused_ks_pass_a then fused_ks_pass_b, as fusedks.cu runs them."""
    n, nq, alpha, beta = params.n, level + 1, params.alpha, params.beta(level)
    m = nq + alpha
    t = {k: _u32(v) for k, v in T_fops.ks_tables(params, level, CPU).items()}
    src_mod = Mod(t["q"][:nq], 2)
    ext_mod2, ext_mod3 = Mod(t["q"], 2), Mod(t["q"], 3)
    d = d.long()
    # pass A: row j·m + e — bconv_coeff<true> (each term reduced mod c_e), the twist, column NTTs
    scratch = torch.empty(beta, m, n, dtype=torch.long)
    for j in range(beta):
        lo, hi = j * alpha, min((j + 1) * alpha, nq)
        xh = src_mod.montmul(d, t["bh"][:, None])  # prescale, every source limb
        y = torch.zeros(m, n, dtype=torch.long)
        for s in range(lo, hi):
            y = (y + ext_mod2.montmul(xh[s][None, :], t["w"][s][:, None])) % ext_mod2.q
        scratch[j] = pass1(y, t["psi"], t["roots"], t["tw"], ext_mod3, n, inverse=False)
    # pass B: limb e — for every digit the row NTTs and the MAC, both sums carried
    idx = pass2_store_index(n).reshape(-1)
    r2 = t["r2"][:, None]
    acc = torch.zeros(2, m, n, dtype=torch.long)
    for j in range(beta):
        v = torch.empty(m, n, dtype=torch.long)
        v[:, idx] = pass2_ntt(scratch[j], t["roots"], ext_mod3, n).reshape(m, -1)
        for c in range(2):
            prod = ext_mod2.montmul(ext_mod2.montmul(v, _u32(ksk[j, c])), r2)  # mulmod: a·b·R^-1, then ·R^2·R^-1
            acc[c] = (acc[c] + prod) % ext_mod2.q
    return acc[0].int(), acc[1].int()


@pytest.mark.parametrize("dnum, L", [(2, 5), (4, 7)], ids=["alpha3", "beta4"])
def test_two_pass_key_switch_equals_the_plain_version(dnum, L):
    p = T_P.make_params(1 << 9, L, dnum, check_security=False)
    levels = sorted({p.L, p.alpha, p.alpha - 1, 1})
    assert any((lv + 1) % p.alpha for lv in levels if lv + 1 > p.alpha)  # a ragged last digit among them
    for level in levels:
        ext = T_poly.primes_for(p, T_poly.ext_idx(p, level))
        beta, m = p.beta(level), len(ext)
        d = _residues((level + 1, p.n), p.q_primes[: level + 1], level)
        ksk = _residues((beta * 2 * m, p.n), ext * (beta * 2), level + 1).reshape(beta, 2, m, p.n)
        got = two_pass_key_switch(d, ksk, p, level)
        want = T_fref.key_switch_digits_ref(d, ksk, p, level)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
