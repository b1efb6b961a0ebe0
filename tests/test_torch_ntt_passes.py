"""The two-pass schedule of ``csrc/ntt_passes.cuh``, rehearsed in plain torch.

A model of the CUDA kernels' index math in int64: the N = N1·N2 split, pass
1's column NTTs with the twist on its load and the inter-pass twiddle on its
store, pass 2's row NTTs with its stride-N1 store (and the inverse's
psi^-i·N^-1), and inside each sub-NTT the kernels' own groups of up to three
DIF stages, their task → position map and their twiddle index j << shift into
the M/2 sub-roots.  On top of it, the two-pass kernels built from the same
pieces: ``fused_ks``, ``fused_moddown`` and ``hoist_modup``, each pass A
(``modup_pass_a`` of ``bconv_core.cuh``) followed by its pass B.  Every table
is read from ``kernel_tables`` / ``ks_tables`` / ``moddown_tables``, the
tensors the kernels are given.  The model must equal the plain versions (and
the reference package's) exactly; the kernels are held against the same plain
versions on the card (``tests/test_torch_gpu.py``).  Last, ``fused_rescale``
(``csrc/rescale.cu``): the inverse passes of the dropped limbs, then a pass A
whose load is the centred one-limb conversion, and its pass B.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fhe import ntt as R_ntt
from repro.fhe import ops as R_ops
from repro.fhe import params as R_P
from repro.fhe.context import ExecPolicy as R_Policy
from repro.fhe.context import FheContext as R_Ctx
from repro.kernels.fusedks import ref as R_fref
from repro.kernels.hoistrot import ref as R_href
from repro.kernels.ntt import ref as R_nttref
from repro_torch.fhe import ntt as T_ntt
from repro_torch.fhe import params as T_P
from repro_torch.fhe import poly as T_poly
from repro_torch.kernels.fusedks import ops as T_fops
from repro_torch.kernels.fusedks import ref as T_fref
from repro_torch.kernels.hoistrot import ref as T_href
from repro_torch.kernels.ntt import ops as T_nttops
from repro_torch.kernels.ntt import ref as T_nttref
from repro_torch.kernels.rescale import ops as T_rsops
from repro_torch.kernels.rescale import ref as T_rsref

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


def row_ntt_pass(y, roots, mod, n):
    """row_ntt_pass of ntt_passes.cuh: the row NTTs of Y (L, N), each output at
    the natural-order index its store is given."""
    out = torch.empty_like(y)
    out[:, pass2_store_index(n).reshape(-1)] = pass2_ntt(y, roots, mod, n).reshape(y.shape[0], -1)
    return out


def two_pass_ntt(x, plan, inverse):
    l, n = x.shape
    t = {k: _u32(v) for k, v in T_nttops.kernel_tables(plan, l, CPU).items()}
    mod = Mod(t["q"], 3)
    twist, roots, tw = (t["psiinv_ninv"], t["winv"], t["twinv"]) if inverse else (t["psi"], t["w"], t["tw"])
    out = row_ntt_pass(pass1(x.long(), twist, roots, tw, mod, n, inverse), roots, mod, n)
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


def modup_pass_a(x, lo, hi, src_q, bh, w, t, n):
    """modup_pass_a of bconv_core.cuh over every target row: source rows [lo, hi)
    of x (moduli src_q) prescaled by bh, converted to each target limb by
    bconv_coeffs (each term reduced mod c_e before it is added), then pass 1 of
    the forward NTT with the twist.  w: (source rows, targets); t: the target
    basis's tables."""
    tgt2, tgt3 = Mod(t["q"], 2), Mod(t["q"], 3)
    xh = Mod(src_q, 2).montmul(x.long(), bh[:, None])
    y = torch.zeros(len(t["q"]), n, dtype=torch.long)
    for s in range(lo, hi):
        y = (y + tgt2.montmul(xh[s][None, :], w[s][:, None])) % tgt2.q
    return pass1(y, t["psi"], t["roots"], t["tw"], tgt3, n, inverse=False)


def digits_pass_a(d, params, level, t):
    """digits_pass_a of bconv_core.cuh (pass A of fused_ks and hoist_modup):
    (β, m, N) scratch, row j·m + e from digit j's source limbs."""
    nq, alpha = level + 1, params.alpha
    return torch.stack([modup_pass_a(d, j * alpha, min((j + 1) * alpha, nq), t["q"][:nq], t["bh"], t["w"], t, params.n)
                        for j in range(params.beta(level))])


def two_pass_key_switch(d, ksk, params, level):
    """fused_ks_pass_a then fused_ks_pass_b, as fusedks.cu runs them."""
    n, beta = params.n, params.beta(level)
    m = level + 1 + params.alpha
    t = {k: _u32(v) for k, v in T_fops.ks_tables(params, level, CPU).items()}
    ext_mod2, ext_mod3 = Mod(t["q"], 2), Mod(t["q"], 3)
    scratch = digits_pass_a(d, params, level, t)
    # pass B: limb e — for every digit the row NTTs and the MAC, both sums carried
    r2 = t["r2"][:, None]
    acc = torch.zeros(2, m, n, dtype=torch.long)
    for j in range(beta):
        v = row_ntt_pass(scratch[j], t["roots"], ext_mod3, n)
        for c in range(2):
            prod = ext_mod2.montmul(ext_mod2.montmul(v, _u32(ksk[j, c])), r2)  # mulmod: a·b·R^-1, then ·R^2·R^-1
            acc[c] = (acc[c] + prod) % ext_mod2.q
    return acc[0].int(), acc[1].int()


def _levels(p):
    levels = sorted({p.L, p.alpha, p.alpha - 1, 1})
    assert any((lv + 1) % p.alpha for lv in levels if lv + 1 > p.alpha)  # a ragged last digit among them
    return levels


@pytest.mark.parametrize("dnum, L", [(2, 5), (4, 7)], ids=["alpha3", "beta4"])
def test_two_pass_key_switch_equals_the_plain_version(dnum, L):
    p = T_P.make_params(1 << 9, L, dnum, check_security=False)
    for level in _levels(p):
        ext = T_poly.primes_for(p, T_poly.ext_idx(p, level))
        beta, m = p.beta(level), len(ext)
        d = _residues((level + 1, p.n), p.q_primes[: level + 1], level)
        ksk = _residues((beta * 2 * m, p.n), ext * (beta * 2), level + 1).reshape(beta, 2, m, p.n)
        got = two_pass_key_switch(d, ksk, p, level)
        want = T_fref.key_switch_digits_ref(d, ksk, p, level)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def two_pass_mod_up(d, params, level):
    """hoist_modup_pass_a then hoist_modup_pass_b, as hoistrot.cu runs them."""
    t = {k: _u32(v) for k, v in T_fops.ks_tables(params, level, CPU).items()}
    mod3 = Mod(t["q"], 3)
    return torch.stack([row_ntt_pass(y, t["roots"], mod3, params.n) for y in digits_pass_a(d, params, level, t)]).int()


def two_pass_mod_down(pc, qpart, params, level):
    """fused_moddown_pass_a then fused_moddown_pass_b, as fusedks.cu runs them:
    row c·nq + e converts accumulator c's α P-block limbs to q_e; pass B's store
    is (qpart − ŷ)·P⁻¹."""
    t = {k: _u32(v) for k, v in T_fops.moddown_tables(params, level, CPU).items()}
    mod2, mod3 = Mod(t["q"], 2), Mod(t["q"], 3)
    out = []
    for c in range(pc.shape[0]):
        y = modup_pass_a(pc[c], 0, params.alpha, t["p_q"], t["bh"], t["w"], t, params.n)
        v = row_ntt_pass(y, t["roots"], mod3, params.n)
        out.append(mod2.montmul((qpart[c].long() - v) % mod2.q, t["pinv"][:, None]))
    return torch.stack(out).int()


def _eq_reference(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("dnum, L", [(2, 5), (4, 7)], ids=["alpha3", "beta4"])
def test_two_pass_mod_up_equals_the_plain_and_reference_versions(dnum, L):
    tp = T_P.make_params(1 << 9, L, dnum, check_security=False)
    rp = R_P.make_params(1 << 9, L, dnum, check_security=False)
    for level in _levels(tp):
        d = _residues((level + 1, tp.n), tp.q_primes[: level + 1], 30 + level)
        got = two_pass_mod_up(d, tp, level)
        assert torch.equal(got, T_href.mod_up_digits_ref(d, tp, level))
        _eq_reference(got, R_href.mod_up_digits_ref(jnp.asarray(d.numpy()), rp, level))


@pytest.mark.parametrize("n_acc", [2, 6], ids=["C2", "C6"])
@pytest.mark.parametrize("dnum, L", [(2, 5), (4, 7)], ids=["alpha3", "beta4"])
def test_two_pass_mod_down_equals_the_plain_and_reference_versions(dnum, L, n_acc):
    tp = T_P.make_params(1 << 9, L, dnum, check_security=False)
    rp = R_P.make_params(1 << 9, L, dnum, check_security=False)
    p_primes = T_poly.primes_for(tp, T_poly.p_idx(tp))
    for level in _levels(tp):
        nq = level + 1
        pc = _residues((n_acc * tp.alpha, tp.n), p_primes * n_acc, 40 + level).reshape(n_acc, tp.alpha, tp.n)
        qpart = _residues((n_acc * nq, tp.n), tp.q_primes[:nq] * n_acc, 50 + level).reshape(n_acc, nq, tp.n)
        got = two_pass_mod_down(pc, qpart, tp, level)
        assert torch.equal(got, T_fref.mod_down_digits_ref(pc, qpart, tp, level))
        _eq_reference(got, R_fref.mod_down_digits_ref(jnp.asarray(pc.numpy()), jnp.asarray(qpart.numpy()), rp, level))


def two_pass_rescale(c0, c1, params, level):
    """rescale.cu's four kernels as they run: the inverse passes over the two
    dropped limbs, then pass A of row c·l + e (the centred conversion folded
    into the twist's montmul: v, or v + (q_e − q_ℓ mod q_e) above ⌊q_ℓ/2⌋)
    and pass B's store (c[e] − ŷ)·q_ℓ⁻¹."""
    t = {k: _u32(v) for k, v in T_rsops.tables(params, level, CPU).items()}
    n = params.n
    q_last, _, half = t["last"].tolist()
    lmod2, lmod3 = Mod(t["last"][:1], 2), Mod(t["last"][:1], 3)
    mod2, mod3 = Mod(t["q"], 2), Mod(t["q"], 3)
    out = []
    for c in (c0, c1):
        y = pass1(_u32(c[level:]), None, t["winv_l"], t["twinv_l"], lmod3, n, inverse=True)
        v = lmod2.montmul(row_ntt_pass(y, t["winv_l"], lmod3, n), t["twist_l"])  # (1, N) coefficients
        assert int(v.max()) < q_last
        a = torch.where(v > half, v + t["neg"][:, None], v)  # (l, N), each below 2^32
        assert int(a.max()) < 1 << 32
        yhat = row_ntt_pass(pass1(a, t["psi"], t["roots"], t["tw"], mod3, n, inverse=False), t["roots"], mod3, n)
        out.append(mod2.montmul((_u32(c[:level]) - yhat) % mod2.q, t["qlinv"][:, None]))
    return torch.stack(out).int()


@pytest.mark.parametrize("logn, L, dnum", [(8, 6, 2), (9, 13, 2), (10, 5, 1)])
def test_two_pass_rescale_equals_the_plain_and_reference_versions(logn, L, dnum):
    tp = T_P.make_params(1 << logn, L, dnum, check_security=False)
    rp = R_P.make_params(1 << logn, L, dnum, check_security=False)
    rctx = R_Ctx(params=rp, policy=R_Policy(backend="ref"))
    for level in sorted({L, L // 2, 1}):
        qs = tp.q_primes[: level + 1]
        c0, c1 = (_residues((level + 1, tp.n), qs, 60 + level + k) for k in range(2))
        got = two_pass_rescale(c0, c1, tp, level)
        assert torch.equal(got, torch.stack(T_rsref.rescale_ref(c0, c1, tp, level)))
        ref = R_ops._rescale(rctx, R_ops.Ciphertext(c0=jnp.asarray(c0.numpy()), c1=jnp.asarray(c1.numpy()),
                                                    level=level, scale=2.0 ** 40))
        _eq_reference(got, np.stack([np.asarray(ref.c0), np.asarray(ref.c1)]))
