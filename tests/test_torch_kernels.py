"""Plain PyTorch versions of the port's kernels against the reference
package's refs: modops, NTT, BConv, the fused key-switch regions and the
hoisted-rotation ModUp and Galois MAC.

Inputs are made with numpy from fixed seeds and handed to both packages; every
comparison is exact (RNS arithmetic has no rounding)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fhe import keys as R_K
from repro.fhe import keyswitch as R_KS
from repro.fhe import ntt as R_ntt
from repro.fhe import params as R_P
from repro.fhe import poly as R_poly
from repro.kernels.bconv import ref as R_bconv
from repro.kernels.fusedks import ops as R_fops
from repro.kernels.hoistrot import ref as R_hoistref
from repro.kernels.modops import ref as R_mod
from repro.kernels.ntt import ref as R_nttref
from repro_torch.fhe import ntt as T_ntt
from repro_torch.fhe import params as T_P
from repro_torch.fhe import poly as T_poly
from repro_torch.fhe import rns as T_rns
from repro_torch.kernels import cuda, dispatch
from repro_torch.kernels.bconv import ops as T_bconv
from repro_torch.kernels.bsgsmac import ops as T_bsgsmac
from repro_torch.kernels.fusedks import ops as T_fops
from repro_torch.kernels.hoistrot import ops as T_hops
from repro_torch.kernels.hoistrot import ref as T_hoistref
from repro_torch.kernels.modops import ops as T_mo
from repro_torch.kernels.ntt import ops as T_nttops
from repro_torch.kernels.rescale import ops as T_rescale

torch.set_num_threads(1)


def _residues(rng, shape, primes):
    q = np.array(primes, np.uint64).reshape(-1, 1)
    return (rng.integers(0, 1 << 31, size=shape, dtype=np.uint64) % q).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy().astype(np.int64), np.asarray(ref).astype(np.int64))


# ---------------------------------------------------------------------------
# modops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 256), (2, 3, 512), (2, 2, 3, 256)], ids=str)
@pytest.mark.parametrize("op", ["mulmod", "addmod", "submod"])
def test_modops_plain_matches_reference(shape, op):
    rng = np.random.default_rng(sum(shape))
    qs = T_P.master_chain(shape[-2])
    a, b = _residues(rng, shape, qs), _residues(rng, shape, qs)
    port_fn = {"mulmod": T_mo.pointwise_mulmod, "addmod": T_mo.pointwise_addmod,
               "submod": T_mo.pointwise_submod}[op]
    ref_fn = {"mulmod": R_mod.mulmod_ref, "addmod": R_mod.addmod_ref, "submod": R_mod.submod_ref}[op]
    with dispatch.count_dispatches() as c:
        got = port_fn(_t(a), _t(b), qs)
    assert c == {op: 1}
    assert got.dtype == torch.int32 and got.shape == shape
    _eq(got, ref_fn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(np.array(qs, np.uint32))))


def test_modops_takes_expanded_per_limb_constants():
    """A stride-0 broadcast (what `_scale_limbs` passes) reads like its copy."""
    rng = np.random.default_rng(1)
    qs = T_P.master_chain(3)
    a = _t(_residues(rng, (3, 256), qs))
    c = _t(_residues(rng, (3, 1), qs))
    got = T_mo.pointwise_mulmod(a, c.expand(3, 256), qs)
    assert torch.equal(got, T_mo.pointwise_mulmod(a, c.expand(3, 256).contiguous(), qs))


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU launches a kernel or raises: here, raises."""
    qs = T_P.master_chain(2)
    a = torch.empty((2, 256), dtype=torch.int32, device="meta")
    launches = (T_mo.KERNEL.launches, T_nttops.KERNEL.launches)
    with pytest.raises(ValueError, match="CUDA"):
        T_mo.pointwise_mulmod(a, a, qs)
    with pytest.raises(ValueError, match="CUDA"):
        T_nttops.ntt_fwd(a, T_ntt.build_plan(256, qs))
    with pytest.raises(ValueError, match="CUDA"):
        T_bconv.bconv(a, np.ones((2, 3), np.uint32), T_P.master_chain(3))
    p = T_P.make_params(1 << 8, 2, 1, check_security=False)
    with pytest.raises(ValueError, match="CUDA"):
        T_hops.mod_up_digits(torch.empty((3, 256), dtype=torch.int32, device="meta"), p, 2)
    with pytest.raises(ValueError, match="CUDA"):
        T_hops.galois_mac(torch.empty((1, 4, 256), dtype=torch.int32, device="meta"),
                          torch.empty((1, 1, 2, 4, 256), dtype=torch.int32, device="meta"), p, 2)
    meta = lambda *shape: torch.empty(shape, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        T_bsgsmac.bsgs_mac(meta(3, 2, 256), meta(2, 2, 2, 256), meta(3), meta(3), qs)
    with pytest.raises(ValueError, match="CUDA"):
        T_rescale.rescale(meta(3, 256), meta(3, 256), p, 2)
    assert (T_mo.KERNEL.launches, T_nttops.KERNEL.launches) == launches
    assert (T_bconv.KERNEL.launches, T_hops.HOIST_MODUP.launches, T_hops.HOIST_MAC.launches) == (0, 0, 0)
    assert T_bsgsmac.KERNEL.launches == T_rescale.KERNEL.launches == 0


def test_u32_tensor_keeps_bit_patterns():
    vals = np.array([0, 1, (1 << 31) - 1, 1 << 31, 0xFFFFFFFF], np.uint64)
    t = cuda.u32_tensor(vals, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy().view(np.uint32), vals.astype(np.uint32))
    q = T_P.master_chain(2)
    np.testing.assert_array_equal(cuda.mont_form(np.array([[1], [2]]), q)[:, 0],
                                  [(1 << 32) % q[0], (2 << 32) % q[1]])


def test_kernel_library_names_follow_sources():
    """Each source builds into its own library, named by a hash of the sources."""
    names = {src: cuda.library_path(src).name for src in cuda.SOURCES}
    assert len(set(names.values())) == len(cuda.SOURCES)
    for src, name in names.items():
        assert name.startswith("lib" + src.removesuffix(".cu") + "-") and name.endswith(".so")
    assert (cuda.CSRC / "montgomery.cuh").exists()
    assert cuda.BUILD_DIR.parts[-2:] == ("build", "repro_torch")


# ---------------------------------------------------------------------------
# NTT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("logn", [8, 9, 10, 11])
def test_ntt_plain_fwd_inv_roundtrip_match_reference(logn):
    n = 1 << logn
    primes = T_P.master_chain(4)
    tplan, rplan = T_ntt.build_plan(n, primes), R_ntt.build_plan(n, primes)
    rng = np.random.default_rng(logn)
    x = _residues(rng, (2, 4, n), primes)
    fwd = T_nttops.ntt_fwd(_t(x), tplan)
    _eq(fwd, R_nttref.ntt_fwd_ref(jnp.asarray(x), rplan))
    inv = T_nttops.ntt_inv(_t(x), tplan)
    _eq(inv, R_nttref.ntt_inv_ref(jnp.asarray(x), rplan))
    assert torch.equal(T_nttops.ntt_inv(fwd, tplan), _t(x))
    # fewer limbs than the plan: the first rows of its tables
    _eq(T_nttops.ntt_fwd(_t(x[0, :2]), tplan), R_nttref.ntt_fwd_ref(jnp.asarray(x[0, :2]), rplan))


def test_ntt_plain_matches_schoolbook_product():
    n = 256
    q = T_P.master_chain(1)
    plan = T_ntt.build_plan(n, q)
    rng = np.random.default_rng(3)
    a, b = _residues(rng, (1, n), q), _residues(rng, (1, n), q)
    prod = T_mo.pointwise_mulmod(T_nttops.ntt_fwd(_t(a), plan), T_nttops.ntt_fwd(_t(b), plan), q)
    got = T_nttops.ntt_inv(prod, plan)
    want = R_nttref.negacyclic_mul_schoolbook(a[0], b[0], q[0])
    np.testing.assert_array_equal(got[0].numpy().astype(np.uint64), want)


# ---------------------------------------------------------------------------
# BConv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,m", [(1, 4), (3, 9), (7, 21), (16, 20)])
def test_bconv_plain_matches_reference(k, m):
    chain = T_P.master_chain(k + m)
    rng = np.random.default_rng(k * m)
    xhat = _residues(rng, (k, 512), chain[:k])
    w = _residues(rng, (k, m), [chain[k]] * k)
    cs = chain[k:]
    with dispatch.count_dispatches() as c:
        got = T_bconv.bconv(_t(xhat), w, cs)
    assert c == {"bconv": 1}
    _eq(got, R_bconv.bconv_ref(jnp.asarray(xhat), jnp.asarray(w), jnp.asarray(np.array(cs, np.uint32))))


# ---------------------------------------------------------------------------
# fused key-switch regions (mirrors tests/test_fusedks.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[1, 2, 3], ids=lambda d: f"dnum{d}")
def ks_pair(request):
    rp = R_P.make_params(1 << 9, 5, request.param, check_security=False)
    tp = T_P.make_params(1 << 9, 5, request.param, check_security=False)
    rlk = R_K.relin_keygen(rp, R_K.keygen(rp, 0))
    return rp, tp, np.asarray(rlk.k)


def test_key_switch_digits_plain_matches_reference(ks_pair):
    rp, tp, rlk = ks_pair
    for level in sorted({rp.L, rp.alpha - 1, min(rp.L, rp.alpha), 0}):
        rng = np.random.default_rng(7 + level)
        d = _residues(rng, (level + 1, rp.n), rp.q_primes[: level + 1])
        d_coeff = R_poly.to_coeff(jnp.asarray(d), rp, R_poly.q_idx(rp, level), "ref")
        ksk_sel = np.asarray(R_KS._select_ksk(R_K.SwitchingKey(k=jnp.asarray(rlk)), rp, level, rp.beta(level)))
        r0, r1 = R_fops.key_switch_digits(d_coeff, jnp.asarray(ksk_sel), rp, level, backend="ref")
        with dispatch.count_dispatches() as c:
            t0, t1 = T_fops.key_switch_digits(_t(d_coeff), _t(ksk_sel), tp, level)
        assert c == {"fusedks": 1}  # the plain version records nothing of its own
        _eq(t0, r0)
        _eq(t1, r1)


def test_mod_down_digits_plain_matches_reference(ks_pair):
    rp, tp, _ = ks_pair
    for level in sorted({rp.L, 0}):
        rng = np.random.default_rng(5 + level)
        p_coeff = _residues(rng, (2, rp.alpha, rp.n), R_poly.primes_for(rp, R_poly.p_idx(rp)))
        q_part = _residues(rng, (2, level + 1, rp.n), rp.q_primes[: level + 1])
        ref = R_fops.mod_down_digits(jnp.asarray(p_coeff), jnp.asarray(q_part), rp, level, backend="ref")
        with dispatch.count_dispatches() as c:
            got = T_fops.mod_down_digits(_t(p_coeff), _t(q_part), tp, level)
        assert c == {"fused_moddown": 1}
        _eq(got, ref)


def test_fused_tables_are_the_montgomery_forms_of_the_bconv_tables(ks_pair):
    _, tp, _ = ks_pair
    level = tp.L
    t = T_fops.ks_tables(tp, level, torch.device("cpu"))
    ext = T_poly.primes_for(tp, T_poly.ext_idx(tp, level))
    w = t["w"].numpy().view(np.uint32).astype(np.uint64)
    assert w.shape == (level + 1, len(ext))
    for j in range(tp.beta(level)):
        digit_idx, _, _, bhat_inv, wj = T_rns.digit_tables(tp, level, j)
        for r, s in enumerate(digit_idx):
            for e, c in enumerate(ext):
                assert int(w[s, e]) == (int(wj[r, e]) << 32) % c
            assert int(t["bh"][s]) == (int(bhat_inv[r]) << 32) % tp.q_primes[s]


# ---------------------------------------------------------------------------
# hoisted-rotation regions (mirrors the ref half of tests/test_hoisting.py)
# ---------------------------------------------------------------------------


def test_mod_up_digits_plain_matches_reference(ks_pair):
    rp, tp, _ = ks_pair
    for level in sorted({rp.L, rp.alpha - 1, min(rp.L, rp.alpha), 0}):
        rng = np.random.default_rng(11 + level)
        d = _residues(rng, (level + 1, rp.n), rp.q_primes[: level + 1])
        with dispatch.count_dispatches() as c:
            got = T_hops.mod_up_digits(_t(d), tp, level)
        assert c == {"hoistmodup": 1}  # the plain version records nothing of its own
        assert got.shape == (tp.beta(level), level + 1 + tp.alpha, tp.n)
        _eq(got, R_hoistref.mod_up_digits_ref(jnp.asarray(d), rp, level))
        _eq(T_hoistref.mod_up_digits_ref(_t(d), tp, level), R_hoistref.mod_up_digits_ref(jnp.asarray(d), rp, level))


@pytest.mark.parametrize("nrot", [1, 3])
def test_galois_mac_plain_matches_reference(ks_pair, nrot):
    rp, tp, _ = ks_pair
    for level in sorted({rp.L, rp.alpha - 1, 0}):
        ext = R_poly.primes_for(rp, R_poly.ext_idx(rp, level))
        beta, m = rp.beta(level), len(ext)
        rng = np.random.default_rng(17 * nrot + level)
        dig = _residues(rng, (beta * m, rp.n), ext * beta).reshape(beta, m, rp.n)
        ksk = _residues(rng, (nrot * beta * 2 * m, rp.n), ext * (nrot * beta * 2)).reshape(nrot, beta, 2, m, rp.n)
        want = R_hoistref.galois_mac_ref(jnp.asarray(dig), jnp.asarray(ksk), rp, level)
        with dispatch.count_dispatches() as c:
            got = T_hops.galois_mac(_t(dig), _t(ksk), tp, level)
        assert c == {"hoistmac": 1}
        _eq(got, want)
        with dispatch.count_dispatches() as c:
            staged = T_hops.galois_mac(_t(dig), _t(ksk), tp, level, staged=True)
        assert c == {"mulmod": 2 * beta * nrot, "addmod": 2 * beta * nrot}  # one launch per MAC step
        _eq(staged, want)
