"""The port's rotation slice against the reference package on the CPU.

Galois keys, ``rotate``, ``conjugate``, ``rotate_hoisted`` (with reused
``HoistedDigits``) and ``rotate_hoisted_group`` must give the reference's bytes
exactly at every backend, with the same ``fhe.trace`` stream and the same
kernel-dispatch counts; the reference's fused and kernel backends run in Pallas
interpret mode, as its own tests run them.  The dispatch contracts are those of
``tests/test_hoisting.py``: 5 + k launches for a fused hoisted group of k
rotations against 5k for k standard rotations, and β + 2k forward NTTs on the
staged pipeline against k·(β + 2).  The last test runs a hoisted group at the
``lstm`` preset's full width (N = 2^16) against the digest ``chip_smoke.py``
checks on the card."""

import dataclasses
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fhe import keys as R_K
from repro.fhe import keyswitch as R_KS
from repro.fhe import ntt as R_ntt
from repro.fhe import ops as R_ops
from repro.fhe import params as R_P
from repro.fhe import poly as R_poly
from repro.fhe import trace as R_trace
from repro.fhe.context import ExecPolicy as R_Policy
from repro.fhe.context import FheContext as R_Ctx
from repro.kernels import dispatch as R_dispatch
from repro_torch.fhe import convert
from repro_torch.fhe import keys as T_K
from repro_torch.fhe import keyswitch as T_KS
from repro_torch.fhe import ntt as T_ntt
from repro_torch.fhe import ops as T_ops
from repro_torch.fhe import params as T_P
from repro_torch.fhe import poly as T_poly
from repro_torch.fhe import trace as T_trace
from repro_torch.fhe.context import ExecPolicy as T_Policy
from repro_torch.fhe.context import FheContext as T_Ctx
from repro_torch.kernels import dispatch as T_dispatch

torch.set_num_threads(1)

CPU = "cpu"
ROTS = (1, 2, 3, 5, 7)
BACKENDS = ("ref", "staged", "fused", "kernel")


def _np(x):
    return np.asarray(x).astype(np.int64)


def _ct_eq(port, ref):
    np.testing.assert_array_equal(port.c0.numpy().astype(np.int64), _np(ref.c0))
    np.testing.assert_array_equal(port.c1.numpy().astype(np.int64), _np(ref.c1))
    assert (port.level, port.scale) == (ref.level, ref.scale)


def _same(a, b) -> bool:
    return torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1)


def _stream(instrs):
    return [(i.op, i.n, i.limbs, i.meta) for i in instrs]


@dataclasses.dataclass
class HSet:
    rp: object
    rks: object
    rctx: object
    rct: object
    tp: object
    tks: object
    tctx: object
    tct: object
    z: np.ndarray

    def tctx_at(self, backend, **changes):
        return self.tctx.with_policy(backend=backend, **changes)

    def rctx_at(self, backend, **changes):
        return self.rctx.with_policy(backend=backend, **changes)


@pytest.fixture(scope="module", params=[1, 2, 3], ids=lambda d: f"dnum{d}")
def hset(request):
    rp = R_P.make_params(1 << 9, 5, request.param, check_security=False)
    tp = T_P.make_params(1 << 9, 5, request.param, check_security=False)
    rks = R_K.full_keyset(rp, seed=0, rotations=ROTS, conjugate=True)
    tks = T_K.full_keyset(tp, seed=0, rotations=ROTS, conjugate=True, device=CPU)
    z = np.random.default_rng(7).normal(size=rp.slots) * 0.3
    rctx = R_Ctx(params=rp, keys=rks, policy=R_Policy(backend="ref"))
    tctx = T_Ctx(params=tp, keys=tks, policy=T_Policy(backend="ref"), device=CPU)
    return HSet(rp, rks, rctx, rctx.encrypt(rctx.encode(z)), tp, tks, tctx, tctx.encrypt(tctx.encode(z)), z)


# ---------------------------------------------------------------------------
# Galois keys
# ---------------------------------------------------------------------------


def test_galois_keys_bit_identical(hset):
    h = hset
    assert T_K.galois_elements(h.tp, ROTS, conjugate=True) == R_K.galois_elements(h.rp, ROTS, conjugate=True)
    assert sorted(h.tks.gks) == sorted(h.rks.gks)
    for t, key in h.tks.gks.items():
        assert key.k.dtype == torch.int32 and key.nbytes == h.rks.galois(t).nbytes
        np.testing.assert_array_equal(key.k.numpy().astype(np.int64), _np(h.rks.galois(t).k))
    with pytest.raises(KeyError):
        h.tks.galois(3)
    assert "hoist_cache" not in repr(h.tks)


def test_galois_keygen_trace_and_dispatches_match():
    rp = R_P.make_params(1 << 9, 3, 2, check_security=False)
    tp = T_P.make_params(1 << 9, 3, 2, check_security=False)
    with R_trace.capture_trace() as rt, R_dispatch.count_dispatches() as rc:
        R_K.full_keyset(rp, seed=3, rotations=(1, 4), conjugate=True)
    with T_trace.capture_trace() as tt, T_dispatch.count_dispatches() as tc:
        T_K.full_keyset(tp, seed=3, rotations=(1, 4), conjugate=True, device=CPU)
    assert _stream(tt) == _stream(rt)
    assert tc == rc


def test_full_keyset_no_overgeneration():
    p = T_P.make_params(1 << 9, 3, 2, check_security=False)
    rots = (0, 1, 2, 1 + p.slots, 2 + 2 * p.slots)
    ks = T_K.full_keyset(p, seed=0, rotations=rots, conjugate=True, device=CPU)
    assert tuple(sorted(ks.gks)) == T_K.galois_elements(p, rots, conjugate=True)
    assert len(ks.gks) == 3


def test_galois_eval_perm_and_automorphism_match_reference():
    n = 1 << 9
    for t in (5, 25, 2 * n - 1, pow(5, 7, 2 * n)):
        np.testing.assert_array_equal(T_ntt.galois_eval_perm(n, t), R_ntt.galois_eval_perm(n, t))
    x = np.random.default_rng(0).integers(0, 1 << 30, size=(3, n)).astype(np.uint32)
    with T_trace.capture_trace() as tt:
        got = T_poly.automorphism_eval(torch.from_numpy(x.astype(np.int32)), n, 25)
    with R_trace.capture_trace() as rt:
        want = R_poly.automorphism_eval(jnp.asarray(x), n, 25)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), _np(want))
    assert _stream(tt) == _stream(rt)


def test_keyset_from_arrays_carries_galois_keys(hset):
    h = hset
    arrays = dict(s_coeff=h.rks.sk.s_coeff, s_eval=np.asarray(h.rks.sk.s_eval), pk_b=np.asarray(h.rks.pk.b),
                  pk_a=np.asarray(h.rks.pk.a), rlk=np.asarray(h.rks.rlk.k),
                  gks={t: np.asarray(k.k) for t, k in h.rks.gks.items()})
    ks = convert.keyset_from_arrays(h.tp, arrays, device=CPU)
    assert sorted(ks.gks) == sorted(h.tks.gks)
    for t in ks.gks:
        assert torch.equal(ks.galois(t).k, h.tks.galois(t).k)
    ctx = T_Ctx(params=h.tp, keys=ks, policy=T_Policy(backend="fused"), device=CPU)
    _ct_eq(ctx.rotate(h.tct, 3), h.rctx.rotate(h.rct, 3))
    bad = dict(arrays, gks={5: np.asarray(h.rks.rlk.k)[:, :1]})
    with pytest.raises(ValueError, match="galois key 5"):
        convert.keyset_from_arrays(h.tp, bad, device=CPU)


# ---------------------------------------------------------------------------
# rotations at every backend: bytes, traces and dispatches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_rotations_match_reference_with_equal_trace_and_dispatches(hset, backend):
    h = hset
    _ct_eq(h.tct, h.rct)
    tctx, rctx = h.tctx_at(backend), h.rctx_at(backend)
    rots = ROTS[:3]
    calls = (
        ("group", lambda c, x: c.rotate_hoisted_group(x, rots)),
        ("rotate", lambda c, x: c.rotate(x, 5)),
        ("conjugate", lambda c, x: c.conjugate(x)),
        ("rotate_hoisted", lambda c, x: c.rotate_hoisted(x, 7)),
    )
    for name, call in calls:
        with T_trace.capture_trace() as tt, T_dispatch.count_dispatches() as tc:
            got = call(tctx, h.tct)
        with R_trace.capture_trace() as rt, R_dispatch.count_dispatches() as rc:
            want = call(rctx, h.rct)
        if name == "group":
            assert list(got) == list(want) == list(rots)
            for r in rots:
                _ct_eq(got[r], want[r])
        else:
            _ct_eq(got, want)
        assert _stream(tt) == _stream(rt), name
        assert tc == rc, name


@pytest.mark.parametrize("backend", BACKENDS)
def test_rotations_at_a_lower_level_equal_the_reference_oracle(hset, backend):
    h = hset
    level = max(1, h.tp.alpha - 1)
    tc, rc = T_ops.level_drop(h.tct, level), R_ops.level_drop(h.rct, level)
    tctx = h.tctx_at(backend)
    group = tctx.rotate_hoisted_group(tc, ROTS + (0, h.tp.slots + 1))
    assert group[0] is tc
    for r in ROTS:
        want = h.rctx.rotate(rc, r)
        _ct_eq(group[r], want)
        _ct_eq(tctx.rotate(tc, r), want)
    _ct_eq(group[h.tp.slots + 1], h.rctx.rotate(rc, 1))
    _ct_eq(tctx.conjugate(tc), h.rctx.conjugate(rc))
    assert tctx.rotate(tc, h.tp.slots) is tc


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_hoisted_digits_reused_across_calls(hset, backend):
    """A precomputed ``HoistedDigits`` skips the ModUp: only the ModDown's two
    forward NTTs (staged) or one ModDown launch (fused) remain per rotation."""
    h = hset
    rhd = R_KS.hoisted_mod_up(h.rct.c1, h.rp, h.rp.L, backend="ref")
    hd = T_KS.hoisted_mod_up(h.tct.c1, h.tp, h.tp.L, fused=backend == "fused")
    assert hd.beta == h.tp.beta(h.tp.L) and hd.level == h.tp.L
    np.testing.assert_array_equal(hd.digits.numpy().astype(np.int64), _np(rhd.digits))
    tctx = h.tctx_at(backend)
    for r in (2, 5):
        with T_dispatch.count_dispatches() as c:
            out = tctx.rotate_hoisted(h.tct, r, hoisted=hd)
        if backend == "ref":
            assert c.get("ntt", 0) == 2 and c.get("intt", 0) == 2
        else:
            assert c == {"hoistmac": 1, "intt": 1, "fused_moddown": 1, "addmod": 1}
        _ct_eq(out, h.rctx.rotate_hoisted(h.rct, r, hoisted=rhd))


def test_hoisting_modes_are_bit_exact(hset):
    h = hset
    std = h.tctx.rotate(h.tct, 3)
    for mode in ("always", "auto", "never"):
        assert _same(h.tctx_at("fused", hoisting=mode).rotate(h.tct, 3), std)
    assert _same(h.tctx.rotate_hoisted(h.tct, 3), std)
    with pytest.raises(ValueError):
        h.tctx.with_policy(hoisting="sometimes")


def test_rotation_values_correct(hset):
    h = hset
    group = h.tctx.rotate_hoisted_group(h.tct, (1, 5))
    for r in (1, 5):
        np.testing.assert_allclose(h.tctx.decrypt_decode(group[r]).real, np.roll(h.z, -r), atol=2e-2)
    np.testing.assert_allclose(h.tctx.decrypt_decode(h.tctx.conjugate(h.tct)).real, h.z, atol=2e-2)


# ---------------------------------------------------------------------------
# dispatch counts: the amortisation (β + O(1) vs k·β)
# ---------------------------------------------------------------------------


def test_group_kernel_dispatches_amortised(hset):
    h = hset
    ctx = h.tctx_at("fused")
    k = len(ROTS)
    with T_dispatch.count_dispatches() as ch:
        ctx.rotate_hoisted_group(h.tct, ROTS)
    with T_dispatch.count_dispatches() as cs:
        for r in ROTS:
            ctx.rotate(h.tct, r)
    assert ch == {"intt": 2, "hoistmodup": 1, "hoistmac": 1, "fused_moddown": 1, "addmod": k}
    assert T_dispatch.total(ch) == 5 + k
    assert cs["fusedks"] == k and cs["fused_moddown"] == k
    assert T_dispatch.total(cs) == 5 * k


def test_staged_ntt_launches_beta_plus_two_k(hset):
    h = hset
    beta, k = h.tp.beta(h.tp.L), len(ROTS)
    m = h.tp.L + 1 + h.tp.alpha
    for backend in ("ref", "staged"):
        ctx = h.tctx_at(backend)
        with T_dispatch.count_dispatches() as ch, T_trace.capture_trace() as th:
            ctx.rotate_hoisted_group(h.tct, ROTS)
        with T_dispatch.count_dispatches() as cs, T_trace.capture_trace() as ts:
            for r in ROTS:
                ctx.rotate(h.tct, r)
        assert ch["ntt"] == beta + 2 * k and ch["bconv"] == beta + 2 * k
        assert cs["ntt"] == k * (beta + 2)
        assert "hoistmodup" not in ch and "hoistmac" not in ch
        ext_ntts = lambda t: sum(1 for i in t if i.op == "NTT" and i.limbs == m)
        assert ext_ntts(th) == beta and ext_ntts(ts) == k * beta


# ---------------------------------------------------------------------------
# the hoisted-key cache: a byte-bounded LRU per KeySet
# ---------------------------------------------------------------------------


def test_hoisted_ksk_matches_reference_and_is_cached(hset):
    h = hset
    t = pow(5, 3, 2 * h.tp.n)
    h.tks.hoist_cache.clear()
    a = T_KS.hoisted_ksk(h.tp, h.tks, t, h.tp.L)
    np.testing.assert_array_equal(a.numpy().astype(np.int64), _np(R_KS.hoisted_ksk(h.rp, h.rks, t, h.rp.L)))
    assert T_KS.hoisted_ksk(h.tp, h.tks, t, h.tp.L) is a
    assert (t, h.tp.L) in h.tks.hoist_cache
    assert T_KS.HOIST_KSK_CACHE_BYTES == R_KS.HOIST_KSK_CACHE_BYTES


def test_hoisted_ksk_lru_evicts_by_bytes(hset, monkeypatch):
    h = hset
    level = h.tp.L
    ts = [pow(5, r, 2 * h.tp.n) for r in (1, 2, 3)]
    entry = h.tp.beta(level) * 2 * (level + 1 + h.tp.alpha) * h.tp.n * 4
    cache = h.tks.hoist_cache
    cache.clear()
    monkeypatch.setattr(T_KS, "HOIST_KSK_CACHE_BYTES", 2 * entry)
    first = T_KS.hoisted_ksk(h.tp, h.tks, ts[0], level)
    T_KS.hoisted_ksk(h.tp, h.tks, ts[1], level)
    assert T_KS.hoisted_ksk(h.tp, h.tks, ts[0], level) is first  # a hit moves ts[0] to the MRU end
    assert list(cache) == [(ts[1], level), (ts[0], level)]
    T_KS.hoisted_ksk(h.tp, h.tks, ts[2], level)  # evicts the LRU entry, ts[1]
    assert list(cache) == [(ts[0], level), (ts[2], level)]
    monkeypatch.setattr(T_KS, "HOIST_KSK_CACHE_BYTES", entry - 1)
    cache.clear()
    big = T_KS.hoisted_ksk(h.tp, h.tks, ts[1], level)  # larger than the budget: returned, not cached
    assert not cache
    assert torch.equal(big, T_KS.hoisted_ksk(h.tp, h.tks, ts[1], level))
    cache.clear()


# ---------------------------------------------------------------------------
# policy and context surface
# ---------------------------------------------------------------------------


def test_policy_resolved_views_match_reference(hset):
    # A CPU context resolves "auto" as the reference does on a host without a
    # TPU, whether or not this host has a card.
    for backend in ("fused", "kernel", "staged", "ref", "auto"):
        for hoisting in ("never", "auto", "always"):
            t = hset.tctx.with_policy(backend=backend, hoisting=hoisting)
            r = R_Policy(backend=backend, hoisting=hoisting)
            assert (t.stage, t.plan_fused, t.policy.plan_hoist) == (r.stage, r.plan_fused, r.plan_hoist)


def test_hook_observes_every_rotation_dispatch(hset):
    h = hset
    seen = []
    ctx = h.tctx.with_policy(backend="fused", dispatch_hook=seen.append)
    with T_dispatch.count_dispatches() as c:
        ctx.rotate_hoisted_group(h.tct, ROTS)
        ctx.conjugate(h.tct)
    assert len(seen) == T_dispatch.total(c) and set(seen) == set(c)


# ---------------------------------------------------------------------------
# the lstm preset at full width (N = 2^16): the group chip_smoke.py checks
# ---------------------------------------------------------------------------


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_lstm_hoisted_group_full_width_matches_reference_digest():
    chip_smoke = _chip_smoke()
    ref = chip_smoke.LSTM_GROUP
    p = T_P.workload_params("lstm")
    ctx = T_Ctx(params=p, keys=T_K.full_keyset(p, seed=0, rotations=ref["rotations"], device=CPU),
                policy=T_Policy(backend="fused"), device=CPU)
    z = np.random.default_rng(0).normal(size=p.slots) * 0.4
    ct = ctx.encrypt(ctx.encode(z))
    with T_dispatch.count_dispatches() as c:
        g = ctx.rotate_hoisted_group(ct, ref["rotations"])
    assert T_dispatch.total(c) == 5 + len(ref["rotations"])
    assert chip_smoke.digest(*(g[r] for r in ref["rotations"])) == ref["digest"]
    assert _same(ctx.rotate(ct, 1), g[1])
    for r, want in zip(ref["rotations"], ref["decode_errors"]):
        assert abs(float(np.max(np.abs(ctx.decrypt_decode(g[r]) - np.roll(z, -r)))) - want) <= 1e-9
