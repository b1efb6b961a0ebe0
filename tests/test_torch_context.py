"""The port's CKKS main path against the reference package on the CPU.

Keys from the same seed, ciphertexts from the same encryption seed, and
``ctx.mul`` at every backend must give the reference's bytes exactly, with the
same ``fhe.trace`` stream and the same kernel-dispatch counts.  The last test
runs the ``matmul`` preset at its full width and checks the digest that
``chip_smoke.py`` checks on the card."""

import hashlib
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import reference_rescale
import torch

from repro.fhe import keys as R_K
from repro.fhe import keyswitch as R_KS
from repro.fhe import params as R_P
from repro.fhe import trace as R_trace
from repro.fhe.context import ExecPolicy as R_Policy
from repro.fhe.context import FheContext as R_Ctx
from repro.kernels import dispatch as R_dispatch
from repro_torch.fhe import convert
from repro_torch.fhe import context as T_context
from repro_torch.fhe import keys as T_K
from repro_torch.fhe import keyswitch as T_KS
from repro_torch.fhe import ops as T_ops
from repro_torch.fhe import params as T_P
from repro_torch.fhe import poly as T_poly
from repro_torch.fhe import trace as T_trace
from repro_torch.fhe.context import ExecPolicy as T_Policy
from repro_torch.fhe.context import FheContext as T_Ctx
from repro_torch.kernels import dispatch as T_dispatch

torch.set_num_threads(1)

CPU = "cpu"
BOUNDARY = ("STORE_WS", "LOAD_WS")


def _np(x):
    return np.asarray(x).astype(np.int64)


def _ct_eq(port, ref):
    np.testing.assert_array_equal(port.c0.numpy().astype(np.int64), _np(ref.c0))
    np.testing.assert_array_equal(port.c1.numpy().astype(np.int64), _np(ref.c1))
    assert (port.level, port.scale) == (ref.level, ref.scale)


def _stream(instrs):
    return [(i.op, i.n, i.limbs, i.meta) for i in instrs]


def _key_arrays(ks):
    return dict(s_coeff=ks.sk.s_coeff, s_eval=np.asarray(ks.sk.s_eval), pk_b=np.asarray(ks.pk.b),
                pk_a=np.asarray(ks.pk.a), rlk=np.asarray(ks.rlk.k))


@pytest.fixture(scope="module")
def pair():
    """(reference params, keys, context), (port params, keys), and one message."""
    rp = R_P.make_params(1 << 9, 6, 2, check_security=False)
    tp = T_P.make_params(1 << 9, 6, 2, check_security=False)
    rks = R_K.full_keyset(rp, seed=0)
    tks = T_K.full_keyset(tp, seed=0, device=CPU)
    z = np.random.default_rng(0).normal(size=rp.slots) * 0.4
    rctx = R_Ctx(params=rp, keys=rks, policy=R_Policy(backend="ref"))
    rct = rctx.encrypt(rctx.encode(z))
    return rp, rks, rctx, rct, tp, tks, z


def test_full_keyset_is_bit_identical(pair):
    rp, rks, _, _, tp, tks, _ = pair
    np.testing.assert_array_equal(tks.sk.s_coeff, rks.sk.s_coeff)
    for port, ref in ((tks.sk.s_eval, rks.sk.s_eval), (tks.pk.b, rks.pk.b), (tks.pk.a, rks.pk.a),
                      (tks.rlk.k, rks.rlk.k)):
        assert port.dtype == torch.int32 and port.device.type == "cpu"
        np.testing.assert_array_equal(port.numpy().astype(np.int64), _np(ref))
    assert tks.rlk.nbytes == rks.rlk.nbytes


def test_keygen_trace_and_dispatches_match(pair):
    rp, _, _, _, tp, _, _ = pair
    with R_trace.capture_trace() as rt, R_dispatch.count_dispatches() as rc:
        R_K.full_keyset(rp, seed=4)
    with T_trace.capture_trace() as tt, T_dispatch.count_dispatches() as tc:
        T_K.full_keyset(tp, seed=4, device=CPU)
    assert _stream(tt) == _stream(rt)
    assert tc == rc


def test_keyset_and_ciphertext_from_arrays_round_trip(pair):
    rp, rks, rctx, rct, tp, tks, z = pair
    ks = convert.keyset_from_arrays(tp, _key_arrays(rks), device=CPU)
    for a, b in ((ks.sk.s_eval, tks.sk.s_eval), (ks.pk.b, tks.pk.b), (ks.pk.a, tks.pk.a), (ks.rlk.k, tks.rlk.k)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(ks.sk.s_coeff, tks.sk.s_coeff)
    ct = convert.ciphertext_from_arrays(np.asarray(rct.c0), np.asarray(rct.c1), rct.level, rct.scale, device=CPU)
    _ct_eq(ct, rct)
    tctx = T_Ctx(params=tp, keys=ks, policy=T_Policy(backend="fused"), device=CPU)
    _ct_eq(tctx.mul(ct, ct), rctx.mul(rct, rct))
    with pytest.raises(ValueError):
        convert.ciphertext_from_arrays(np.asarray(rct.c0), np.asarray(rct.c1), rct.level + 1, rct.scale, device=CPU)
    bad = dict(_key_arrays(rks), rlk=np.asarray(rks.rlk.k)[:1])
    with pytest.raises(ValueError, match="rlk"):
        convert.keyset_from_arrays(tp, bad, device=CPU)


def test_encode_encrypt_decrypt_bit_identical(pair):
    rp, _, rctx, rct, tp, tks, z = pair
    tctx = T_Ctx(params=tp, keys=tks, device=CPU)
    pt = tctx.encode(z)
    np.testing.assert_array_equal(pt.data.numpy().astype(np.int64), _np(rctx.encode(z).data))
    ct = tctx.encrypt(pt)
    _ct_eq(ct, rct)
    np.testing.assert_array_equal(tctx.decrypt(ct).data.numpy().astype(np.int64), _np(rctx.decrypt(rct).data))
    np.testing.assert_array_equal(tctx.decrypt_decode(ct), rctx.decrypt_decode(rct))


@pytest.mark.parametrize("backend", ["ref", "staged", "fused", "kernel", "auto"])
def test_mul_bit_identical_with_equal_trace_and_dispatches(pair, backend):
    rp, rks, rctx, rct, tp, tks, z = pair
    rref = rctx.mul(rct, rct)
    tctx = T_Ctx(params=tp, keys=tks, policy=T_Policy(backend=backend), device=CPU)
    ct = tctx.encrypt(tctx.encode(z))
    with T_trace.capture_trace() as tt, T_dispatch.count_dispatches() as tc:
        out = tctx.mul(ct, ct)
    _ct_eq(out, rref)
    assert np.max(np.abs(tctx.decrypt_decode(out) - z * z)) < 5e-4
    # the reference at the same backend, where it runs the same pipeline on the CPU
    rbk = {"auto": "ref"}.get(backend, backend)
    with reference_rescale.track() as marks, R_trace.capture_trace() as rt, R_dispatch.count_dispatches() as rc:
        rctx.with_policy(backend=rbk).mul(rct, rct)
    assert _stream(tt) == _stream(rt)
    assert marks.count == 1
    assert tc == (marks.counts(rc) if tctx.plan_fused else rc)
    beta = tp.beta(tp.L)
    ks = 4 if tctx.pipeline == "fused" else 7 * beta + 13
    one = reference_rescale.port_counts(reference_rescale.ONE, 1) if tctx.plan_fused else reference_rescale.ONE
    assert T_dispatch.total(tc) == ks + 4 + 1 + 2 + T_dispatch.total(one)  # products, d1, outputs, rescale


def test_square_rescale_and_additive_ops_match(pair):
    rp, _, rctx, rct, tp, tks, z = pair
    tctx = T_Ctx(params=tp, keys=tks, device=CPU)
    ct = tctx.encrypt(tctx.encode(z))
    rb = rctx.encrypt(rctx.encode(z * 0.5), seed=23)
    tb = tctx.encrypt(tctx.encode(z * 0.5), seed=23)
    _ct_eq(tctx.square(ct), rctx.square(rct))
    _ct_eq(tctx.rescale(tctx.mul(ct, ct, rescale_after=False)), rctx.rescale(rctx.mul(rct, rct, rescale_after=False)))
    _ct_eq(tctx.add(ct, tb), rctx.add(rct, rb))
    _ct_eq(tctx.sub(ct, tb), rctx.sub(rct, rb))
    _ct_eq(tctx.negate(ct), rctx.negate(rct))
    _ct_eq(tctx.add_const(ct, 0.25), rctx.add_const(rct, 0.25))
    _ct_eq(tctx.mul_const(ct, 0.5), rctx.mul_const(rct, 0.5))
    _ct_eq(tctx.add_plain(ct, tctx.encode(z)), rctx.add_plain(rct, rctx.encode(z)))
    _ct_eq(tctx.mul_plain(ct, tctx.encode(z)), rctx.mul_plain(rct, rctx.encode(z)))
    _ct_eq(tctx.level_drop(ct, 3), rctx.level_drop(rct, 3))
    _ct_eq(tctx.mul(ct, tctx.level_drop(tb, 4)), rctx.mul(rct, rctx.level_drop(rb, 4)))
    np.testing.assert_array_equal(tctx.decode(tctx.encode_const(0.5, 3, tp.scale)),
                                  rctx.decode(rctx.encode_const(0.5, 3, rp.scale)))


# ---------------------------------------------------------------------------
# key switch (mirrors tests/test_fusedks.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[1, 2, 3], ids=lambda d: f"dnum{d}")
def ks_pair(request):
    rp = R_P.make_params(1 << 9, 5, request.param, check_security=False)
    tp = T_P.make_params(1 << 9, 5, request.param, check_security=False)
    rlk = R_K.relin_keygen(rp, R_K.keygen(rp, 0))
    trlk = T_K.relin_keygen(tp, T_K.keygen(tp, 0, device=CPU))
    return rp, rlk, tp, trlk


def _rand_eval(p, level, seed):
    rng = np.random.default_rng(seed)
    qs = np.array(p.q_primes[: level + 1], np.uint64)
    return (rng.integers(0, 1 << 31, size=(level + 1, p.n)) % qs[:, None]).astype(np.uint32)


def _fused(backend):
    """The key-switch pipeline a context resolves ``backend`` to on the CPU."""
    return T_KS.resolve_pipeline(backend, CPU)[0] == "fused"


def test_key_switch_every_backend_matches_reference_ref(ks_pair):
    rp, rlk, tp, trlk = ks_pair
    for level in sorted({rp.L, min(rp.L, rp.alpha - 1), min(rp.L, rp.alpha), 0}):
        d = _rand_eval(rp, level, 11 + level)
        r0, r1 = R_KS.key_switch(jnp.asarray(d), rp, level, rlk, backend="ref")
        for backend in ("fused", "staged", "ref"):
            t0, t1 = T_KS.key_switch(torch.from_numpy(d.astype(np.int32)), tp, level, trlk, _fused(backend))
            np.testing.assert_array_equal(t0.numpy().astype(np.int64), _np(r0))
            np.testing.assert_array_equal(t1.numpy().astype(np.int64), _np(r1))


def test_key_switch_dispatches_and_trace_match(ks_pair):
    rp, rlk, tp, trlk = ks_pair
    d = _rand_eval(rp, rp.L, 2)
    beta = tp.beta(tp.L)
    for backend, total in (("fused", 4), ("staged", 7 * beta + 13)):
        with T_dispatch.count_dispatches() as tc, T_trace.capture_trace() as tt:
            T_KS.key_switch(torch.from_numpy(d.astype(np.int32)), tp, tp.L, trlk, _fused(backend))
        assert T_dispatch.total(tc) == total
        with R_dispatch.count_dispatches() as rc, R_trace.capture_trace() as rt:
            R_KS.key_switch(jnp.asarray(d), rp, rp.L, rlk, backend=backend)
        assert tc == rc
        assert _stream(tt) == _stream(rt)
        n_ws = sum(1 for i in tt if i.op in BOUNDARY)
        assert n_ws == (0 if backend == "fused" else 2 * (4 * beta + 2 * 4))


def test_mod_down_pair_fused_matches_staged(ks_pair):
    _, _, tp, _ = ks_pair
    ext = T_poly.primes_for(tp, T_poly.ext_idx(tp, tp.L))
    rng = np.random.default_rng(5)
    acc = rng.integers(0, 1 << 31, size=(2, len(ext), tp.n)) % np.array(ext)[None, :, None]
    a0, a1 = (torch.from_numpy(acc[i].astype(np.int32)) for i in range(2))
    f0, f1 = T_KS.mod_down_pair(a0, a1, tp, tp.L, fused=True)
    assert torch.equal(f0, T_KS.mod_down(a0, tp, tp.L))
    assert torch.equal(f1, T_KS.mod_down(a1, tp, tp.L))


# ---------------------------------------------------------------------------
# policy and context surface
# ---------------------------------------------------------------------------


def test_policy_surface_matches_reference():
    from repro.fhe import context as R_context

    assert T_context.BACKENDS == R_context.BACKENDS
    assert T_context.HOISTING_MODES == R_context.HOISTING_MODES
    assert T_context.NUMERICS_MODES == R_context.NUMERICS_MODES
    for backend in T_context.BACKENDS:
        for hoisting in T_context.HOISTING_MODES:
            assert T_Policy(backend=backend, hoisting=hoisting).policy_key() == R_Policy(
                backend=backend, hoisting=hoisting).policy_key()
    assert T_Policy(dispatch_hook=print) == T_Policy()
    for bad in (dict(backend="tpu"), dict(hoisting="x"), dict(numerics="x"), dict(scheme="bfv")):
        with pytest.raises(ValueError):
            T_Policy(**bad)


def test_resolve_pipeline_follows_the_device():
    assert T_KS.resolve_pipeline("auto", "cuda") == ("fused", "auto")
    assert T_KS.resolve_pipeline("auto", "cpu") == ("staged", "ref")
    for backend in ("fused", "kernel", "staged", "ref"):
        assert T_KS.resolve_pipeline(backend, "cpu") == R_KS.resolve_pipeline(backend)
    with pytest.raises(ValueError):
        T_KS.resolve_pipeline("gpu", "cpu")


def test_context_device_rules(pair, monkeypatch):
    _, _, _, _, tp, tks, _ = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T_Ctx(params=tp)  # the default device is the card: no silent move to the CPU
    ctx = T_Ctx(params=tp, keys=tks, device=CPU)
    assert ctx.device == torch.device("cpu") and ctx.pipeline == "staged"
    assert ctx.with_policy(backend="fused").pipeline == "fused"
    assert ctx.policy_key() == ("ckks", "auto", "auto", "standard")
    with pytest.raises(TypeError):
        ctx.with_policy(T_Policy(), backend="ref")
    with pytest.raises(ValueError, match="KeySet"):
        T_Ctx(params=tp, device=CPU).encrypt(ctx.encode(np.zeros(4)))
    assert T_Ctx(params=T_P.workload_params("psi"), device=CPU).policy_key()[0] == "bgv"  # BGV is ported
    for name in ("bootstrap", "eval_poly"):  # polyeval and bootstrap are ported
        assert hasattr(ctx, name)
    for name in ("rotate", "rotate_hoisted_group", "conjugate", "apply_bsgs", "real_part"):
        assert hasattr(ctx, name)


def test_hook_observes_every_dispatch(pair):
    _, _, _, _, tp, tks, z = pair
    seen = []
    ctx = T_Ctx(params=tp, keys=tks, policy=T_Policy(backend="fused", dispatch_hook=seen.append), device=CPU)
    ct = ctx.encrypt(ctx.encode(z))
    seen.clear()
    with T_dispatch.count_dispatches() as c:
        ctx.mul(ct, ct)
    assert len(seen) == T_dispatch.total(c) and set(seen) == set(c)


def test_bgv_params_build_a_bgv_context_with_its_scheme_guards():
    assert T_ops.Ciphertext.__dataclass_fields__.keys() == {"c0", "c1", "level", "scale"}
    p = T_P.make_params(1 << 9, 2, 1, check_security=False, plain_modulus=2)
    ctx = T_Ctx(params=p, keys=T_K.full_keyset(p, seed=0, device=CPU), device=CPU)
    assert ctx.scheme == "bgv" and ctx.policy_key() == ("bgv", "auto", "auto", "standard")
    ct = ctx.encrypt(ctx.encode(np.arange(5) % 2))
    assert ct.__dataclass_fields__.keys() == {"c0", "c1", "level"}
    with pytest.raises(ValueError, match="no rescale"):
        ctx.rescale(ct)
    assert ctx.mod_switch(ct).level == ct.level - 1


# ---------------------------------------------------------------------------
# the matmul preset at full width (N = 2^13): the digest chip_smoke.py checks
# ---------------------------------------------------------------------------


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_matmul_preset_full_width_matches_reference_digest():
    chip_smoke = _chip_smoke()
    name = "matmul"
    rp, tp = R_P.workload_params(name), T_P.workload_params(name)
    z = np.random.default_rng(0).normal(size=rp.slots) * 0.4
    rctx = R_Ctx(params=rp, keys=R_K.full_keyset(rp, seed=0), policy=R_Policy(backend="ref"))
    ra = rctx.encrypt(rctx.encode(z))
    rout = rctx.mul(ra, ra)
    rdigest = hashlib.sha256(np.asarray(rout.c0).astype("<u4").tobytes()
                             + np.asarray(rout.c1).astype("<u4").tobytes()).hexdigest()
    assert rdigest == chip_smoke.REFERENCE[name]["digest"]

    tctx = T_Ctx(params=tp, keys=T_K.full_keyset(tp, seed=0, device=CPU), policy=T_Policy(backend="fused"),
                 device=CPU)
    ta = tctx.encrypt(tctx.encode(z))
    with T_dispatch.count_dispatches() as c:
        tout = tctx.mul(ta, ta)
    assert dict(c) == reference_rescale.port_counts(chip_smoke.FUSED_MUL_DISPATCHES, 1)
    tdigest = hashlib.sha256(tout.c0.numpy().astype("<u4").tobytes() + tout.c1.numpy().astype("<u4").tobytes())
    assert tdigest.hexdigest() == rdigest
    assert np.max(np.abs(tctx.decrypt_decode(tout) - z * z)) < chip_smoke.REFERENCE[name]["max_err"]
