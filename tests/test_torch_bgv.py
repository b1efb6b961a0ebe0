"""The port's BGV scheme against the reference package and the u64 oracle, on the CPU.

The contracts of ``tests/test_bgv.py``, with fixed seeds: every op is exact
mod t against a negacyclic-convolution oracle, the fused and staged pipelines
give the same limbs, and, beyond that file, every ciphertext, trace and
dispatch count equals the reference package's for the same params and seeds
(the reference under ``backend="ref"``, which ``tests/test_bgv.py`` pins its
fused pipeline to).  The last test runs the ``psi`` preset at full width and
checks the digests that ``chip_smoke.py`` checks on the card."""

import importlib.util
import itertools
import pathlib

import numpy as np
import pytest
import torch

from repro.fhe import keys as R_K
from repro.fhe import params as R_P
from repro.fhe import trace as R_trace
from repro.fhe.context import ExecPolicy as R_Policy
from repro.fhe.context import FheContext as R_Ctx
from repro.kernels import dispatch as R_dispatch
from repro_torch.fhe import bgv as T_bgv
from repro_torch.fhe import context as T_context
from repro_torch.fhe import convert
from repro_torch.fhe import keys as T_K
from repro_torch.fhe import params as T_P
from repro_torch.fhe import trace as T_trace
from repro_torch.fhe.context import ExecPolicy as T_Policy
from repro_torch.fhe.context import FheContext as T_Ctx
from repro_torch.kernels import dispatch as T_dispatch

torch.set_num_threads(1)

CPU = "cpu"
PIPELINES = ("ref", "fused")  # the staged plain pipeline and the fused one
SEEDS = (0, 1, 2)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _chip_smoke()


def _ct_eq(port, ref):
    assert isinstance(port, T_bgv.BgvCiphertext) and port.level == ref.level
    np.testing.assert_array_equal(port.c0.numpy().astype(np.int64), np.asarray(ref.c0).astype(np.int64))
    np.testing.assert_array_equal(port.c1.numpy().astype(np.int64), np.asarray(ref.c1).astype(np.int64))
    assert port.nbytes == ref.nbytes


def _stream(instrs):
    return [(i.op, i.n, i.limbs, i.meta) for i in instrs]


def _msgs(seed: int, n: int, t: int, k: int = 2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, t, size=n).astype(np.int64) for _ in range(k)]


@pytest.fixture(scope="module", params=(2, 1 << 16), ids=("t=2", "t=2^16"))
def bgv(request):
    """(t, reference params/keys/context, port params/keys)."""
    t = request.param
    rp = R_P.make_params(1 << 9, 5, 2, check_security=False, plain_modulus=t)
    tp = T_P.make_params(1 << 9, 5, 2, check_security=False, plain_modulus=t)
    rks = R_K.full_keyset(rp, seed=0)
    tks = T_K.full_keyset(tp, seed=0, device=CPU)
    rctx = R_Ctx(params=rp, keys=rks, policy=R_Policy(backend="ref"))
    return t, rp, rks, rctx, tp, tks


def _port(bgv, backend="ref"):
    _, _, _, _, tp, tks = bgv
    return T_Ctx(params=tp, keys=tks, policy=T_Policy(backend=backend), device=CPU)


def _encrypt_both(bgv, backend, msgs, level=None, seed=0):
    """The same messages encrypted with the same seeds by both packages."""
    rctx, tctx = bgv[3], _port(bgv, backend)
    rcts = [rctx.encrypt(rctx.encode(z, level=level), seed=seed + i) for i, z in enumerate(msgs)]
    tcts = [tctx.encrypt(tctx.encode(z, level=level), seed=seed + i) for i, z in enumerate(msgs)]
    return rctx, tctx, rcts, tcts


def test_bgv_keys_are_t_scaled_and_bit_identical(bgv):
    t, rp, rks, _, tp, tks = bgv
    assert T_K._err_scale(tp) == t
    for port, ref in ((tks.sk.s_eval, rks.sk.s_eval), (tks.pk.b, rks.pk.b), (tks.rlk.k, rks.rlk.k)):
        np.testing.assert_array_equal(port.numpy().astype(np.int64), np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_encode_decode_roundtrip(bgv, seed):
    t, _, _, rctx, tp, _ = bgv
    (z,) = _msgs(seed, tp.n, t, k=1)
    tctx = _port(bgv)
    pt = tctx.encode(z)
    np.testing.assert_array_equal(pt.data.numpy().astype(np.int64), np.asarray(rctx.encode(z).data).astype(np.int64))
    assert np.array_equal(tctx.decode(pt), z % t)
    short = np.arange(7) - 3  # fewer than N integers, negative ones reduced mod t
    assert np.array_equal(tctx.decode(tctx.encode(short))[:7], short % t)
    with pytest.raises(ValueError, match="BGV encode"):
        tctx.encode(np.zeros(tp.n + 1, np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("backend", PIPELINES)
def test_additive_ops_vs_oracle_and_reference(bgv, backend, seed):
    t, _, _, _, tp, _ = bgv
    za, zb = _msgs(seed, tp.n, t)
    rctx, tctx, (ra, rb), (ta, tb) = _encrypt_both(bgv, backend, (za, zb), seed=seed)
    _ct_eq(ta, ra)
    for op, want in (("add", (za + zb) % t), ("sub", (za - zb) % t)):
        got = getattr(tctx, op)(ta, tb)
        _ct_eq(got, getattr(rctx, op)(ra, rb))
        assert np.array_equal(tctx.decrypt_decode(got), want)
    neg = tctx.negate(ta)
    _ct_eq(neg, rctx.negate(ra))
    assert np.array_equal(tctx.decrypt_decode(neg), (-za) % t)
    assert np.array_equal(tctx.decrypt_decode(ta), za % t)
    np.testing.assert_array_equal(tctx.decrypt(ta).data.numpy().astype(np.int64),
                                  np.asarray(rctx.decrypt(ra).data).astype(np.int64))


def test_additive_ops_align_levels(bgv):
    t, _, _, _, tp, _ = bgv
    za, zb = _msgs(5, tp.n, t)
    rctx, tctx = bgv[3], _port(bgv)
    ra, rb = rctx.encrypt(rctx.encode(za), seed=1), rctx.encrypt(rctx.encode(zb, level=3), seed=2)
    ta, tb = tctx.encrypt(tctx.encode(za), seed=1), tctx.encrypt(tctx.encode(zb, level=3), seed=2)
    got = tctx.add(ta, tb)
    assert got.level == 3
    _ct_eq(got, rctx.add(ra, rb))
    assert np.array_equal(tctx.decrypt_decode(got), (za + zb) % t)
    assert T_bgv.level_drop(ta, ta.level) is ta


@pytest.mark.parametrize("level", (5, 4, 3, 2, 1))
@pytest.mark.parametrize("backend", PIPELINES)
def test_mul_vs_oracle_and_reference_across_levels(bgv, backend, level):
    """One mul (relinearisation + mod switch) from every level of the chain."""
    t, _, _, _, tp, _ = bgv
    za, zb = _msgs(10 + level, tp.n, t)
    rctx, tctx, (ra, rb), (ta, tb) = _encrypt_both(bgv, backend, (za, zb), level=level, seed=level)
    got = tctx.mul(ta, tb)
    assert got.level == level - 1
    _ct_eq(got, rctx.mul(ra, rb))
    assert np.array_equal(tctx.decrypt_decode(got), SMOKE.oracle_mul(za, zb, tp.n, t))


@pytest.mark.parametrize("seed", SEEDS[:2])
@pytest.mark.parametrize("backend", PIPELINES)
def test_mul_depth2_and_square_vs_oracle_and_reference(bgv, backend, seed):
    """(a·b)·c and a² stay exact through the level drops."""
    t, _, _, _, tp, _ = bgv
    za, zb, zc = _msgs(seed, tp.n, t, k=3)
    rctx, tctx, (ra, rb, rc), (ta, tb, tc) = _encrypt_both(bgv, backend, (za, zb, zc), seed=seed)
    got = tctx.mul(tctx.mul(ta, tb), tc)
    _ct_eq(got, rctx.mul(rctx.mul(ra, rb), rc))
    ab = SMOKE.oracle_mul(za, zb, tp.n, t)
    assert np.array_equal(tctx.decrypt_decode(got), SMOKE.oracle_mul(ab, zc, tp.n, t))
    sq = tctx.square(ta)
    _ct_eq(sq, rctx.square(ra))
    assert np.array_equal(tctx.decrypt_decode(sq), SMOKE.oracle_mul(za, za, tp.n, t))


@pytest.mark.parametrize("dnum", (1, 2, 3))
def test_mul_vs_oracle_and_reference_across_dnum(dnum):
    """The digit count only reshapes the hybrid key switch — never the result."""
    t = 1 << 8
    rp = R_P.make_params(1 << 9, 5, dnum, check_security=False, plain_modulus=t)
    tp = T_P.make_params(1 << 9, 5, dnum, check_security=False, plain_modulus=t)
    rctx = R_Ctx(params=rp, keys=R_K.full_keyset(rp, seed=0), policy=R_Policy(backend="ref"))
    za, zb = _msgs(dnum, tp.n, t)
    ra, rb = (rctx.encrypt(rctx.encode(z), seed=i) for i, z in enumerate((za, zb)))
    tks = T_K.full_keyset(tp, seed=0, device=CPU)
    for backend in PIPELINES:
        tctx = T_Ctx(params=tp, keys=tks, policy=T_Policy(backend=backend), device=CPU)
        ta, tb = (tctx.encrypt(tctx.encode(z), seed=i) for i, z in enumerate((za, zb)))
        got = tctx.mul(ta, tb)
        _ct_eq(got, rctx.mul(ra, rb))
        assert np.array_equal(tctx.decrypt_decode(got), SMOKE.oracle_mul(za, zb, tp.n, t))


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_and_staged_pipelines_bit_identical(bgv, seed):
    t, _, _, _, tp, _ = bgv
    za, zb = _msgs(seed, tp.n, t)
    outs = {}
    for backend in ("ref", "staged", "fused", "kernel"):
        c = _port(bgv, backend)
        outs[backend] = c.mul(c.encrypt(c.encode(za), seed=seed), c.encrypt(c.encode(zb), seed=seed + 1))
    for backend in ("staged", "fused", "kernel"):
        assert torch.equal(outs[backend].c0, outs["ref"].c0) and torch.equal(outs[backend].c1, outs["ref"].c1)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("backend", PIPELINES)
def test_mod_switch_preserves_message_and_matches_reference(bgv, backend, seed):
    t, _, _, _, tp, _ = bgv
    (z,) = _msgs(seed, tp.n, t, k=1)
    rctx, tctx, (rct,), (tct,) = _encrypt_both(bgv, backend, (z,), seed=seed)
    down = tctx.mod_switch(tct)
    assert down.level == tct.level - 1
    _ct_eq(down, rctx.mod_switch(rct))
    assert np.array_equal(tctx.decrypt_decode(down), z % t)
    # mul without the switch, then an explicit one, is the default mul
    za, zb = _msgs(seed + 7, tp.n, t)
    a, b = tctx.encrypt(tctx.encode(za), seed=1), tctx.encrypt(tctx.encode(zb), seed=2)
    raw = tctx.mul(a, b, rescale_after=False)
    assert raw.level == a.level
    switched, fused = tctx.mod_switch(raw), tctx.mul(a, b)
    assert torch.equal(switched.c0, fused.c0) and torch.equal(switched.c1, fused.c1)
    with pytest.raises(AssertionError, match="level 0"):
        tctx.mod_switch(T_bgv.level_drop(tct, 0))


@pytest.mark.parametrize("backend", PIPELINES)
def test_trace_and_dispatches_match_reference(bgv, backend):
    """Every op's instruction stream and kernel-dispatch counts equal the
    reference's under the same pipeline."""
    t, _, _, _, tp, _ = bgv
    za, zb = _msgs(3, tp.n, t)
    rctx = bgv[3].with_policy(backend=backend)
    tctx = _port(bgv, backend)
    got = {}
    for name, ctx, tr, dp in (("ref", rctx, R_trace, R_dispatch), ("port", tctx, T_trace, T_dispatch)):
        rec = []
        for op in ("encode", "encrypt", "add", "sub", "negate", "mul", "mod_switch", "decrypt_decode"):
            with tr.capture_trace() as instrs, dp.count_dispatches() as counts:
                if op == "encode":
                    pa, pb = ctx.encode(za), ctx.encode(zb)
                elif op == "encrypt":
                    a, b = ctx.encrypt(pa, seed=1), ctx.encrypt(pb, seed=2)
                elif op in ("add", "sub", "mul"):
                    out = getattr(ctx, op)(a, b)
                elif op in ("negate", "mod_switch"):
                    out = getattr(ctx, op)(a)
                else:
                    ctx.decrypt_decode(out)
            rec.append((op, _stream(instrs), dict(counts)))
        got[name] = rec
    assert got["port"] == got["ref"]


def test_policy_for_scheme_and_keys_never_alias():
    combos = list(itertools.product(T_context.SCHEMES, T_context.BACKENDS, T_context.HOISTING_MODES,
                                    T_context.NUMERICS_MODES))
    keys = {T_Policy(backend=b, hoisting=h, numerics=m, scheme=s).policy_key() for s, b, h, m in combos}
    assert len(keys) == len(combos) and all(k[0] in T_context.SCHEMES for k in keys)
    pol = T_Policy(backend="fused")
    assert pol.for_scheme("ckks") is pol
    assert pol.for_scheme("bgv").policy_key() == R_Policy(backend="fused").for_scheme("bgv").policy_key()
    with pytest.raises(ValueError, match="scheme"):
        pol.for_scheme("bfv")


def test_context_coerces_policy_scheme(bgv):
    _, _, _, _, tp, tks = bgv
    mis = T_Ctx(params=tp, keys=tks, policy=T_Policy(scheme="ckks"), device=CPU)
    assert mis.scheme == "bgv" and mis.policy_key()[0] == "bgv"
    ckks_p = T_P.make_params(1 << 9, 5, 2, check_security=False)
    assert T_Ctx(params=ckks_p, policy=T_Policy(scheme="bgv"), device=CPU).scheme == "ckks"


def test_scheme_op_guards(bgv):
    t, _, _, _, _, _ = bgv
    tctx = _port(bgv)
    ct = tctx.encrypt(tctx.encode(np.arange(8) % t))
    with pytest.raises(ValueError, match="mod_switch"):
        tctx.rescale(ct)
    ckks_p = T_P.make_params(1 << 9, 5, 2, check_security=False)
    ckks_ctx = T_Ctx(params=ckks_p, keys=T_K.full_keyset(ckks_p, seed=0, device=CPU), device=CPU)
    ckks_ct = ckks_ctx.encrypt(ckks_ctx.encode(np.zeros(ckks_p.slots)))
    with pytest.raises(ValueError, match="BGV op"):
        ckks_ctx.mod_switch(ckks_ct)
    with pytest.raises(ValueError, match="plain_modulus"):
        T_bgv._t(ckks_p)


def test_bgv_ciphertext_from_arrays(bgv):
    t, _, _, rctx, tp, _ = bgv
    (z,) = _msgs(4, tp.n, t, k=1)
    rct = rctx.encrypt(rctx.encode(z), seed=9)
    ct = convert.bgv_ciphertext_from_arrays(np.asarray(rct.c0), np.asarray(rct.c1), rct.level, device=CPU)
    _ct_eq(ct, rct)
    tctx = _port(bgv, "fused")
    _ct_eq(tctx.mul(ct, ct), rctx.mul(rct, rct))
    with pytest.raises(ValueError, match="limbs"):
        convert.bgv_ciphertext_from_arrays(np.asarray(rct.c0), np.asarray(rct.c1), rct.level - 1, device=CPU)


def test_bgv_context_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = T_P.workload_params("psi")
    with pytest.raises(RuntimeError, match="CUDA"):
        T_Ctx(params=p)
    assert T_Ctx(params=p, device=CPU).scheme == "bgv"


# ---------------------------------------------------------------------------
# the psi preset at full width (N = 2^13): the digests chip_smoke.py checks
# ---------------------------------------------------------------------------


def test_psi_preset_full_width_matches_reference_digests():
    name = "psi"
    p = T_P.workload_params(name)
    want = SMOKE.BGV[name]
    msgs = SMOKE.bgv_messages(p)
    ctx = T_Ctx(params=p, keys=T_K.full_keyset(p, seed=0, device=CPU), device=CPU)
    with T_dispatch.count_dispatches() as counts:
        outs, decoded = SMOKE.bgv_path(ctx, msgs)
    assert {k: SMOKE.digest(v) for k, v in outs.items()} == want["digests"]
    assert {k: v.level for k, v in outs.items()} == want["levels"]
    assert dict(counts) == SMOKE.BGV_STAGED_DISPATCHES
    oracle = SMOKE.bgv_oracle(msgs, p.n, p.plain_modulus)
    assert all(np.array_equal(decoded[k], oracle[k]) for k in outs)
