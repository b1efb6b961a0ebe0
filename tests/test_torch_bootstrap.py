"""The port's CKKS bootstrap against the reference package on the CPU.

The seven tests of ``tests/test_bootstrap.py`` at its ring (n = 2^8, L = 18,
dnum = 1, h = 32), each also holding the port's result to the reference's:
ModRaise, CoeffToSlot, EvalMod, SlotToCoeff and the whole bootstrap give its
ciphertexts bit for bit.  The port runs its default policy's fused pipeline
with hoisted baby-step groups; the reference runs its ``ref`` backend (its
fused one would run in Pallas interpret mode), and the trace streams and
dispatch counts are compared with the port under ``ref`` too, through plans
that hold no encoded diagonal yet: the reference's less the NTT of each real
constant, which the port builds with none, and with each BSGS matvec's
products and sums as one ``bsgsmac`` dispatch (``reference_bsgs``).  The last
tests check the reference's keys carried in through ``convert``, the digest
``chip_smoke.py`` checks on the card, and ModRaise at the
``packed_bootstrap`` preset's full width (N = 2^16, 58 limbs).
"""

import dataclasses
import importlib.util
import pathlib
import types

import numpy as np
import pytest
import reference_bsgs
import reference_constants
import torch

from repro.fhe import bootstrap as R_B
from repro.fhe import ops as R_ops
from repro.fhe import params as R_P
from repro.fhe import polyeval as R_pe
from repro.fhe import trace as R_trace
from repro.fhe.context import ExecPolicy as R_Policy
from repro.fhe.context import FheContext as R_Ctx
from repro.kernels import dispatch as R_dispatch
from repro_torch import fhe as T_fhe
from repro_torch.fhe import bootstrap as T_B
from repro_torch.fhe import convert
from repro_torch.fhe import keys as T_K
from repro_torch.fhe import params as T_P
from repro_torch.fhe import trace as T_trace
from repro_torch.fhe.context import ExecPolicy as T_Policy
from repro_torch.fhe.context import FheContext as T_Ctx
from repro_torch.kernels import dispatch as T_dispatch

torch.set_num_threads(1)

CPU = "cpu"
ATT = 1 / 64.0


def _ct_eq(port, ref):
    np.testing.assert_array_equal(port.c0.numpy().astype(np.int64), np.asarray(ref.c0).astype(np.int64))
    np.testing.assert_array_equal(port.c1.numpy().astype(np.int64), np.asarray(ref.c1).astype(np.int64))
    assert (port.level, port.scale) == (ref.level, ref.scale)


def _stream(instrs):
    return [(i.op, i.n, i.limbs, i.meta) for i in instrs]


def _fresh_plans(bctx):
    """``bctx`` with copies of its CtS and StC plans that hold no encoded
    diagonal yet: a bootstrap through it encodes every diagonal, as the
    reference's does, so the streams compare whole."""
    return dataclasses.replace(bctx, cts_plans=tuple(map(dataclasses.replace, bctx.cts_plans)),
                               stc_plans=tuple(map(dataclasses.replace, bctx.stc_plans)))


def _message(slots):
    rng = np.random.default_rng(7)
    return rng.normal(size=slots) * 0.4 + 1j * rng.normal(size=slots) * 0.4


def _stages(fc, bctx, ct):
    """Each stage of the bootstrap through its context method."""
    s = types.SimpleNamespace(raised=fc.mod_raise(bctx, ct))
    s.a = fc.coeff_to_slot(bctx, s.raised)
    s.m = tuple(fc.eval_mod(bctx, a, s.raised.scale) for a in s.a)
    s.stc = fc.slot_to_coeff(bctx, *s.m)
    return s


@pytest.fixture(scope="module")
def ref():
    p = R_P.make_params(1 << 8, 18, 1, check_security=False)
    bctx = R_B.build_context(p, seed=0, h=32)
    fc = R_Ctx(params=p, keys=bctx.keys, policy=R_Policy(backend="ref"))
    z = _message(p.slots)
    ct = R_ops.level_drop(fc.mul_const(fc.encrypt(fc.encode(z)), ATT), 0)
    s = _stages(fc, bctx, ct)
    with reference_constants.track() as marks:
        with R_trace.capture_trace() as t, R_dispatch.count_dispatches() as c:
            s.out = fc.bootstrap(bctx, ct, post_scale=1 / ATT)
    # the port's streams: these less the NTT and the ``ntt`` dispatch of each real
    # constant, and its counts with each of the four matvecs' products and sums in one launch
    port_counts = reference_bsgs.port_counts(marks.counts(c, t), (*bctx.cts_plans, *bctx.stc_plans))
    return types.SimpleNamespace(p=p, bctx=bctx, fc=fc, z=z, ct=ct, s=s, trace=list(t), counts=dict(c),
                                 port_trace=marks.stream(t), port_counts=port_counts,
                                 constants=len(marks.of(t)))


@pytest.fixture(scope="module")
def port():
    p = T_P.make_params(1 << 8, 18, 1, check_security=False)
    bctx = T_B.build_context(p, seed=0, h=32, device=CPU)
    fc = T_Ctx(params=p, keys=bctx.keys, policy=T_Policy(backend="fused"), device=CPU)
    z = _message(p.slots)
    ct = fc.level_drop(fc.mul_const(fc.encrypt(fc.encode(z)), ATT), 0)
    s = _stages(fc, bctx, ct)
    s.out = fc.bootstrap(bctx, ct, post_scale=1 / ATT)
    with reference_constants.track() as marks:
        with T_trace.capture_trace() as t, T_dispatch.count_dispatches() as c:
            ref_out = fc.with_policy(backend="ref").bootstrap(_fresh_plans(bctx), ct, post_scale=1 / ATT)
    return types.SimpleNamespace(p=p, bctx=bctx, fc=fc, z=z, ct=ct, s=s, trace=list(t), counts=dict(c),
                                 ref_out=ref_out, constants=marks.port_constants(t))


# ---------------------------------------------------------------------------
# the seven tests of tests/test_bootstrap.py, each against the reference
# ---------------------------------------------------------------------------


def test_bootstrap_refreshes_levels(ref, port):
    assert port.s.out.level >= 5, f"bootstrap must leave usable depth, got level {port.s.out.level}"
    assert port.s.out.level == ref.s.out.level == port.p.L - port.bctx.depth


def test_bootstrap_value_correct(ref, port):
    _ct_eq(port.s.out, ref.s.out)
    _ct_eq(port.ref_out, ref.s.out)
    got = port.fc.decrypt_decode(port.s.out)
    np.testing.assert_allclose(got, port.z, atol=5e-2)
    np.testing.assert_array_equal(got, np.asarray(ref.fc.decrypt_decode(ref.s.out)))


def test_post_bootstrap_multiplication(ref, port):
    sq = port.fc.square(port.s.out)
    _ct_eq(sq, ref.fc.square(ref.s.out))
    np.testing.assert_allclose(port.fc.decrypt_decode(sq), port.z * port.z, atol=1e-1)


def test_bootstrap_trace_structure(ref, port):
    names = [i.op for i in port.trace]
    assert names[0] == "BOOTSTRAP_BEGIN" and names[-1] == "BOOTSTRAP_END"
    assert "MODRAISE" in names
    assert names.count("BCONV") > 50
    assert names.count("AUTO") > 20
    assert _stream(port.trace) == _stream(ref.port_trace)
    assert port.counts == ref.port_counts
    assert port.constants == ref.constants == ref.counts["ntt"] - port.counts["ntt"] > 0


def test_eval_mod_precision(ref, port):
    """Homomorphic sine matches the numpy Chebyshev evaluation, and the reference's bytes."""
    x = np.random.default_rng(3).uniform(-0.95, 0.95, size=port.p.slots)
    tct, rct = port.fc.encrypt(port.fc.encode(x)), ref.fc.encrypt(ref.fc.encode(x))
    basis = port.fc.chebyshev_basis(tct, port.bctx.eval_mod_degree)
    out = port.fc.eval_chebyshev(basis, port.bctx.sine_coeffs)
    _ct_eq(out, ref.fc.eval_chebyshev(ref.fc.chebyshev_basis(rct, ref.bctx.eval_mod_degree), ref.bctx.sine_coeffs))
    want = np.polynomial.chebyshev.Chebyshev(port.bctx.sine_coeffs)(x)
    np.testing.assert_allclose(port.fc.decrypt_decode(out).real, want, atol=1e-3)


def test_force_to_exactness(ref, port):
    """force_to's mul-by-one fold is value-preserving across multi-level drops."""
    z = np.random.default_rng(11).normal(size=port.p.slots) * 0.3
    tct, rct = port.fc.encrypt(port.fc.encode(z)), ref.fc.encrypt(ref.fc.encode(z))
    dropped = T_Ctx(params=port.p, device=CPU).force_to(tct, tct.level - 5, port.p.scale * 1.01)
    _ct_eq(dropped, R_Ctx(params=ref.p).force_to(rct, rct.level - 5, ref.p.scale * 1.01))
    assert dropped.level == tct.level - 5
    assert dropped.scale == port.p.scale * 1.01
    np.testing.assert_allclose(port.fc.decrypt_decode(dropped), z, atol=2e-3)


def test_context_precomputes_galois_union_without_overgeneration(ref, port):
    """build_context stores the per-plan rotation union and keygen produced
    exactly one switching key per needed Galois element, as the reference's."""
    b, rb = port.bctx, ref.bctx
    want = set()
    for plan in (*b.cts_plans, *b.stc_plans):
        want |= plan.rotations()
    assert tuple(sorted(want)) == b.galois_rotations == rb.galois_rotations
    assert len(b.galois_rotations) == 22
    assert tuple(sorted(b.keys.gks)) == T_K.galois_elements(port.p, b.galois_rotations, conjugate=True)
    assert sorted(b.keys.gks) == sorted(rb.keys.gks) and len(b.keys.gks) == 23
    for t, k in rb.keys.gks.items():
        np.testing.assert_array_equal(b.keys.galois(t).k.numpy().astype(np.int64), np.asarray(k.k).astype(np.int64))
    np.testing.assert_array_equal(b.sine_coeffs, rb.sine_coeffs)
    assert (b.K, b.eval_mod_degree, b.depth) == (rb.K, rb.eval_mod_degree, rb.depth) == (8, 79, 12)
    for tp, rp in zip((*b.cts_plans, *b.stc_plans), (*rb.cts_plans, *rb.stc_plans)):
        assert (tp.n1, len(tp.diags)) == (rp.n1, len(rp.diags)) == (16, 128)
        assert sorted(tp.diags) == sorted(rp.diags)
        for d in rp.diags:
            np.testing.assert_array_equal(tp.diags[d], rp.diags[d])
        assert tp.rotations() == rp.rotations()


# ---------------------------------------------------------------------------
# each stage, bit for bit
# ---------------------------------------------------------------------------


def test_stages_match_reference(ref, port):
    _ct_eq(port.ct, ref.ct)
    _ct_eq(port.s.raised, ref.s.raised)
    assert port.s.raised.level == port.p.L
    for got, want in zip((*port.s.a, *port.s.m, port.s.stc), (*ref.s.a, *ref.s.m, ref.s.stc)):
        _ct_eq(got, want)


def test_stage_traces_and_dispatches_match_reference(ref, port):
    tfc, rfc = port.fc.with_policy(backend="ref"), ref.fc
    for stage in ("mod_raise", "coeff_to_slot"):
        with T_trace.capture_trace() as tt, T_dispatch.count_dispatches() as tc:
            getattr(tfc, stage)(_fresh_plans(port.bctx), port.ct if stage == "mod_raise" else port.s.raised)
        with R_trace.capture_trace() as rt, R_dispatch.count_dispatches() as rc:
            getattr(rfc, stage)(ref.bctx, ref.ct if stage == "mod_raise" else ref.s.raised)
        plans = ref.bctx.cts_plans if stage == "coeff_to_slot" else ()
        assert _stream(tt) == _stream(rt) and tc == reference_bsgs.port_counts(rc, plans), stage


def test_bootstrap_context_and_device_rules(port):
    b = port.bctx
    assert T_fhe.bootstrap is T_B and "bootstrap" in dir(T_fhe)
    assert b.keys.device.type == "cpu"
    other = T_P.make_params(1 << 8, 17, 1, check_security=False)
    with pytest.raises(AssertionError, match="params differ"):
        T_Ctx(params=other, device=CPU).bootstrap(b, port.ct)
    with pytest.raises(AssertionError, match="exhausted"):
        port.fc.mod_raise(b, port.s.raised)
    # a context without keys bootstraps with the BootstrapContext's
    _ct_eq(T_Ctx(params=port.p, device=CPU).mod_raise(b, port.ct), port.s.raised)


def test_keyset_from_arrays_carries_the_reference_bootstrap_keys(ref, port):
    """The reference's BootstrapContext keys (rlk and 23 Galois keys, the
    conjugation included), carried in, bootstrap the reference's ciphertext to
    its bytes."""
    rks = ref.bctx.keys
    arrays = dict(s_coeff=rks.sk.s_coeff, s_eval=np.asarray(rks.sk.s_eval), pk_b=np.asarray(rks.pk.b),
                  pk_a=np.asarray(rks.pk.a), rlk=np.asarray(rks.rlk.k),
                  gks={t: np.asarray(k.k) for t, k in rks.gks.items()})
    ks = convert.keyset_from_arrays(port.p, arrays, device=CPU)
    assert len(ks.gks) == 23 and 2 * port.p.n - 1 in ks.gks
    bctx = dataclasses.replace(port.bctx, keys=ks)
    ct = convert.ciphertext_from_arrays(np.asarray(ref.ct.c0), np.asarray(ref.ct.c1), 0, ref.ct.scale, device=CPU)
    out = T_Ctx(params=port.p, keys=ks, policy=T_Policy(backend="fused", hoisting="always"),
                device=CPU).bootstrap(bctx, ct, post_scale=1 / ATT)
    _ct_eq(out, ref.s.out)


# ---------------------------------------------------------------------------
# the digests chip_smoke.py checks on the card
# ---------------------------------------------------------------------------


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bootstrap_digest_matches_chip_smoke(port):
    cs = _chip_smoke()
    ref = cs.BOOTSTRAP
    assert (port.p.n, port.p.L, port.p.dnum) == (ref["n"], ref["L"], ref["dnum"])
    assert cs.digest(port.s.out) == ref["digest"]
    assert port.s.out.level == ref["level"]
    err = float(np.max(np.abs(port.fc.decrypt_decode(port.s.out) - port.z)))
    assert abs(err - ref["decode_error"]) <= 1e-9
    assert port.counts == ref["staged_dispatches"]


def test_packed_bootstrap_mod_raise_full_width_matches_chip_smoke():
    """ModRaise at N = 2^16, 1 → 58 limbs: the centred lift on the device
    against the digest of the reference's host-side lift."""
    cs = _chip_smoke()
    ref = cs.PACKED
    p = T_P.workload_params(ref["preset"])
    ks = T_K.full_keyset(p, seed=0, device=CPU)
    bctx = cs.packed_bootstrap_context(p, ks)
    assert (bctx.K, bctx.eval_mod_degree) == (2, T_B._default_degree(2)) == (2, 32)
    fc = T_Ctx(params=p, keys=ks, device=CPU)
    z = np.random.default_rng(0).normal(size=p.slots) * 0.4
    raised = fc.mod_raise(bctx, fc.level_drop(fc.mul_const(fc.encrypt(fc.encode(z)), ATT), 0))
    assert raised.level == p.L == 57
    assert cs.digest(raised) == ref["mod_raise"]
    assert not bctx.cts_plans and not bctx.stc_plans
    # build_context's EvalMod target at K = 2, in the reference's own expression
    rp = R_P.workload_params(ref["preset"])
    q0, c = float(rp.q_primes[0]), 2.0 * np.pi * 2.5
    want = R_pe.chebyshev_fit(lambda x: (q0 / rp.scale) * np.sin(c * x) / (2.0 * np.pi), R_B._default_degree(2))
    np.testing.assert_array_equal(bctx.sine_coeffs, want)
