"""Real constants encoded as per-limb residue columns, on the CPU.

A real constant c encodes to the polynomial round(c·scale), whose NTT holds
that integer's residue in every slot of a limb, so ``ops._encode_const``
builds the eval-domain plaintext as the column round(c·scale) mod q_i
broadcast over N, with no host array, no upload and no NTT.  It must equal
the host path (``encoder.encode_const``, the residues, the NTT) bit for bit at
every level, for small and large constants and for encoding scales that are
no power of two, at n = 2^9 and 2^10 and on a 58-prime chain.  A complex
constant, or a real one whose integer reaches 2^62, still takes the host path.
The plaintext's consumers (multiply, add, encrypt, decode) give what the
host path's plaintext gives.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.fhe import encoder, ops, poly
from repro_torch.fhe import keys as K
from repro_torch.fhe import params as P
from repro_torch.fhe import trace as fhe_trace
from repro_torch.fhe.context import FheContext
from repro_torch.kernels import dispatch
from repro_torch.kernels.ntt import ops as ntt_ops

torch.set_num_threads(1)

CPU = "cpu"
CONSTANTS = [0.0, 0.7, -1.0, 123.456, 2.0e4, -3.3e4]  # 2e4·2^30 > 2^44
CHAINS = {
    "n=2^9": (1 << 9, 6, 2),
    "n=2^10": (1 << 10, 6, 1),
    "58 primes": (1 << 10, 57, 1),
}


@pytest.fixture(scope="module", params=list(CHAINS), ids=list(CHAINS))
def ctx(request):
    n, L, dnum = CHAINS[request.param]
    return FheContext(params=P.make_params(n, L, dnum, check_security=False), device=CPU)


def _host(ctx, c, level, scale):
    """The host path: coefficient residues, to the device, the NTT."""
    p = ctx.params
    coeffs = encoder.encode_const(c, p.n, scale, p.q_primes[: level + 1])
    return poly.to_eval(poly.residues(coeffs, ctx.device), p, poly.q_idx(p, level))


def _levels(ctx):
    L = ctx.params.L
    return sorted({L, L // 2 + 1, 3, 0})


def _no_host_path(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a real constant took the host path")

    monkeypatch.setattr(poly, "residues", refuse)
    monkeypatch.setattr(ntt_ops, "ntt_fwd", refuse)


@pytest.mark.parametrize("c", CONSTANTS)
def test_real_constant_equals_the_host_path_bit_for_bit(ctx, c, monkeypatch):
    p = ctx.params
    for scale in (p.scale, p.scale * 1.3717, float(p.q_primes[1]) * 0.61):
        want = {lv: _host(ctx, c, lv, scale) for lv in _levels(ctx)}
        with monkeypatch.context() as m:
            _no_host_path(m)
            got = {lv: ops._encode_const(ctx, c, lv, scale) for lv in _levels(ctx)}
        for lv, pt in got.items():
            assert (pt.level, pt.scale) == (lv, scale)
            assert pt.data.shape == (lv + 1, p.n) and pt.data.dtype == torch.int32
            assert torch.equal(pt.data, want[lv]), (c, lv, scale)


def test_real_constant_records_no_instruction_and_no_dispatch(ctx, monkeypatch):
    _no_host_path(monkeypatch)
    with fhe_trace.capture_trace() as instrs, dispatch.count_dispatches() as counts:
        pt = ops._encode_const(ctx, 0.7, ctx.params.L, ctx.params.scale)
    assert instrs == [] and counts == {}
    # one column a limb, broadcast over N: no (limbs, N) array behind it
    assert pt.data.stride() == (1, 0)


@pytest.mark.parametrize("c", [0.3 + 0.2j, -0.5j])
def test_complex_constant_takes_the_host_path_unchanged(ctx, c, monkeypatch):
    p = ctx.params
    calls = []
    ntt_fwd = ntt_ops.ntt_fwd
    monkeypatch.setattr(ntt_ops, "ntt_fwd", lambda *a: calls.append(1) or ntt_fwd(*a))
    with fhe_trace.capture_trace() as instrs:
        pt = ops._encode_const(ctx, c, 3, p.scale)
    assert calls == [1] and [(i.op, i.n, i.limbs) for i in instrs] == [("NTT", p.n, 4)]
    assert torch.equal(pt.data, _host(ctx, c, 3, p.scale))
    assert pt.data.is_contiguous()


def test_real_constant_of_2_62_or_more_takes_the_host_path(ctx):
    p = ctx.params
    for c in (2.0 ** 62 / p.scale, -(2.0 ** 63) / p.scale):
        assert abs(encoder.const_integer(c, p.scale)) >= 1 << 62
        with fhe_trace.capture_trace() as instrs:
            pt = ops._encode_const(ctx, c, 2, p.scale)
        assert [i.op for i in instrs] == ["NTT"]
        assert torch.equal(pt.data, _host(ctx, c, 2, p.scale))
    just_below = ops._encode_const(ctx, (2.0 ** 62 - 2.0 ** 12) / p.scale, 2, p.scale)
    assert just_below.data.stride() == (1, 0)


def test_the_moduli_column_is_a_table_built_once():
    params = P.make_params(1 << 9, 6, 2, check_security=False)
    c = FheContext(params=params, device=CPU)
    poly.limb_column.cache_clear()
    for _ in range(3):
        for lv in (6, 2):
            ops._encode_const(c, -1.25, lv, params.scale)
    info = poly.limb_column.cache_info()
    assert (info.misses, info.hits) == (2, 4)
    col = poly.limb_column(tuple(params.q_primes[:3]), torch.int64, torch.device(CPU))
    assert col.shape == (3, 1) and col.dtype == torch.int64 and col[:, 0].tolist() == list(params.q_primes[:3])


@pytest.fixture(scope="module")
def keyed():
    p = P.make_params(1 << 9, 6, 2, check_security=False)
    ctx = FheContext(params=p, keys=K.full_keyset(p, seed=3, device=CPU), device=CPU)
    z = np.random.default_rng(9).uniform(-0.9, 0.9, size=p.slots)
    return ctx, ctx.encrypt(ctx.encode(z)), z


def _ct_eq(a, b):
    assert torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1) and (a.level, a.scale) == (b.level, b.scale)


@pytest.mark.parametrize("c", [0.7, -1.0, 123.456])
def test_consumers_take_the_column_as_they_took_the_host_plaintext(keyed, c):
    ctx, ct, z = keyed
    p = ctx.params
    col = ops._encode_const(ctx, c, ct.level, p.scale)
    host = ops.Plaintext(data=_host(ctx, c, ct.level, p.scale), level=ct.level, scale=p.scale)
    _ct_eq(ops._mul_plain(ctx, ct, col), ops._mul_plain(ctx, ct, host))
    _ct_eq(ops._add_plain(ctx, ct, ops._encode_const(ctx, c, ct.level, ct.scale)),
           ops._add_plain(ctx, ct, ops.Plaintext(_host(ctx, c, ct.level, ct.scale), ct.level, ct.scale)))
    low = ctx.level_drop(ct, 2)
    _ct_eq(ops._mul_plain(ctx, low, col, rescale_after=False), ops._mul_plain(ctx, low, host, rescale_after=False))
    _ct_eq(ctx.encrypt(col), ctx.encrypt(host))
    np.testing.assert_array_equal(ctx.decode(col), ctx.decode(host))
    np.testing.assert_allclose(ctx.decode(col).real, c, atol=1e-6 * max(1.0, abs(c)))
    np.testing.assert_allclose(ctx.decrypt_decode(ctx.mul_const(ct, c)).real, c * z, atol=2e-3 * max(1.0, abs(c)))
    np.testing.assert_allclose(ctx.decrypt_decode(ctx.add_const(ct, c)).real, c + z, atol=2e-3)


def test_the_column_is_built_inside_its_own_span(tmp_path):
    p = P.make_params(1 << 9, 6, 2, check_security=False)
    ctx = FheContext(params=p, device=CPU)
    ops._encode_const(ctx, 0.5, 4, p.scale)  # the moduli column's table, outside the profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ops._encode_const(ctx, 0.5, 4, p.scale)
        ops._encode_const(ctx, 0.5 + 0.5j, 4, p.scale)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    named = {name: [s for s in spans if s[2] == name] for name in {s[2] for s in spans}}
    real, cplx = sorted(named["fhe.encode_const"])
    column, = named["fhe.encode.const_column"]
    assert real[0] <= column[0] and column[1] <= real[1]
    for part in ("fhe.encode.coeffs", "fhe.encode.upload"):
        inner, = named[part]
        assert cplx[0] <= inner[0] and inner[1] <= cplx[1]
    assert not [s for s in spans if s[2].startswith("fhe.table.")]
