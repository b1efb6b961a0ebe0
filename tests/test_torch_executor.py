"""The port's multi-job executor against the reference's, on the CPU.

Four jobs at n = 2^9 over 1, 2 and 4 affiliations: every output equals the
port's own ``ctx.mul`` and the reference's ``parallel_shallow_mul``, byte for
byte, with both packages fed the same ciphertext bytes.  On the CPU the
affiliations run one after another; the card's streams are checked in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from repro.core import executor as R_E
from repro.fhe import keys as R_K
from repro.fhe import params as R_P
from repro.fhe.context import ExecPolicy as R_Policy
from repro.fhe.context import FheContext as R_Ctx
from repro_torch.core import executor as T_E
from repro_torch.fhe import convert
from repro_torch.fhe import keys as T_K
from repro_torch.fhe import params as T_P
from repro_torch.fhe.context import ExecPolicy as T_Policy
from repro_torch.fhe.context import FheContext as T_Ctx
from repro_torch.kernels import dispatch as T_dispatch
from repro_torch.kernels import tables

torch.set_num_threads(1)

CPU = "cpu"
N_JOBS = 4


def _port_ct(ct):
    return convert.ciphertext_from_arrays(np.asarray(ct.c0), np.asarray(ct.c1), ct.level, ct.scale, device=CPU)


@pytest.fixture(scope="module")
def jobs():
    """Four jobs of distinct pairs, encrypted by the reference and carried into
    the port; the reference's ``parallel_shallow_mul`` over one device group."""
    rp = R_P.make_params(1 << 9, 4, 2, check_security=False)
    tp = T_P.make_params(1 << 9, 4, 2, check_security=False)
    rks = R_K.full_keyset(rp, seed=0)
    tks = T_K.full_keyset(tp, seed=0, device=CPU)
    rctx = R_Ctx(params=rp, keys=rks, policy=R_Policy(backend="ref"))
    rpairs = []
    for j in range(N_JOBS):
        rng = np.random.default_rng(j)
        x, y = rng.normal(size=rp.slots) * 0.4, rng.normal(size=rp.slots) * 0.4
        rpairs.append((rctx.encrypt(rctx.encode(x), seed=j), rctx.encrypt(rctx.encode(y), seed=50 + j)))
    # the reference's table caches must hold concrete values before its jit
    # trace reads them: a first call inside the trace would cache tracers
    rctx.mul(*rpairs[0])
    routs = R_E.parallel_shallow_mul(rp, rks, rpairs, R_E.affiliation_mesh(1))
    tpairs = [(_port_ct(a), _port_ct(b)) for a, b in rpairs]
    return tp, tks, tpairs, routs


def _rescaled(ct):
    return type(ct)(ct.c0, ct.c1, ct.level, ct.scale * 2)


def _eq(port, ref):
    np.testing.assert_array_equal(port.c0.numpy().astype(np.int64), np.asarray(ref.c0).astype(np.int64))
    np.testing.assert_array_equal(port.c1.numpy().astype(np.int64), np.asarray(ref.c1).astype(np.int64))
    assert (port.level, port.scale) == (ref.level, ref.scale)


@pytest.mark.parametrize("n_aff", (1, 2, 4))
def test_outputs_equal_ctx_mul_and_the_reference(jobs, n_aff):
    tp, tks, tpairs, routs = jobs
    affs = T_E.affiliation_streams(n_aff, CPU)
    assert affs == [None] * n_aff
    outs = T_E.parallel_shallow_mul(tp, tks, tpairs, affs, device=CPU)
    ctx = T_Ctx(params=tp, keys=tks, policy=T_Policy(backend="ref"), device=CPU)
    assert len(outs) == N_JOBS
    for out, (a, b), ref in zip(outs, tpairs, routs):
        _eq(out, ref)
        alone = ctx.mul(a, b)
        assert torch.equal(out.c0, alone.c0) and torch.equal(out.c1, alone.c1)
        assert (out.level, out.scale) == (alone.level, alone.scale)


def test_dispatches_are_one_staged_mul_per_job(jobs):
    tp, tks, tpairs, _ = jobs
    ctx = T_Ctx(params=tp, keys=tks, policy=T_Policy(backend="ref"), device=CPU)
    with T_dispatch.count_dispatches() as one:
        ctx.mul(*tpairs[0])
    with T_dispatch.count_dispatches() as all_jobs:
        T_E.parallel_shallow_mul(tp, tks, tpairs, T_E.affiliation_streams(2, CPU), device=CPU)
    assert "bconv" in one and dict(all_jobs) == {k: N_JOBS * v for k, v in one.items()}


def test_jobs_must_tile_the_affiliations_and_share_level_and_scale(jobs):
    tp, tks, tpairs, _ = jobs
    with pytest.raises(ValueError, match="tile"):
        T_E.parallel_shallow_mul(tp, tks, tpairs, T_E.affiliation_streams(3, CPU), device=CPU)
    with pytest.raises(ValueError, match="tile"):
        T_E.parallel_shallow_mul(tp, tks, [], T_E.affiliation_streams(1, CPU), device=CPU)
    (a, b), rest = tpairs[0], tpairs[1:]
    ctx = T_Ctx(params=tp, keys=tks, device=CPU)
    for bad in ((ctx.level_drop(a, a.level - 1), ctx.level_drop(b, b.level - 1)), (a, _rescaled(b))):
        with pytest.raises(ValueError, match="level and one scale"):
            T_E.parallel_shallow_mul(tp, tks, [bad, *rest], T_E.affiliation_streams(1, CPU), device=CPU)


def test_the_card_is_the_default_and_never_falls_back(jobs, monkeypatch):
    tp, tks, tpairs, _ = jobs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T_E.affiliation_streams(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        T_E.parallel_shallow_mul(tp, tks, tpairs)  # device="cuda" by default
    assert len(T_E.affiliation_streams(device=CPU)) == T_E.N_AFFILIATIONS == 8


def test_from_cold_tables_equals_the_lone_muls_and_a_second_call_builds_none(jobs):
    """With every table dropped, the fan-out builds what it reads (on the card,
    from side streams: ``kernels.tables`` makes that safe) and equals each job's
    lone ``ctx.mul`` bit for bit; a second call builds no table."""
    tp, tks, tpairs, _ = jobs
    ctx = T_Ctx(params=tp, keys=tks, policy=T_Policy(backend="ref"), device=CPU)
    alone = [ctx.mul(a, b) for a, b in tpairs]
    tables.clear()
    outs = T_E.parallel_shallow_mul(tp, tks, tpairs, T_E.affiliation_streams(2, CPU), device=CPU)
    built = tables.builds()
    assert built > 0
    for out, want in zip(outs, alone):
        assert torch.equal(out.c0, want.c0) and torch.equal(out.c1, want.c1)
        assert (out.level, out.scale) == (want.level, want.scale)
    again = T_E.parallel_shallow_mul(tp, tks, tpairs, T_E.affiliation_streams(4, CPU), device=CPU)
    assert tables.builds() == built
    assert all(torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1) for a, b in zip(again, outs))
