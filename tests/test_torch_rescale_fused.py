"""The fused CKKS rescale against the reference package on the CPU.

Under the fused pipeline ``ops._rescale`` runs both components as one
``rescale`` call (``kernels/rescale``): on the card one ``fused_rescale``
launch of ``csrc/rescale.cu``, on the CPU its plain version.  The plain version
must give the reference's ``ops._rescale`` bytes at every ring and level, with
coefficients of the dropped limb planted on both sides of q_ℓ/2 so that both
branches of the centring run; the context must record the reference's
``fhe.trace`` stream and one ``rescale`` dispatch a rescale
(``reference_rescale``), and the staged pipeline the reference's counts.  The
kernel is held to the plain version on the card (``tests/test_torch_gpu.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import reference_rescale
from repro.fhe import ops as R_ops
from repro.fhe import params as R_P
from repro.fhe import trace as R_trace
from repro.fhe.context import ExecPolicy as R_Policy
from repro.fhe.context import FheContext as R_Ctx
from repro.kernels import dispatch as R_dispatch
from repro_torch.fhe import ops as T_ops
from repro_torch.fhe import params as T_P
from repro_torch.fhe import poly as T_poly
from repro_torch.fhe import trace as T_trace
from repro_torch.fhe.context import ExecPolicy as T_Policy
from repro_torch.fhe.context import FheContext as T_Ctx
from repro_torch.kernels import dispatch as T_dispatch
from repro_torch.kernels.ntt.ref import ntt_fwd_ref, ntt_inv_ref
from repro_torch.kernels.rescale import ops as T_rsops
from repro_torch.kernels.rescale import ref as T_rsref

torch.set_num_threads(1)
CPU = "cpu"
# (L, dnum) of the presets whose chains the cells rescale down
PRESET_CHAINS = {"lstm": (13, 2), "logreg": (33, 2), "packed_bootstrap": (57, 1)}


def _params(n, L, dnum):
    return (R_P.make_params(n, L, dnum, check_security=False), T_P.make_params(n, L, dnum, check_security=False))


def _planted(tp, level, seed):
    """c0, c1 at ``level``: random eval-domain limbs below the last, whose last
    limb is the NTT of coefficients with 0, ⌊q_ℓ/2⌋, ⌊q_ℓ/2⌋ + 1 and q_ℓ − 1
    planted among random ones."""
    rng = np.random.default_rng(seed)
    qs = np.array(tp.q_primes[: level + 1], np.int64)[:, None]
    q_last = int(qs[-1, 0])
    out = []
    for _ in range(2):
        c = rng.integers(0, 1 << 31, size=(level + 1, tp.n)) % qs
        coeff = rng.integers(0, q_last, size=(1, tp.n))
        coeff[0, :8] = [0, q_last // 2, q_last // 2 + 1, q_last - 1, q_last // 2 - 1, 1, q_last - 2, q_last // 2]
        c[level:] = ntt_fwd_ref(torch.from_numpy(coeff.astype(np.int32)), T_poly.plan_for(tp, (level,))).numpy()
        out.append(torch.from_numpy(c.astype(np.int32)))
    return out


def _reference(rp, c0, c1, level):
    rctx = R_Ctx(params=rp, policy=R_Policy(backend="ref"))
    rct = R_ops.Ciphertext(c0=jnp.asarray(c0.numpy()), c1=jnp.asarray(c1.numpy()), level=level, scale=2.0 ** 40)
    out = R_ops._rescale(rctx, rct)
    return np.stack([np.asarray(out.c0), np.asarray(out.c1)]).astype(np.int64)


# every ring of 2^8 .. 2^12 at the top and bottom of an L = 6 chain, then the
# presets' chains at the top, middle and bottom (each new shape compiles the
# reference's rescale once)
CASES = ([(1 << logn, 6, 2, lv) for logn in range(8, 13) for lv in (6, 1)]
         + [(1 << logn, L, dnum, lv) for logn, (L, dnum) in zip((12, 10, 8), PRESET_CHAINS.values())
            for lv in (L, L // 2, 1)])


@pytest.mark.parametrize("n, L, dnum, level", CASES,
                         ids=[f"n{n}-L{L}-lv{lv}" for n, L, _, lv in CASES])
def test_plain_version_equals_the_reference_rescale(n, L, dnum, level):
    rp, tp = _params(n, L, dnum)
    c0, c1 = _planted(tp, level, seed=level + n)
    got = torch.stack(T_rsref.rescale_ref(c0, c1, tp, level))
    assert got.dtype == torch.int32 and got.shape == (2, level, n)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), _reference(rp, c0, c1, level))


def test_planted_coefficients_take_both_branches():
    """The planted dropped-limb coefficients lie on both sides of ⌊q_ℓ/2⌋."""
    _, tp = _params(1 << 9, 6, 2)
    level = 6
    c0, _ = _planted(tp, level, seed=1)
    v = ntt_inv_ref(c0[level:], T_poly.plan_for(tp, (level,)))[0, :8].long()
    q_last = tp.q_primes[level]
    assert (v <= q_last // 2).any() and (v > q_last // 2).any()
    assert v.tolist()[:4] == [0, q_last // 2, q_last // 2 + 1, q_last - 1]


@pytest.fixture(scope="module")
def contexts():
    rp, tp = _params(1 << 9, 6, 2)
    return rp, tp


# the reference's "kernel" backend runs its Pallas kernels in interpret mode: one level
@pytest.mark.parametrize("backend, level", [("fused", 6), ("fused", 1), ("kernel", 1), ("staged", 6), ("staged", 1),
                                            ("ref", 6)])
def test_context_rescale_trace_and_dispatches(contexts, backend, level):
    rp, tp = contexts
    c0, c1 = _planted(tp, level, seed=7 * level)
    tctx = T_Ctx(params=tp, policy=T_Policy(backend=backend), device=CPU)
    rctx = R_Ctx(params=rp, policy=R_Policy(backend=backend))
    tct = T_ops.Ciphertext(c0=c0, c1=c1, level=level, scale=2.0 ** 40)
    rct = R_ops.Ciphertext(c0=jnp.asarray(c0.numpy()), c1=jnp.asarray(c1.numpy()), level=level, scale=2.0 ** 40)
    with T_trace.capture_trace() as tt, T_dispatch.count_dispatches() as tc:
        out = T_ops._rescale(tctx, tct)
    with reference_rescale.track() as marks, R_trace.capture_trace() as rt, R_dispatch.count_dispatches() as rc:
        ref = R_ops._rescale(rctx, rct)
    np.testing.assert_array_equal(out.c0.numpy().astype(np.int64), np.asarray(ref.c0).astype(np.int64))
    np.testing.assert_array_equal(out.c1.numpy().astype(np.int64), np.asarray(ref.c1).astype(np.int64))
    assert (out.level, out.scale) == (ref.level, ref.scale)
    assert [(i.op, i.n, i.limbs, i.meta) for i in tt] == [(i.op, i.n, i.limbs, i.meta) for i in rt]
    assert [i.op for i in tt] == ["INTT", "NTT", "PSUB", "PMULT"] * 2
    assert marks.count == 1
    if tctx.plan_fused:
        assert tc == marks.counts(rc) == {"rescale": 1}
    else:
        assert tc == rc == {op: 2 for op in reference_rescale.OPS}


def test_port_counts_formula():
    ref = {"intt": 5, "ntt": 4, "submod": 4, "mulmod": 9, "fusedks": 1}
    assert reference_rescale.port_counts(ref, 2) == {"intt": 1, "mulmod": 5, "fusedks": 1, "rescale": 2}
    with pytest.raises(AssertionError):
        reference_rescale.port_counts({"intt": 1}, 1)


def test_fused_rescale_opens_its_span_inside_the_rescale(contexts):
    _, tp = contexts
    c0, c1 = _planted(tp, 4, seed=3)
    ct = T_ops.Ciphertext(c0=c0, c1=c1, level=4, scale=2.0 ** 40)
    names = {}
    for backend in ("fused", "staged"):
        ctx = T_Ctx(params=tp, policy=T_Policy(backend=backend), device=CPU)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            T_ops._rescale(ctx, ct)
        names[backend] = [e.name for e in prof.events() if e.name.startswith("fhe.rescale")]
    assert names == {"fused": ["fhe.rescale", "fhe.rescale.fused"], "staged": ["fhe.rescale"]}


def test_wrapper_records_one_dispatch_and_builds_the_kernel_tables(contexts):
    _, tp = contexts
    c0, c1 = _planted(tp, 2, seed=5)
    with T_dispatch.count_dispatches() as c:
        out = T_rsops.rescale(c0, c1, tp, 2)
    assert c == {"rescale": 1} and [o.shape for o in out] == [(2, tp.n)] * 2
    t = {k: v.long() & 0xFFFFFFFF for k, v in T_rsops.tables(tp, 3, torch.device(CPU)).items()}
    q_last = tp.q_primes[3]
    q, qinv_neg, half = t["last"].tolist()
    assert (q, half) == (q_last, q_last // 2) and q * qinv_neg % (1 << 32) == (1 << 32) - 1
    assert t["q"].tolist() == list(tp.q_primes[:3]) and t["psi"].shape == (3, tp.n)
    assert t["twinv_l"].shape == t["winv_l"].shape == t["twist_l"].shape == (1, tp.n)
    for e, qe in enumerate(tp.q_primes[:3]):
        assert int(t["neg"][e]) == qe - q_last % qe
        assert int(t["qlinv"][e]) == (pow(q_last, -1, qe) << 32) % qe
