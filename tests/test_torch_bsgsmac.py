"""``bsgs_mac``, a BSGS matvec's diagonal products and sums in one launch, on the CPU.

Its plain version (``kernels/bsgsmac/ref.py``) is held bit for bit to the
``mulmod``/``addmod`` chain the reference runs, on seeded residues over plan
shapes from N = 2^8 to 2^13, 1 to 14 limbs, n1 of 1 to 16, giant groups of one
diagonal and plans that use only some babies; the arithmetic of
``csrc/bsgsmac.cu`` (a montmul a product, the group summed in 64 bits, one REDC
and one montmul by R³) is modelled in NumPy and held to it, extreme residues
included.  Then ``apply_bsgs`` at LoLa-MNIST's and the LSTM step's plan shapes
(25 diagonals at n1 = 14, 128 at n1 = 16, 128 at n1 = 8) gives the reference
package's bytes under every hoisting mode, fresh and reused, with the
reference's ``fhe.trace`` stream and the dispatch counts of ``reference_bsgs``.
"""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import reference_bsgs
import torch

from repro.fhe import keys as R_K
from repro.fhe import linear as R_lin
from repro.fhe import ops as R_ops
from repro.fhe import params as R_P
from repro.fhe import trace as R_trace
from repro.fhe.context import ExecPolicy as R_Policy
from repro.fhe.context import FheContext as R_Ctx
from repro.kernels import dispatch as R_dispatch
from repro_torch.fhe import keys as T_K
from repro_torch.fhe import linear as T_lin
from repro_torch.fhe import modmath
from repro_torch.fhe import params as T_P
from repro_torch.fhe import trace as T_trace
from repro_torch.fhe.context import ExecPolicy as T_Policy
from repro_torch.fhe.context import FheContext as T_Ctx
from repro_torch.kernels import dispatch as T_dispatch
from repro_torch.kernels.bsgsmac import ops as bm
from repro_torch.kernels.bsgsmac import ref as bref
from repro_torch.kernels.modops import ops as mo

torch.set_num_threads(1)

CPU = "cpu"
PRIMES = T_P.workload_params("lstm").q_primes  # 14 primes of 30 bits


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


LOLA_CONV = _chip_smoke().LOLA_CONV_DIAGONALS  # LoLa-MNIST's 25 convolution taps, in its packing's order


# (N, limbs, n1, diagonals): LoLa's three plans, the LSTM step's, one diagonal a
# giant (n1 = 1, and a plan whose every group has one), babies 0 and 2 unused
MAC_CASES = {
    "n1=1": (1 << 8, 1, 1, (0, 1, 2, 5, 7)),
    "one a giant": (1 << 9, 3, 4, (1, 6, 11, 12, 19)),
    "missing babies": (1 << 9, 2, 4, (1, 3, 5, 13, 7, 15)),
    "lola conv": (1 << 11, 7, 14, LOLA_CONV),
    "lola dense 845-100": (1 << 13, 7, 16, tuple(range(128))),
    "lola dense 100-10": (1 << 13, 5, 4, tuple(range(16))),
    "lstm": (1 << 12, 14, 8, tuple(range(128))),
    "sparse, out of order": (1 << 10, 9, 8, (40, 3, 17, 0, 63, 9, 41)),
}


def mac_operands(n, limbs, n1, diagonals, seed=0, extreme=False):
    """The operands ``_apply_bsgs`` hands ``bsgs_mac`` for a plan of these
    diagonals, with seeded residues (or every residue q − 1)."""
    plan = T_lin.BsgsPlan(n1=n1, diags=dict.fromkeys(diagonals))
    order, babies, idx, offsets = plan.mac_layout()
    qs = PRIMES[:limbs]
    q = np.asarray(qs, np.int64)[:, None]
    rng = np.random.default_rng(seed)
    draw = (lambda *s: np.broadcast_to(q - 1, s)) if extreme else (lambda *s: rng.integers(0, q, size=s))
    diags = torch.from_numpy(np.ascontiguousarray(draw(len(order), limbs, n)).astype(np.int32))
    rows = torch.from_numpy(np.ascontiguousarray(draw(len(babies), 2, limbs, n)).astype(np.int32))
    idx, offsets = (torch.tensor(v, dtype=torch.int32) for v in (idx, offsets))
    return plan, diags, rows, idx, offsets, qs


def chain(diags, rows, idx, offsets, qs):
    """The reference's products and sums: a ``mulmod`` per diagonal and
    component, an ``addmod`` per term after a group's first."""
    off, out = offsets.tolist(), []
    for a, b in zip(off, off[1:]):
        acc = None
        for d in range(a, b):
            term = [mo.pointwise_mulmod(rows[int(idx[d]), c], diags[d], qs) for c in (0, 1)]
            acc = term if acc is None else [mo.pointwise_addmod(x, y, qs) for x, y in zip(acc, term)]
        out.append(torch.stack(acc))
    return torch.stack(out)


@pytest.mark.parametrize("case", list(MAC_CASES))
def test_plain_version_is_the_mulmod_addmod_chain(case):
    n, limbs, n1, diagonals = MAC_CASES[case]
    plan, diags, rows, idx, offsets, qs = mac_operands(n, limbs, n1, diagonals)
    with T_dispatch.count_dispatches() as want_counts:
        want = chain(diags, rows, idx, offsets, qs)
    with T_dispatch.count_dispatches() as got_counts:
        got = bm.bsgs_mac(diags, rows, idx, offsets, qs)
    assert got.dtype == torch.int32 and got.shape == (len(plan.giant_groups()), 2, limbs, n)
    assert torch.equal(got, want)
    d, g = reference_bsgs.diagonals_and_giants(plan)
    assert want_counts == {k: v for k, v in {"mulmod": 2 * d, "addmod": 2 * (d - g)}.items() if v}
    assert got_counts == {"bsgsmac": 1}


# ---------------------------------------------------------------------------
# the arithmetic of csrc/bsgsmac.cu, modelled in NumPy
# ---------------------------------------------------------------------------

M32 = np.uint64(0xFFFFFFFF)


def montmul(a, b, q, qinv):
    """a·b·2^-32 mod q, canonical, as montgomery.cuh's montmul (a·b < q·2^32)."""
    return montredc64(a * b, q, qinv)


def montredc64(t, q, qinv):
    """t·2^-32 mod q, canonical, as montgomery.cuh's montredc64 (t < q·2^32)."""
    m = ((t & M32) * qinv) & M32
    u = (t >> np.uint64(32)) + ((m * q) >> np.uint64(32)) + ((t & M32) != 0).astype(np.uint64)
    return np.where(u >= q, u - q, u)


def kernel_model(diags, rows, idx, offsets, qs):
    c = modmath.mont_constants_array(qs)
    q, qinv, r2 = (c[k].astype(np.uint64)[:, None] for k in ("q", "qinv_neg", "r2"))
    r3 = montmul(r2, r2, q, qinv)
    x, y = diags.numpy().astype(np.uint64), rows.numpy().astype(np.uint64)
    off, out = offsets.tolist(), []
    for a, b in zip(off, off[1:]):
        acc = np.zeros(y.shape[1:], np.uint64)
        for d in range(a, b):
            acc += montmul(x[d], y[int(idx[d])], q, qinv)  # < 2^31 a term: no wrap below 2^33 terms
        out.append(montmul(montredc64(acc, q, qinv), r3, q, qinv))
    return torch.from_numpy(np.stack(out).astype(np.int64))


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("case", ["n1=1", "missing babies", "lola conv", "lstm"])
def test_kernel_arithmetic_is_the_plain_version(case, extreme):
    n, limbs, n1, diagonals = MAC_CASES[case]
    _, diags, rows, idx, offsets, qs = mac_operands(n, limbs, n1, diagonals, seed=1, extreme=extreme)
    want = bref.bsgs_mac_ref(diags, rows, idx, offsets, qs)
    assert torch.equal(kernel_model(diags, rows, idx, offsets, qs), want.long())


def test_stack_operands_follow_the_plan():
    """A plan's stack: rows grouped by giant in the reference's order, each
    row's baby and each group's first row, on the context's device."""
    p = T_P.make_params(1 << 9, 2, 1, check_security=False)
    ctx = T_Ctx(params=p, device=CPU)
    rng = np.random.default_rng(2)
    diagonals = (40, 3, 17, 0, 63, 9, 41)  # n1 = 8: giants 5, 0, 2, 0, 7, 1, 5; babies 0, 1, 3, 7
    plan = T_lin.plan_diags({d: rng.normal(size=p.slots) for d in diagonals}, p, n1=8)
    assert plan.giant_groups() == ((0, (3, 0)), (1, (9,)), (2, (17,)), (5, (40, 41)), (7, (63,)))
    assert plan.mac_layout() == ((3, 0, 9, 17, 40, 41, 63), (0, 1, 3, 7), (2, 0, 1, 1, 0, 1, 3), (0, 2, 3, 4, 6, 7))
    st, _ = plan.stack(ctx, 1, p.scale)
    assert st.babies == (0, 1, 3, 7)
    assert st.baby_idx.tolist() == [2, 0, 1, 1, 0, 1, 3] and st.offsets.tolist() == [0, 2, 3, 4, 6, 7]
    assert st.baby_idx.dtype == st.offsets.dtype == torch.int32 and st.data.shape == (7, 2, p.n)
    for row, d in enumerate((3, 0, 9, 17, 40, 41, 63)):
        assert st.plaintexts[d].data.data_ptr() == st.data[row].data_ptr()
    assert plan.stack(ctx, 1, p.scale)[0] is st


# ---------------------------------------------------------------------------
# apply_bsgs at LoLa-MNIST's and the LSTM step's plan shapes, fresh and reused
# ---------------------------------------------------------------------------

# (N, L, dnum, n1, diagonals)
SHAPES = {
    "lola conv": (1 << 11, 2, 1, 14, LOLA_CONV),
    "lola dense 845-100": (1 << 9, 2, 1, 16, tuple(range(128))),
    "lstm": (1 << 9, 3, 2, 8, tuple(range(128))),
}


@dataclasses.dataclass
class Shape:
    tp: object
    tctx: object
    tct: object
    rctx: object
    rct: object
    tplan: object
    rplan: object


@pytest.fixture(scope="module", params=list(SHAPES))
def shape(request):
    n, L, dnum, n1, diagonals = SHAPES[request.param]
    rp = R_P.make_params(n, L, dnum, check_security=False)
    tp = T_P.make_params(n, L, dnum, check_security=False)
    rng = np.random.default_rng(17)
    diags = {d: (rng.normal(size=tp.slots) + 1j * rng.normal(size=tp.slots)) * 0.02 for d in diagonals}
    tplan, rplan = T_lin.plan_diags(diags, tp, n1=n1), R_lin.plan_diags(diags, rp, n1=n1)
    rots = tuple(sorted(tplan.rotations()))
    rctx = R_Ctx(params=rp, keys=R_K.full_keyset(rp, seed=4, rotations=rots, conjugate=False),
                 policy=R_Policy(backend="ref"))
    tctx = T_Ctx(params=tp, keys=T_K.full_keyset(tp, seed=4, rotations=rots, conjugate=False, device=CPU),
                 policy=T_Policy(backend="ref"), device=CPU)
    z = rng.uniform(-0.9, 0.9, size=tp.slots)
    return Shape(tp, tctx, tctx.encrypt(tctx.encode(z)), rctx, rctx.encrypt(rctx.encode(z)), tplan, rplan)


@pytest.mark.parametrize("hoisting", ["never", "auto", "always"])
def test_plan_shapes_fresh_and_reused_match_reference(shape, hoisting, monkeypatch):
    s = shape
    tctx, rctx = s.tctx.with_policy(hoisting=hoisting), s.rctx.with_policy(hoisting=hoisting)
    plan = dataclasses.replace(s.tplan)
    with T_trace.capture_trace() as fresh, T_dispatch.count_dispatches() as fresh_counts:
        first = tctx.apply_bsgs(s.tct, plan)
    with T_trace.capture_trace() as reused, T_dispatch.count_dispatches() as reused_counts:
        second = tctx.apply_bsgs(s.tct, plan)
    ntts = []
    encode = R_ops._encode

    def marked(ctx, z, level=None, scale=None):
        ntts.append(len(R_trace._TRACE.get()))
        return encode(ctx, z, level=level, scale=scale)

    monkeypatch.setattr(R_ops, "_encode", marked)
    with R_trace.capture_trace() as rt, R_dispatch.count_dispatches() as rc:
        want = rctx.apply_bsgs(s.rct, s.rplan)
    for got in (first, second):
        np.testing.assert_array_equal(got.c0.numpy().astype(np.int64), np.asarray(want.c0).astype(np.int64))
        np.testing.assert_array_equal(got.c1.numpy().astype(np.int64), np.asarray(want.c1).astype(np.int64))
        assert (got.level, got.scale) == (want.level, want.scale)
    stream = lambda t: [(i.op, i.n, i.limbs, i.meta) for i in t]
    port = reference_bsgs.port_counts(rc, [s.rplan])
    assert stream(fresh) == stream(rt) and fresh_counts == port
    assert len(ntts) == len(s.tplan.diags) and all(rt[i].op == "NTT" for i in ntts)
    assert stream(reused) == stream([ins for i, ins in enumerate(rt) if i not in set(ntts)])
    assert reused_counts == {**port, "ntt": port["ntt"] - len(s.tplan.diags)}
