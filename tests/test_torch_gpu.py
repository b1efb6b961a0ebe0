"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test needs a CUDA card, ``nvcc`` and sm_90a (an H100): each skips inside
the ``card`` fixture where there is none.  The last tests run the rotation
slice, the n = 2^8 bootstrap, BGV at ``psi`` and the multi-job executor end
to end on the card against the reference digests of ``chip_smoke.py``, a
Chebyshev evaluation whose constants are built on the card, and
each LM arch at SMOKE size against the port's CPU path; then the sharded
train step on a one-rank NCCL mesh and ``restore(shardings=)`` onto it.  Run
them on the card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.fhe import keys as K
from repro_torch.fhe import linear
from repro_torch.fhe import ntt as nttmod
from repro_torch.fhe import params as P
from repro_torch.fhe import poly, rns
from repro_torch.fhe.context import ExecPolicy, FheContext
from repro_torch.kernels.bconv import ops as bops
from repro_torch.kernels.bconv import ref as bref
from repro_torch.kernels.bsgsmac import ops as bmops
from repro_torch.kernels.bsgsmac import ref as bmref
from repro_torch.kernels.fusedks import ops as fops
from repro_torch.kernels.fusedks import ref as fref
from repro_torch.kernels.hoistrot import ops as hops
from repro_torch.kernels.hoistrot import ref as href
from repro_torch.kernels.modops import ops as mops
from repro_torch.kernels.modops import ref as mref
from repro_torch.kernels.ntt import ops as nops
from repro_torch.kernels.ntt import ref as nref

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _residues(shape, primes, seed, device):
    rng = np.random.default_rng(seed)
    q = np.array(primes, np.uint64).reshape(-1, 1)
    a = (rng.integers(0, 1 << 31, size=shape, dtype=np.uint64) % q).astype(np.int32)
    return torch.from_numpy(a).to(device)


@pytest.mark.parametrize("shape", [(3, 8192), (2, 14, 4096), (14, 65536)], ids=str)
def test_modops_kernel_matches_plain(card, shape):
    qs = P.master_chain(shape[-2])
    a, b = _residues(shape, qs, 1, card), _residues(shape, qs, 2, card)
    before = mops.KERNEL.launches
    for kfn, pfn in ((mops.pointwise_mulmod, mref.mulmod_ref), (mops.pointwise_addmod, mref.addmod_ref),
                     (mops.pointwise_submod, mref.submod_ref)):
        assert torch.equal(kfn(a, b, qs), pfn(a, b, qs))
    c = _residues((shape[-2], 1), qs, 3, card)
    assert torch.equal(mops.pointwise_mulmod(a, c.expand(shape), qs), mref.mulmod_ref(a, c.expand(shape), qs))
    torch.cuda.synchronize()
    assert mops.KERNEL.launches == before + 4


# (batch, limbs, log2 N): every size the card tests and presets use, and the
# paths' row counts: the rescale's single limb and lstm's 14 at 2^16, the MLP's 10 at 2^13
NTT_SHAPES = [(2, 3, logn) for logn in (8, 10, 12, 13, 14, 15, 16)] + [(1, 1, 16), (1, 14, 16), (1, 10, 13)]


@pytest.mark.parametrize("batch, limbs, logn", NTT_SHAPES)
def test_ntt_kernel_matches_plain(card, batch, limbs, logn):
    n = 1 << logn
    primes = P.master_chain(limbs)
    plan = nttmod.build_plan(n, primes)
    x = _residues((batch * limbs, n), primes * batch, logn, card).reshape(batch, limbs, n)
    before = nops.KERNEL.launches
    fwd = nops.ntt_fwd(x, plan)
    assert torch.equal(fwd, nref.ntt_fwd_ref(x, plan))
    assert torch.equal(nops.ntt_inv(x, plan), nref.ntt_inv_ref(x, plan))
    assert torch.equal(nops.ntt_inv(fwd, plan), x)
    torch.cuda.synchronize()
    assert nops.KERNEL.launches == before + 3  # one launch per call, two kernels each


def test_two_pass_kernels_spread_each_limb_over_many_blocks(card):
    for logn in range(13, 17):
        pass1, pass2 = nops.blocks_per_pass(1, 1 << logn)
        assert pass1 > 1 and pass2 > 1
    assert min(nops.blocks_per_pass(14, 1 << 16)) >= 132  # the SMs of an H100
    p = P.workload_params("lstm")
    assert min(fops.ks_blocks_per_pass(p.beta(p.L), p.L + 1 + p.alpha, p.n)) >= 132
    # ModDown over one key-switch's 2 accumulators and a group of 4 rotations' 8, and the hoisted ModUp
    assert fops.moddown_blocks_per_pass(2, p.L + 1, p.n) == (448, 448)
    assert fops.moddown_blocks_per_pass(8, p.L + 1, p.n) == (1792, 1792)
    assert hops.modup_blocks_per_pass(p.beta(p.L), p.L + 1 + p.alpha, p.n) == (672, 672)
    with pytest.raises(ValueError):
        nops.ntt_fwd(torch.zeros((1, 1 << 7), dtype=torch.int32, device=card), nttmod.build_plan(1 << 7, P.master_chain(1)))


# packed_bootstrap: one digit (β = 1) over 58 limbs, m = 116 at level 57 and 60 at level 1
@pytest.mark.parametrize("name", ["matmul", "lstm", "lola_cifar_plain", "dblookup", "packed_bootstrap"])
def test_fused_kernels_match_plain(card, name):
    p = P.workload_params(name)
    # lstm's level 9: 10 limbs in digits of 7, so the second digit is ragged; lola_cifar_plain: β = 4
    for level in sorted({p.L, p.alpha - 1, 1} | ({9} if name == "lstm" else set())):
        ext = poly.primes_for(p, poly.ext_idx(p, level))
        beta, m = p.beta(level), len(ext)
        d = _residues((level + 1, p.n), p.q_primes[: level + 1], level, card)
        ksk = _residues((beta * 2 * m, p.n), ext * (beta * 2), level + 1, card).reshape(beta, 2, m, p.n)
        got = fops.key_switch_digits(d, ksk, p, level)
        want = fref.key_switch_digits_ref(d, ksk, p, level)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for n_acc in (2, 8):  # one key-switch's accumulators, and a hoisted group of 4 rotations' (C = 2R)
            pc = _residues((n_acc * p.alpha, p.n), poly.primes_for(p, poly.p_idx(p)) * n_acc, 7, card)
            pc = pc.reshape(n_acc, p.alpha, p.n)
            qpart = _residues((n_acc * (level + 1), p.n), p.q_primes[: level + 1] * n_acc, 8, card)
            qpart = qpart.reshape(n_acc, level + 1, p.n)
            assert torch.equal(fops.mod_down_digits(pc, qpart, p, level),
                               fref.mod_down_digits_ref(pc, qpart, p, level))


def test_mul_on_the_card_equals_the_cpu(card):
    p = P.make_params(1 << 9, 6, 2, check_security=False)
    z = np.random.default_rng(0).normal(size=p.slots) * 0.4
    outs = []
    for device, backend in ((card, "auto"), ("cpu", "ref")):
        ctx = FheContext(params=p, keys=K.full_keyset(p, seed=0, device=device),
                         policy=ExecPolicy(backend=backend), device=device)
        ct = ctx.encrypt(ctx.encode(z))
        outs.append(ctx.mul(ct, ct))
    assert torch.equal(outs[0].c0.cpu(), outs[1].c0) and torch.equal(outs[0].c1.cpu(), outs[1].c1)


# the staged paths' presets, and the dnum = 1 / large-α presets: packed_bootstrap
# (58 → 116 limbs, and ModDown's 58 → 58), resnet20 (42 → 84), logreg (17 → 51)
@pytest.mark.parametrize("name", ["matmul", "lola_mnist_plain", "lstm", "packed_bootstrap", "resnet20", "logreg"])
def test_bconv_kernel_matches_plain(card, name):
    p = P.workload_params(name)
    before = bops.KERNEL.launches
    p_primes = poly.primes_for(p, poly.p_idx(p))
    for level in sorted({p.L, 1}):
        dst = poly.primes_for(p, poly.ext_idx(p, level))
        convs = [poly.primes_for(p, tuple(i for i in p.digit(j) if i <= level)) for j in range(p.beta(level))]
        for src, to in [(src, dst) for src in convs] + [(p_primes, poly.primes_for(p, poly.q_idx(p, level)))]:
            _, w = rns.bconv_tables(src, to)
            x = _residues((len(src), p.n), src, level + len(to), card)
            assert torch.equal(bops.bconv(x, w, to), bref.bconv_ref(x, w, to))
    torch.cuda.synchronize()
    assert bops.KERNEL.launches > before


def test_bconv_kernel_refuses_what_it_does_not_take(card):
    chain = P.master_chain(66)
    _, w = rns.bconv_tables(chain[:65], chain[65:])
    before = bops.KERNEL.launches
    with pytest.raises(ValueError, match="k ≤ 64"):
        bops.bconv(_residues((65, 1 << 13), chain[:65], 0, card), w, chain[65:])
    with pytest.raises(ValueError, match="multiple of 128"):
        bops.bconv(_residues((3, 192), chain[:3], 1, card), w[:3], chain[65:])
    assert bops.KERNEL.launches == before
    # (coefficient blocks, target chunks): one chunk of every target at N = 2^16,
    # target chunks at N = 2^13 where the coefficient blocks alone are 64
    assert bops.bconv_blocks(58, 116, 1 << 16) == (512, 1)
    assert bops.bconv_blocks(7, 21, 1 << 16) == (512, 1)
    assert bops.bconv_blocks(1, 4, 1 << 13) == (64, 4)
    assert bops.bconv_blocks(3, 10, 1 << 13) == (64, 5)


@pytest.mark.parametrize("name", ["lola_mnist_plain", "lstm", "lola_cifar_plain", "packed_bootstrap"])
def test_hoist_kernels_match_plain(card, name):
    p = P.workload_params(name)
    # lstm's level 9: 10 limbs in digits of 7, so the second digit is ragged; lola_cifar_plain: β = 4
    for level in sorted({p.L, p.alpha - 1, 1} | ({9} if name == "lstm" else set())):
        ext = poly.primes_for(p, poly.ext_idx(p, level))
        beta, m = p.beta(level), len(ext)
        d = _residues((level + 1, p.n), p.q_primes[: level + 1], level, card)
        dig = hops.mod_up_digits(d, p, level)
        assert torch.equal(dig, href.mod_up_digits_ref(d, p, level))
        for nrot in (1, 3):
            ksk = _residues((nrot * beta * 2 * m, p.n), ext * (nrot * beta * 2), nrot, card)
            ksk = ksk.reshape(nrot, beta, 2, m, p.n)
            assert torch.equal(hops.galois_mac(dig, ksk, p, level), href.galois_mac_ref(dig, ksk, p, level))



def test_hoist_mac_is_built_for_every_preset_digit_count(card):
    top = {name: P.workload_params(name) for name in P.WORKLOAD_PRESETS}
    assert max(p.beta(p.L) for p in top.values()) == hops.max_beta()
    p = top["lola_cifar_plain"]  # the preset with the most digits
    level = p.L
    ext = poly.primes_for(p, poly.ext_idx(p, level))
    beta, m = p.beta(level), len(ext)
    dig = _residues((beta * m, p.n), ext * beta, 0, card).reshape(beta, m, p.n)
    ksk = _residues((2 * beta * 2 * m, p.n), ext * (2 * beta * 2), 1, card).reshape(2, beta, 2, m, p.n)
    assert torch.equal(hops.galois_mac(dig, ksk, p, level), href.galois_mac_ref(dig, ksk, p, level))


def _mac_operands(p, level, n1, diagonals, seed, device):
    """``bsgs_mac``'s operands for a plan of ``diagonals`` at ``level`` of ``p``,
    in the plan's layout, with seeded residues."""
    rows, babies, idx, offsets = linear.BsgsPlan(n1=n1, diags=dict.fromkeys(diagonals)).mac_layout()
    qs = p.q_primes[: level + 1]
    diags = _residues((len(rows) * (level + 1), p.n), qs * len(rows), seed, device).reshape(len(rows), -1, p.n)
    bab = _residues((2 * len(babies) * (level + 1), p.n), qs * (2 * len(babies)), seed + 1, device)
    idx, offsets = (torch.tensor(v, dtype=torch.int32, device=device) for v in (idx, offsets))
    return diags, bab.reshape(len(babies), 2, level + 1, p.n), idx, offsets, qs


@pytest.mark.parametrize("i", range(4))
def test_bsgs_mac_kernel_matches_plain(card, i):
    """``chip_smoke.BSGS_MAC_CASES``: one of the LSTM step's plans at N = 2^16,
    14 limbs, and LoLa-MNIST's three at N = 2^13."""
    cases = _chip_smoke().BSGS_MAC_CASES
    assert len(cases) == 4
    preset, level, n1, diagonals = cases[i]
    p = P.workload_params(preset)
    diags, rows, idx, offsets, qs = _mac_operands(p, level, n1, diagonals, level, card)
    before = bmops.KERNEL.launches
    got = bmops.bsgs_mac(diags, rows, idx, offsets, qs)
    torch.cuda.synchronize()
    assert bmops.KERNEL.launches == before + 1
    assert got.shape == (offsets.numel() - 1, 2, level + 1, p.n)
    assert torch.equal(got, bmref.bsgs_mac_ref(diags, rows, idx, offsets, qs))


def test_bsgs_mac_kernel_refuses_what_it_does_not_take(card):
    p = P.workload_params("lola_mnist_plain")
    diags, rows, idx, offsets, qs = _mac_operands(p, 2, 4, tuple(range(16)), 0, card)
    before = bmops.KERNEL.launches
    for bad in ((diags, rows.cpu(), idx, offsets, qs), (diags, rows[:, :1], idx, offsets, qs),
                (diags, rows, idx.long(), offsets, qs), (diags, rows, idx[:-1], offsets, qs),
                (diags, rows, idx, offsets, qs[:-1]), (diags[:, :, 2:], rows[..., 2:], idx, offsets, qs)):
        with pytest.raises((ValueError, TypeError)):
            bmops.bsgs_mac(*bad)
    assert bmops.KERNEL.launches == before


def _rescale_operands(p, level, seed, device):
    """c0, c1 at ``level`` of ``p``: seeded residues, each dropped limb the NTT of
    coefficients with 0, ⌊q_ℓ/2⌋, ⌊q_ℓ/2⌋ + 1 and q_ℓ − 1 planted among seeded
    ones, so both branches of the centring run."""
    qs = p.q_primes[: level + 1]
    q_last = qs[-1]
    out = []
    for c in range(2):
        x = _residues((level + 1, p.n), qs, seed + c, device)
        coeff = _residues((1, p.n), (q_last,), seed + 2 + c, device)
        coeff[0, :4] = torch.tensor([0, q_last // 2, q_last // 2 + 1, q_last - 1], dtype=torch.int32)
        x[level:] = nref.ntt_fwd_ref(coeff, poly.plan_for(p, (level,)))
        out.append(x)
    return out


# the rescale's kernel at the chains of the lstm, logreg and packed_bootstrap presets,
# at N = 2^16 (the presets) and N = 2^13 (the same chains; lola_mnist_plain's ring)
@pytest.mark.parametrize("logn", [13, 16])
@pytest.mark.parametrize("name", ["lstm", "logreg", "packed_bootstrap"])
def test_fused_rescale_kernel_matches_plain(card, name, logn):
    from repro_torch.kernels.rescale import ops as rsops
    from repro_torch.kernels.rescale import ref as rsref

    p = P.workload_params(name)
    if logn != p.n.bit_length() - 1:
        p = P.make_params(1 << logn, p.L, p.dnum, check_security=False)
    for level in sorted({p.L, p.L - 1, p.L // 2, 1}):
        c0, c1 = _rescale_operands(p, level, level, card)
        before = rsops.KERNEL.launches
        got = rsops.rescale(c0, c1, p, level)
        torch.cuda.synchronize()
        assert rsops.KERNEL.launches == before + 1
        assert [g.shape for g in got] == [(level, p.n)] * 2
        assert got[0].data_ptr() != got[1].data_ptr() and all(g.is_contiguous() for g in got)
        want = rsref.rescale_ref(c0, c1, p, level)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), level


def test_fused_rescale_kernel_refuses_what_it_does_not_take(card):
    from repro_torch.kernels.rescale import ops as rsops

    p = P.workload_params("lola_mnist_plain")
    c0, c1 = _rescale_operands(p, 3, 0, card)
    before = rsops.KERNEL.launches
    for bad in ((c0, c1.cpu(), 3), (c0, c1[:3], 3), (c0, c1, 2), (c0.long(), c1.long(), 3), (c0[:1], c1[:1], 0)):
        with pytest.raises((ValueError, TypeError)):
            rsops.rescale(bad[0], bad[1], p, bad[2])
    assert rsops.KERNEL.launches == before


def test_staged_pipeline_and_rotations_on_the_card_equal_the_cpu(card):
    p = P.make_params(1 << 9, 5, 2, check_security=False)
    z = np.random.default_rng(0).normal(size=p.slots) * 0.4
    plan = linear.plan_diags({d: np.full(p.slots, 0.1 * (d + 1)) for d in (0, 1, 2, 9, 17)}, p, hoisting=True)
    outs = []
    for device, backend in ((card, "staged"), (card, "fused"), ("cpu", "ref")):
        ctx = FheContext(params=p, keys=K.full_keyset(p, seed=0, rotations=tuple(plan.rotations()) + (3,),
                                                      conjugate=True, device=device),
                         policy=ExecPolicy(backend=backend), device=device)
        ct = ctx.encrypt(ctx.encode(z))
        g = ctx.rotate_hoisted_group(ct, (1, 2, 3))
        cts = [ctx.mul(ct, ct), g[1], g[2], g[3], ctx.rotate(ct, 3), ctx.conjugate(ct), ctx.apply_bsgs(ct, plan),
               ctx.with_policy(hoisting="never").apply_bsgs(ct, plan)]
        outs.append([(c.c0.cpu(), c.c1.cpu()) for c in cts])
    for got in outs[:2]:
        for (a0, a1), (b0, b1) in zip(got, outs[2]):
            assert torch.equal(a0, b0) and torch.equal(a1, b1)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_lola_mnist_mlp_digests_on_the_card(card):
    cs = _chip_smoke()
    p = P.workload_params(cs.MLP["preset"])
    model = cs.mlp_model(p)
    plan1 = linear.plan_matrix(model["m1"], tol=1e-12, params=p, level=p.L, hoisting=True)
    plan2 = linear.plan_matrix(model["m2"], tol=1e-12, params=p, level=p.L - 2, hoisting=True)
    rots = tuple(sorted(plan1.rotations() | plan2.rotations()))
    ctx = FheContext(params=p, keys=K.full_keyset(p, seed=0, rotations=rots, device=card), device=card)
    ct1 = ctx.apply_bsgs(ctx.encrypt(ctx.encode(model["x_slots"])), plan1)
    ct3 = ctx.apply_bsgs(ctx.square(ct1), plan2)
    assert (cs.digest(ct1), cs.digest(ct3)) == (cs.MLP["ct1"], cs.MLP["ct3"])
    assert np.max(np.abs(ctx.decrypt_decode(ct3).real[:4] - model["want"])) <= cs.MLP["max_err"]


def test_lstm_hoisted_group_digest_on_the_card(card):
    cs = _chip_smoke()
    ref = cs.LSTM_GROUP
    p = P.workload_params(ref["preset"])
    ctx = FheContext(params=p, keys=K.full_keyset(p, seed=0, rotations=ref["rotations"], device=card), device=card)
    ct = ctx.encrypt(ctx.encode(np.random.default_rng(0).normal(size=p.slots) * 0.4))
    g = ctx.rotate_hoisted_group(ct, ref["rotations"])
    assert cs.digest(*(g[r] for r in ref["rotations"])) == ref["digest"]


def test_bootstrap_on_the_card_equals_the_cpu(card):
    """The n = 2^8 bootstrap of tests/test_bootstrap.py: fused and staged on the
    card, the plain versions on the CPU, and chip_smoke.py's reference digest."""
    from repro_torch.fhe import bootstrap as B

    cs = _chip_smoke()
    p = P.make_params(cs.BOOTSTRAP["n"], cs.BOOTSTRAP["L"], cs.BOOTSTRAP["dnum"], check_security=False)
    rng = np.random.default_rng(7)
    z = rng.normal(size=p.slots) * 0.4 + 1j * rng.normal(size=p.slots) * 0.4
    outs = []
    for device, backend in ((card, "auto"), (card, "staged"), ("cpu", "ref")):
        bctx = B.build_context(p, seed=0, h=cs.BOOTSTRAP["h"], device=device)
        ctx = FheContext(params=p, keys=bctx.keys, policy=ExecPolicy(backend=backend), device=device)
        ct = ctx.level_drop(ctx.mul_const(ctx.encrypt(ctx.encode(z)), 1 / 64), 0)
        outs.append(ctx.bootstrap(bctx, ct, post_scale=64))
    for got in outs[:2]:
        assert torch.equal(got.c0.cpu(), outs[2].c0) and torch.equal(got.c1.cpu(), outs[2].c1)
    assert cs.digest(outs[0]) == cs.BOOTSTRAP["digest"]


def test_bgv_on_the_card_equals_the_cpu(card):
    """The BGV path of chip_smoke.py at psi: fused and staged on the card, the
    plain versions on the CPU, the reference's digests and the oracle."""
    cs = _chip_smoke()
    p = P.workload_params("psi")
    msgs = cs.bgv_messages(p)
    oracle = cs.bgv_oracle(msgs, p.n, p.plain_modulus)
    digests = []
    for device, backend in ((card, "auto"), (card, "staged"), ("cpu", "ref")):
        ctx = FheContext(params=p, keys=K.full_keyset(p, seed=0, device=device), policy=ExecPolicy(backend=backend),
                         device=device)
        outs, decoded = cs.bgv_path(ctx, msgs)
        assert all(np.array_equal(decoded[k], oracle[k]) for k in outs)
        digests.append({k: cs.digest(v) for k, v in outs.items()})
    assert digests[0] == digests[1] == digests[2] == cs.BGV["psi"]["digests"]


def test_executor_on_four_streams_equals_four_ctx_muls(card):
    """Four jobs at matmul over four CUDA streams, from cold tables (the side
    streams build them): each output equals its lone ctx.mul, and a second
    fan-out builds no table."""
    from repro_torch.core import executor as E
    from repro_torch.kernels import tables

    cs = _chip_smoke()
    p = P.workload_params(cs.EXECUTOR["preset"])
    ks = K.full_keyset(p, seed=0, device=card)
    ctx = FheContext(params=p, keys=ks, policy=ExecPolicy(backend="ref"), device=card)
    pairs = cs.executor_pairs(ctx)[:4]
    alone = [ctx.mul(a, b) for a, b in pairs]
    tables.clear()
    streams = E.affiliation_streams(4, card)
    assert len({s.cuda_stream for s in streams} | {torch.cuda.current_stream().cuda_stream}) == 5
    outs = E.parallel_shallow_mul(p, ks, pairs, streams, card)
    built = tables.builds()
    assert built > 0
    again = E.parallel_shallow_mul(p, ks, pairs, streams, card)
    assert tables.builds() == built
    assert all(torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1) for a, b in zip(again, outs))
    for got, want in zip(outs, alone):
        assert torch.equal(got.c0, want.c0) and torch.equal(got.c1, want.c1) and got.scale == want.scale
    assert cs.digest(outs[0]) == cs.REFERENCE["matmul"]["digest"]
    assert [cs.digest(o) for o in outs] == list(cs.EXECUTOR["digests"][:4])


def test_eval_poly_builds_its_constants_on_the_card(card, tmp_path):
    """A degree-15 Chebyshev evaluation at N = 2^12 under torch.profiler: no
    host-to-device copy and no NTT pass is launched from inside an
    ``fhe.encode_const`` span (a real constant is a residue column built on the
    card), and the result equals the CPU port's byte for byte."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fhe import polyeval

    p = P.make_params(1 << 12, 7, 1, check_security=False)
    x = np.random.default_rng(11).uniform(-0.9, 0.9, size=p.slots)
    coeffs = polyeval.chebyshev_fit(np.sin, 15)
    outs = []
    for device in (card, "cpu"):
        ctx = FheContext(params=p, keys=K.full_keyset(p, seed=0, device=device), device=device)
        ct = ctx.encrypt(ctx.encode(x))
        outs.append(ctx.eval_poly(ct, coeffs))  # on the card: kernels built and tables cached before the profile
    ctx = FheContext(params=p, keys=K.full_keyset(p, seed=0, device=card), device=card)
    ct = ctx.encrypt(ctx.encode(x))
    ctx.eval_poly(ct, coeffs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = ctx.eval_poly(ct, coeffs)
        torch.cuda.synchronize()
    for got in (outs[0], again):
        assert torch.equal(got.c0.cpu(), outs[1].c0) and torch.equal(got.c1.cpu(), outs[1].c1)
        assert (got.level, got.scale) == (outs[1].level, outs[1].scale)

    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = [e for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"] if e.get("ph") == "X"]
    consts = [(e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
              if e.get("cat") == "user_annotation" and e["name"] == "fhe.encode_const"]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})
                and any(a <= e["ts"] and e["ts"] + e["dur"] <= b and e["tid"] == tid for a, b, tid in consts)}
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and e.get("args", {}).get("correlation") in launched]
    assert len(consts) > 15 and any(e.get("cat") == "kernel" for e in events)
    assert any(e.get("cat") == "kernel" for e in device), "no kernel traced under a constant's span"
    assert not [e["name"] for e in device if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]]
    assert not [e["name"] for e in device if "ntt_pass" in e["name"]]


def test_second_bsgs_application_copies_no_diagonal_to_the_card(card, tmp_path):
    """A plan applied again at the same level and scale reads its diagonals'
    plaintexts back from the card: under torch.profiler the second matvec at
    N = 2^13 opens one ``fhe.bsgs.diag_hit`` span and no ``fhe.encode``, runs
    its products and sums as one ``bsgs_mac`` kernel in one ``fhe.bsgs.mac``
    span, issues no host-to-device copy, and gives the first call's ciphertext
    bit for bit (and the CPU port's)."""
    from torch.profiler import ProfilerActivity, profile

    p = P.workload_params("lola_mnist_plain")
    rng = np.random.default_rng(4)
    diags = {d: rng.normal(size=p.slots) * 0.05 for d in (0, 1, 2, 5, 17, 40)}
    z = rng.uniform(-0.9, 0.9, size=p.slots)
    runs = []
    for device in (card, "cpu"):
        plan = linear.plan_diags(diags, p, hoisting=True)
        ks = K.full_keyset(p, seed=0, rotations=tuple(sorted(plan.rotations())), device=device)
        ctx = FheContext(params=p, keys=ks, device=device)
        ct = ctx.encrypt(ctx.encode(z))
        runs.append((ctx, plan, ct, ctx.apply_bsgs(ct, plan)))
    (ctx, plan, ct, first), (*_, want) = runs
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = ctx.apply_bsgs(ct, plan)
        torch.cuda.synchronize()
    for got in (first, again):
        assert torch.equal(got.c0.cpu(), want.c0) and torch.equal(got.c1.cpu(), want.c1)
        assert (got.level, got.scale) == (want.level, want.scale)

    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = [e for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert spans.count("fhe.bsgs.diag_hit") == spans.count("fhe.bsgs.mac") == 1 and "fhe.encode" not in spans
    assert sum(1 for e in events if e.get("cat") == "kernel" and "bsgs_mac" in e["name"]) == 1
    assert not [e["name"] for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]]


@pytest.mark.parametrize("arch", ["hymba-1.5b", "phi-3-vision-4.2b", "moonshot-v1-16b-a3b", "deepseek-moe-16b",
                                  "mamba2-1.3b", "smollm-135m", "granite-20b", "qwen1.5-110b", "phi3-medium-14b",
                                  "whisper-medium"])
def test_smoke_llm_on_the_card_matches_the_cpu(card, arch):
    """Each LM arch at SMOKE size: prefill and one decode step on the card
    against the port's CPU path at the same weights, under chip_smoke.py's
    bounds (MoE near-tie positions left out of the caches after layer 0)."""
    import copy

    from repro_torch import configs
    from repro_torch.models import registry

    cs = _chip_smoke()
    cfg = configs.get_config(arch, smoke=True)
    api = registry.build(cfg)
    cpu = api.init_params(0, device="cpu")
    inp = cs.smoke_inputs(cfg)
    token = inp.pop("token")
    outs = []
    for dev, params in (("cpu", cpu), (card, copy.deepcopy(cpu).to(card))):
        logits, cache = api.prefill(params, api.init_cache(2, 64, device=dev),
                                    **{k: torch.as_tensor(v, device=dev) for k, v in inp.items()})
        outs.append((logits, cache) + api.decode_step(params, torch.as_tensor(token, device=dev), cache))
    (lc, cc, lc2, cc2), (lg, cg, lg2, cg2) = outs
    assert all(v.device.type == "cuda" for v in (*cg.values(), *cg2.values()))
    ties = cs.near_ties(cfg, cpu, np.concatenate([inp["tokens"], token[:, None]], 1))
    for ref, got in ((lc, lg), (lc2, lg2)):
        assert cs.compare(ref, got, **cs.SMOKE_TOL["logits"])[2]
    for ref, got, t in ((cc, cg, ties[:, :-1]), (cc2, cg2, ties)):
        res = cs.compare_caches(cfg, ref, got, t)
        assert all(v[2] for v in res.values()), res


def _smoke_train_batch(cfg, device):
    cs = _chip_smoke()
    batch = cs.smoke_inputs(cfg, 2, 49)
    batch.pop("token")
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["hymba-1.5b", "phi-3-vision-4.2b", "moonshot-v1-16b-a3b", "deepseek-moe-16b",
                                  "mamba2-1.3b", "smollm-135m", "granite-20b", "qwen1.5-110b", "phi3-medium-14b",
                                  "whisper-medium"])
def test_smoke_train_step_on_the_card_matches_the_cpu(card, arch):
    """One AdamW step of each arch at SMOKE size on the card against the
    port's CPU path at the same weights: loss and gradient norm within
    ``chip_smoke.SMOKE_TRAIN_TOL``, every gradient finite, the state on the
    card; the dense archs' updates within ``chip_smoke.TRAIN_TOL`` as
    ``update_gap`` reads them, and AdamW's second step alone within
    update_lr·lr (the MoE archs' router near-ties move whole tokens'
    gradients, ROADMAP Queue 3)."""
    import copy

    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.training import optimizer as opt

    cs = _chip_smoke()
    cfg = configs.get_config(arch, smoke=True)
    api = registry.build(cfg)
    cpu = api.init_params(0, device="cpu")
    batch = {k: v.numpy() for k, v in _smoke_train_batch(cfg, "cpu").items()}
    acfg = opt.AdamWConfig(**cs.TRAIN_ACFG)
    c, g = (cs.train_once(api, acfg, p, batch) for p in (cpu, copy.deepcopy(cpu).to(card)))
    assert abs(g["loss"] - c["loss"]) <= cs.SMOKE_TRAIN_TOL["loss"]
    assert abs(g["grad_norm"] - c["grad_norm"]) <= cs.SMOKE_TRAIN_TOL["grad_norm_rel"] * c["grad_norm"]
    assert all(bool(torch.isfinite(x).all()) and x.device.type == "cuda" for x in opt.tree_leaves(g["grads"]))
    assert all(x.device.type == "cuda" for x in opt.tree_leaves(g["params"]))
    if not cfg.is_moe:
        leaves = opt.tree_leaves
        up = cs.update_gap(leaves(cpu), leaves(c["params"]), leaves(g["params"]), leaves(c["grads"]),
                           float(opt.lr_at(acfg, 0)))
        assert up["kept"] <= cs.TRAIN_TOL["update_lr"] and up["all"] <= cs.TRAIN_TOL["params_lr"], up
        assert cs.second_step_gap(acfg, c, 0) <= cs.TRAIN_TOL["update_lr"]


def test_train_step_backward_runs_at_reference_precision(card):
    """The train step's backward runs inside ``layers.reference_precision()``:
    with cuBLAS allowed bf16-reduced reductions and TF32 for the process, its
    gradients equal those of a process that allows neither, bit for bit; a
    backward called outside the context gives other gradients."""
    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts

    cfg = configs.get_config("smollm-135m", smoke=True)
    api = registry.build(cfg)
    params = api.init_params(0, device=card)
    batch = _smoke_train_batch(cfg, card)
    m = torch.backends.cuda.matmul
    saved = m.allow_bf16_reduced_precision_reduction, m.allow_tf32
    try:
        m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = False, False
        strict = opt.tree_leaves(ts.loss_and_grads(api, params, batch)[1])
        m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = True, True
        guarded = opt.tree_leaves(ts.loss_and_grads(api, params, batch)[1])
        loose = torch.autograd.grad(api.train_loss(params, **batch), opt.tree_leaves(params))
    finally:
        m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = saved
    assert all(torch.equal(a, b) for a, b in zip(strict, guarded))
    assert not all(torch.equal(a, b) for a, b in zip(strict, loose))


@pytest.mark.parametrize("n", [1, 255, 257, 4097, 589_824])
def test_quantize_on_the_card_equals_the_cpu(card, n):
    from repro_torch.training import compress

    x = torch.from_numpy(np.random.default_rng(n).standard_normal(n).astype(np.float32) * 3)
    q, s = compress.quantize(x.to(card))
    qc, sc = compress.quantize(x)
    assert q.device.type == "cuda" and torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)
    back = compress.dequantize(q, s, x.shape, x.dtype)
    assert torch.equal(back.cpu(), compress.dequantize(qc, sc, x.shape, x.dtype))
    shared = sc * 2
    assert torch.equal(compress.quantize(x.to(card), shared.to(card))[0].cpu(), compress.quantize(x, shared)[0])


@pytest.fixture
def nccl_mesh(card):
    """A 1×1 ("data", "model") mesh over a one-rank NCCL group; ended after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import single_device_mesh

    if dist.is_initialized():
        dist.destroy_process_group()
    mesh = single_device_mesh("cuda")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b"])
def test_sharded_step_on_a_one_rank_nccl_mesh_equals_the_plain_step(nccl_mesh, arch):
    """``jit_train_step`` on a 1×1 NCCL mesh (every leaf a DTensor whose local
    shard is the whole tensor): two steps equal ``build_train_step(mesh=None)``
    bit for bit, weights, moments, loss and gradient norm."""
    from repro_torch import configs
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import registry
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts

    cfg = configs.get_config(arch, smoke=True)
    api = registry.build(cfg)
    params = api.init_params(0, device="cuda")
    acfg = opt.AdamWConfig(lr_peak=3e-3, warmup_steps=5, total_steps=40)
    spec = {k: v[1] for k, v in api.input_specs("train_4k", nccl_mesh).items()}
    batch = _smoke_train_batch(cfg, torch.device("cuda"))
    out = {}
    for name, step in (("plain", ts.build_train_step(api, None, acfg)),
                       ("sharded", ts.jit_train_step(api, nccl_mesh, acfg, spec))):
        p, s = params, opt.init_state(params)
        metrics = []
        for _ in range(2):
            p, s, m = step(p, s, batch)
            metrics.append([float(v.full_tensor() if sh.is_dtensor(v) else v) for v in m.values()])
        out[name] = (opt.tree_leaves(p) + opt.tree_leaves(s), metrics)
    local = lambda x: (x.to_local() if sh.is_dtensor(x) else x).detach()
    assert out["plain"][1] == out["sharded"][1]
    assert all(torch.equal(local(a), local(b)) for a, b in zip(out["plain"][0], out["sharded"][0]))
    assert all(sh.is_dtensor(x) for x in out["sharded"][0])


def test_restore_onto_dtensor_placements_on_the_card(nccl_mesh, tmp_path):
    """``restore(shardings=)`` places each named array as a DTensor on the
    mesh's card; the others follow ``device``."""
    from torch.distributed.tensor import Replicate

    from repro_torch.checkpoint import manager
    from repro_torch.distributed import sharding as sh

    tree = {"params": {"w": np.arange(24, dtype=np.float32).reshape(4, 6), "b": np.ones(3, np.float32)},
            "step": np.int32(7)}
    manager.save(str(tmp_path), 3, tree)
    step, got = manager.restore(str(tmp_path), shardings={"params/w": sh.named(nccl_mesh, sh.Spec("data", "model"))},
                                device="cuda")
    w = got["params"]["w"]
    # a 1×1 mesh's placements are Replicate(): a one-way shard is the whole tensor
    assert step == 3 and sh.is_dtensor(w) and w.placements == (Replicate(), Replicate())
    assert w.device.type == "cuda" and np.array_equal(w.full_tensor().cpu().numpy(), tree["params"]["w"])
    assert not sh.is_dtensor(got["params"]["b"]) and got["params"]["b"].device.type == "cuda"
    _, again = manager.restore(str(tmp_path), shardings={"params": {"b": (nccl_mesh, (Replicate(), Replicate()))}})
    assert again["params"]["b"].placements == (Replicate(), Replicate()) and isinstance(again["params"]["w"], np.ndarray)
