"""One ResNet-20 basic block (``ctx.resnet_block``) at N = 2^10 on the ``resnet20``
chain (L = 41, dnum = 1), 4 channels on an 8 × 8 map (period 256, two copies
over the 512 slots), against the plain references: the PyTorch one in
``tests/reference_resnet.py`` and the benchmark's NumPy one.  Last, one
rotation's noise at dnum = 1: at Δ, and lifted to ≈ Δ² as the block's
convolutions rotate."""

import dataclasses
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

import reference_resnet as ref
from repro_torch.fhe import keys as K
from repro_torch.fhe import linear, ops, resnet
from repro_torch.fhe import params as P
from repro_torch.fhe.context import FheContext

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

N, L, DNUM = 1 << 10, 41, 1
C, H, W = 4, 8, 8
SIGMA = math.sqrt(2 / (9 * C))  # He initialisation over a 3 × 3 × C fan-in
CFG = {"L": L, "dnum": DNUM, "scale_bits": 30, "n": N,
       "network": {"channels": C, "height": H, "width": W},
       "activations": {"relu": {"bound": resnet.BOUND, "g3": list(ref.G3), "f3": list(ref.F3),
                                "stages": ["g3", "g3", "f3", "f3"]}}}
# The largest error a slot of y/B may carry.  Sound, these inputs read 1.2e-6 (the
# fresh encryption's noise through two convolutions that rotate at ≈ Δ² and two
# ReLUs); the same input encrypted at Δ = 2^24, the precision below the stated
# 2^30, and lifted to 2^30 reads 7.0e-5: that fails 1e-5.
TOL = 1e-5


def _inputs(seed: int, c: int = C, h: int = H, w: int = W, sigma: float = SIGMA):
    """x uniform in [0, 1] (c, h, w); conv weights N(0, σ²) (c, c, 3, 3), biases N(0, 0.1²)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (c, h, w))
    w1, w2 = rng.normal(0, sigma, (2, c, c, 3, 3))
    b1, b2 = rng.normal(0, 0.1, (2, c))
    return x, w1, b1, w2, b2


@pytest.fixture(scope="module")
def block():
    torch.set_num_threads(1)
    p = P.make_params(N, L, DNUM, check_security=False)
    x, w1, b1, w2, b2 = _inputs(7)
    plan = resnet.build_plan(w1, b1, w2, b2, p, H, W)
    ks = K.full_keyset(p, seed=3, rotations=tuple(sorted(plan.rotations() | {1})), device="cpu")
    ctx = FheContext(params=p, keys=ks, device="cpu")
    slots = linear.pack(x.reshape(-1), p.slots)
    ct = ctx.encrypt(ctx.encode(slots), seed=11)

    scales = []  # the scale of every ciphertext the block key-switches for a rotation
    with pytest.MonkeyPatch.context() as mp:
        for name in ("_rotate_hoisted_group", "_apply_galois"):
            def spy(ctx, c, *args, _fn=getattr(ops, name), **kwargs):
                scales.append(c.scale)
                return _fn(ctx, c, *args, **kwargs)
            mp.setattr(ops, name, spy)
        sound = ctx.resnet_block(plan, ct)

    low = ctx.encrypt(ctx.encode(slots, scale=2.0**24), seed=11)  # Δ = 2^24, times the integer 64: labelled 2^30
    low = ctx.resnet_block(plan, ops._mul_plain(ctx, low, ops._encode_const(ctx, 1.0, L, 64.0), rescale_after=False))
    return p, ctx, plan, (x, w1, b1, w2, b2), ct, sound, low, scales


def _error(ctx, y, args) -> float:
    want = ref.block(*args, resnet.BOUND).reshape(-1).numpy()
    got = np.real(np.asarray(ctx.decrypt_decode(y)))
    return float(np.abs(got - np.tile(want, got.size // want.size)).max())


def test_block_decrypts_to_the_reference(block):
    p, ctx, _, args, _, sound, _, _ = block
    assert _error(ctx, sound, args) < TOL
    assert ref.block(*args, resnet.BOUND).abs().max() > 0.05  # the answer is no near-zero map


def test_tolerance_fails_the_precision_below(block):
    _, ctx, _, args, _, sound, low, _ = block
    assert low.scale == sound.scale and _error(ctx, low, args) > TOL


def test_level_and_scale_are_the_bookkeeping(block):
    from fhebench.reference import resnet as np_ref

    p, _, _, _, _, y, _, _ = block
    assert (y.level, y.scale) == ref.bookkeeping(p.q_primes, L, p.scale) == np_ref.bookkeeping(CFG)
    assert (y.level, y.scale) == (3, p.scale * p.scale / p.q_primes[4])


def test_every_rotation_runs_near_delta_squared(block):
    """Both convolutions' babies rotate at ≈ Δ² and their giants at ≈ Δ³: no rotation at Δ."""
    p, _, plan, _, _, _, _, scales = block
    groups = [s for s in scales if s < p.scale**2.5]
    assert len(groups) == 2 and all(abs(math.log2(s) - 60) < 1 for s in groups)
    assert len(scales) - 2 == sum(len(c.giant_steps()) for c in plan.convs)
    assert all(abs(math.log2(s) - 90) < 1 for s in scales if s not in groups)


def test_fused_and_staged_give_the_same_bytes(block):
    """The default policy resolves to the staged pipeline on the CPU, to the fused one on the card."""
    _, ctx, plan, _, ct, sound, _, _ = block
    fused = ctx.with_policy(backend="fused")
    assert ctx.pipeline == "staged" and fused.pipeline == "fused"
    y = fused.resnet_block(plan, ct)
    assert (y.level, y.scale) == (sound.level, sound.scale)
    assert torch.equal(y.c0, sound.c0) and torch.equal(y.c1, sound.c1)


def test_a_left_out_stage_reads_wrong(block):
    """The composite less one f₃ (s = f₃ ∘ g₃ ∘ g₃, the ½ and 1 kept in the last series)."""
    _, ctx, plan, args, ct, _, _, _ = block
    short = dataclasses.replace(plan, relu_coeffs=plan.relu_coeffs[:2] + plan.relu_coeffs[3:])
    y = ctx.resnet_block(short, ct)
    assert y.level == 3 + 2 * 4
    assert _error(ctx, y, args) > 100 * TOL
    want = ref.block(*args, resnet.BOUND, stages=(ref.G3, ref.G3, ref.F3)).reshape(-1).numpy()
    got = np.real(np.asarray(ctx.decrypt_decode(y)))
    assert np.abs(got - np.tile(want, got.size // want.size)).max() < TOL  # it is that composite, exactly


@pytest.mark.parametrize("shape", [(C, H, W, 1 << 9), (16, 32, 32, 1 << 15)])  # the test's, the cell's
def test_conv_diagonals_are_the_convolution(shape):
    c, h, w, slots = shape
    x, w1, _, _, _ = _inputs(5, c, h, w)
    diags = resnet.conv_diagonals(w1, h, w, slots)
    assert len(diags) == 9 * c
    v = linear.pack(x.reshape(-1), slots)
    got = sum(diag * np.roll(v, -d) for d, diag in diags.items())
    want = ref.conv3x3(torch.as_tensor(x), w1, np.zeros(c)).reshape(-1).numpy()
    assert np.abs(got - np.tile(want, slots // want.size)).max() < 1e-12


def test_plan_at_the_cell():
    """At the cell: n1 = 2048 from the cost model at both levels, 17 babies and 7 giants, 24 Galois keys."""
    import json

    p = P.workload_params("resnet20")
    assert (p.n, p.L, p.num_digits) == (1 << 16, 41, 1)
    x, w1, b1, w2, b2 = _inputs(6, 16, 32, 32, math.sqrt(2 / 144))
    plan = resnet.build_plan(w1, b1, w2, b2, p, 32, 32)
    cfg = json.loads((ROOT / "fhebench" / "configs" / "resnet20.json").read_text())
    assert [c.n1 for c in plan.convs] == cfg["packing"]["n1"] == [2048, 2048]
    assert all((len(c.baby_steps()), len(c.giant_steps())) == (17, 7) for c in plan.convs)
    assert len(plan.rotations()) == 24 and len(K.galois_elements(p, tuple(plan.rotations()))) == 24
    assert cfg["activations"]["relu"]["bound"] == resnet.BOUND
    assert [cfg["activations"]["relu"][k] for k in cfg["activations"]["relu"]["stages"]] == [
        list(ref.G3), list(ref.G3), list(ref.F3), list(ref.F3)]
    with pytest.raises(ValueError):
        resnet.build_plan(w1[:8], b1, w2, b2, p, 32, 32)


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_torch_and_numpy_references_agree(seed):
    import json

    from fhebench.reference import resnet as np_ref

    cfg = json.loads((ROOT / "fhebench" / "configs" / "resnet20.json").read_text())
    x, w1, b1, w2, b2 = _inputs(seed, 16, 32, 32, math.sqrt(2 / 144))
    weights = {"conv1": w1, "b1": b1, "conv2": w2, "b2": b2}
    mine = ref.block(x, w1, b1, w2, b2, resnet.BOUND).numpy()
    theirs = np_ref.block(cfg, weights, x)
    assert np.abs(mine - theirs).max() < 1e-12 and np.abs(mine).max() > 0.1


def test_references_refuse_a_pre_activation_outside_the_interval():
    from fhebench.reference import resnet as np_ref

    x, w1, b1, w2, b2 = _inputs(4)
    b1 = b1 + 2 * resnet.BOUND  # every pre-activation of the first ReLU past B
    with pytest.raises(AssertionError, match="interval"):
        ref.block(x, w1, b1, w2, b2, resnet.BOUND)
    with pytest.raises(AssertionError, match="interval"):
        np_ref.block(CFG, {"conv1": w1, "b1": b1, "conv2": w2, "b2": b2}, x)


def test_composite_is_the_sign_within_its_error():
    """s lies within 1.41e-4 of sgn on 2^-5 ≤ |x| ≤ 1, and g₃ keeps [−1, 1] inside itself."""
    t = torch.linspace(-1, 1, 200_001, dtype=torch.float64)
    far = t.abs() >= 2**-5
    assert (ref.sign(t)[far] - torch.sign(t[far])).abs().max() < 1.41e-4
    assert ref.poly(ref.G3, t).abs().max() < 0.99977


# One rotation at dnum = 1: the single key-switch digit holds every limb of the
# level, k = ℓ + 1 = 42, and the ModUp's fast basis conversion hands it to the
# key's error uncentred, as d + u·Q with u in [0, k) (tests/test_torch_logreg.py
# holds that cause at dnum = 2).  At Δ = 2^30 that errs by 3.4e-3 of a slot at
# N = 2^10, against 6.9e-6 to 1.1e-5 for the fresh encryption, and by 3.7e-2 at
# 2^12: about 11 times for 4 times N, so most of a slot at 2^16.  The same
# rotation after a constant product left unrescaled, at ≈ Δ², then rescaled,
# carries the fresh encryption's error: the block's convolutions rotate so.
def test_rotation_at_delta_errs_a_hundred_times_the_lifted_one(block):
    p, ctx, _, _, _, _, _, _ = block
    x = np.random.default_rng(1).uniform(-1, 1, p.slots)
    ct = ctx.encrypt(ctx.encode(x), seed=5)
    err = lambda c: float(np.abs(np.real(np.asarray(ctx.decrypt_decode(c))) - np.roll(x, -1)).max())
    at_delta = err(ctx.rotate(ct, 1))
    lifted = err(ctx.rescale(ctx.rotate(ctx.mul_const(ct, 1.0, rescale_after=False), 1)))
    fresh = float(np.abs(np.real(np.asarray(ctx.decrypt_decode(ct))) - x).max())
    assert at_delta > 100 * lifted and at_delta > 1e-3
    assert lifted < 2 * fresh
