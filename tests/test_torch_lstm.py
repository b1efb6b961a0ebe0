"""One encrypted LSTM step (``ctx.lstm_step``) at N = 2^11 on the ``lstm`` chain
(L = 13, dnum = 2), hidden 16, against the plain references: the PyTorch one in
``tests/reference_lstm.py`` and the benchmark's NumPy one."""

import pathlib
import sys

import numpy as np
import pytest
import torch

import reference_lstm as ref
from repro_torch.fhe import keys as K
from repro_torch.fhe import lstm
from repro_torch.fhe import params as P
from repro_torch.fhe.context import FheContext

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

N, L, DNUM, WIDTH, N1 = 1 << 11, 13, 2, 16, 4
CFG = {"L": L, "dnum": DNUM, "scale_bits": 30, "n": N, "network": {"hidden": WIDTH},
       "activations": {"sigmoid": {"bound": ref.SIGMOID_BOUND, "power": list(ref.SIGMOID3)},
                       "tanh": {"bound": ref.TANH_BOUND, "power": list(ref.TANH3)}}}
# The largest error a slot of h_t or c_t may carry.  Sound, these weights read
# 6.1e-6 (h_t) and 2.1e-5 (c_t, which carries c_{t−1}'s fresh encryption noise
# through f); the same inputs encrypted at Δ = 2^24, the precision below the
# stated 2^30, and lifted to 2^30 read 2.2e-4 and 7.2e-4: both fail 1e-4.
TOL = 1e-4


def _weights(seed: int, width: int = WIDTH, sigma: float = 0.1):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, sigma, (4, width, width)), rng.normal(0, sigma, (4, width, width)),
            rng.normal(0, 0.1, (4, width)), rng.uniform(-1, 1, (3, width)))


@pytest.fixture(scope="module")
def step():
    torch.set_num_threads(1)
    p = P.make_params(N, L, DNUM, check_security=False)
    W, U, b, msg = _weights(7)
    plan = lstm.build_plan(W, U, b, p, n1=N1)
    ks = K.full_keyset(p, seed=3, rotations=tuple(sorted(plan.rotations())), device="cpu")
    ctx = FheContext(params=p, keys=ks, device="cpu")
    x, h, c = (ctx.encrypt(ctx.encode(lstm.pack(v, p.slots)), seed=11 + k) for k, v in enumerate(msg))
    h_t, c_t = ctx.lstm_step(plan, x, h, c)
    return p, ctx, plan, (W, U, b, msg), h_t, c_t


def test_step_decrypts_to_the_reference(step):
    p, ctx, _, (W, U, b, msg), h_t, c_t = step
    want_h, want_c = ref.step(W, U, b, *msg)
    got_h, got_c = (np.real(np.asarray(ctx.decrypt_decode(ct))) for ct in (h_t, c_t))
    copies = p.slots // WIDTH
    assert np.abs(got_h - np.tile(want_h.numpy(), copies)).max() < TOL
    assert np.abs(got_c - np.tile(want_c.numpy(), copies)).max() < TOL
    assert np.abs(want_h.numpy()).max() > 0.05  # the answer is no near-zero vector


def test_level_and_scale_are_the_bookkeeping(step):
    from fhebench.reference import lstm as np_ref

    p, _, _, _, h_t, c_t = step
    want = ref.bookkeeping(p.q_primes, L, p.scale)
    assert (h_t.level, h_t.scale) == want["h"] and (c_t.level, c_t.scale) == want["c"]
    assert (h_t.level, h_t.scale) == np_ref.bookkeeping(CFG) == (4, p.scale * p.scale / p.q_primes[5])


def test_plan_rotations_and_coefficients(step):
    _, _, plan, _, _, _ = step
    assert plan.rotations() == frozenset(range(1, N1)) | frozenset(range(N1, WIDTH, N1))
    assert all(len(pl.diags) == WIDTH and pl.n1 == N1 for pl in plan.w + plan.u)
    t = np.linspace(-1, 1, 101)
    for coeffs, power, bound in zip(plan.gate_coeffs + (plan.cell_coeffs,), [ref.SIGMOID3] * 3 + [ref.TANH3] * 2,
                                    [8.0, 8.0, 8.0, 4.0, 4.0]):
        direct = ref.poly(power, torch.as_tensor(bound * t)).numpy()
        assert np.abs(np.polynomial.chebyshev.chebval(t, coeffs) - direct).max() < 1e-12


@pytest.mark.parametrize("fit, bound, want, digits", [("sigmoid", 8.0, ref.SIGMOID3, (5e-6, 5e-8)),
                                                       ("tanh", 4.0, ref.TANH3, (5e-6, 5e-7))])
def test_fits_are_least_squares(fit, bound, want, digits):
    """Each fit recomputed on a 200,001-point grid of its interval, over 1, x, x², x³,
    agrees with the stated coefficients to half a unit of their last printed digit."""
    x = np.linspace(-bound, bound, 200_001)
    y = 1.0 / (1.0 + np.exp(-x)) if fit == "sigmoid" else np.tanh(x)
    got = np.linalg.lstsq(np.stack([x**k for k in range(4)], 1), y, rcond=None)[0]
    assert np.abs(got[[0, 2]] - [want[0], want[2]]).max() < 1e-12
    assert abs(got[1] - want[1]) < digits[0] and abs(got[3] - want[3]) < digits[1]


def test_tanh_fit_is_the_scaled_sigmoid_fit():
    x = torch.linspace(-4, 4, 1001, dtype=torch.float64)
    assert torch.allclose(ref.poly(ref.TANH3, x), 2 * ref.poly(ref.SIGMOID3, 2 * x) - 1, atol=1e-12, rtol=0)


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 5])
def test_torch_and_numpy_references_agree(seed):
    from fhebench.reference import lstm as np_ref

    W, U, b, (x, h, c) = _weights(seed, width=128, sigma=0.05)
    th, tc = ref.step(W, U, b, x, h, c)
    nh, nc = np_ref.step(CFG, {"W": W, "U": U, "b": b}, x, h, c)
    assert np.abs(th.numpy() - nh).max() < 1e-12 and np.abs(tc.numpy() - nc).max() < 1e-12


def test_references_refuse_a_pre_activation_outside_its_fit():
    from fhebench.reference import lstm as np_ref

    W, U, b, (x, h, c) = _weights(4)
    b = b.copy()
    b[3, 0] = 5.0  # a_c̃ past tanh3's interval [−4, 4]
    with pytest.raises(AssertionError, match="fit"):
        ref.step(W, U, b, x, h, c)
    with pytest.raises(AssertionError, match="fit"):
        np_ref.step(CFG, {"W": W, "U": U, "b": b}, x, h, c)
