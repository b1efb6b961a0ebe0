"""Plain PyTorch reference of one period of encrypted logistic-regression
training, float64 on the CPU.

HELR (Han, Hong, Cheon and Park, AAAI 2019): Nesterov's accelerated gradient on
the log-likelihood of a mini-batch of m samples z_i = y_i·x_i,

    w⁺ = v + (γ_t/m)·Σ_i σ3(−z_i·v)·z_i,    v⁺ = (1 − η_t)·w⁺ + η_t·w,

from w = v = w_0, with σ3(x) = 0.5 + 0.15012·x − 0.0015930·x³, the degree-3
least-squares fit of the logistic function on [−8, 8] (the model that is
encrypted).  Every argument z_i·v must lie in that interval; ``train`` asserts
it.  Departures from HELR: one mini-batch serves every iteration of the period
(HELR draws a new one each iteration), and the period ends without the
bootstrap that would follow it.

``bookkeeping`` gives the level and scale CKKS leaves on w_k and v_k for
inputs at the top level L and scale Δ, from a prime chain q_0..q_L.

Imports nothing but torch: no kernel, no cache, no batching.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SIGMOID3 = (0.5, 0.15012, 0.0, -0.0015930)
BOUND = 8.0


def poly(coeffs, x: torch.Tensor) -> torch.Tensor:
    return sum(c * x**k for k, c in enumerate(coeffs))


def train(z, w0, learning_rates, momenta) -> tuple[torch.Tensor, torch.Tensor]:
    """(w_k, v_k) from the batch z (m, f), the initial model w0 (f,) and one
    (γ_t, η_t) an iteration."""
    z, w = (torch.as_tensor(t, dtype=torch.float64) for t in (z, w0))
    v = w
    for gamma, eta in zip(learning_rates, momenta):
        a = z @ v
        assert a.abs().max() <= BOUND, "an argument z·v leaves σ3's fit"
        w_next = v + gamma / z.shape[0] * (poly(SIGMOID3, -a) @ z)
        v = (1 - eta) * w_next + eta * w
        w = w_next
    return w, v


def bookkeeping(q, L: int, delta: float, iterations: int) -> dict:
    """{"w": (level, scale), "v": (level, scale)}: from v at ℓ, Z⊙v rescales to
    ℓ − 1, the mask (encoded to land at Δ) to ℓ − 2, σ3's degree-3 Chebyshev
    series lands at ℓ − 5 at Δ, g⊙Z (Z at Δ) rescales to ℓ − 6 at Δ²/q_{ℓ−5},
    and w⁺ = v + Δw takes that; v⁺'s constant products land at ℓ − 7 at Δ."""
    last = L - 7 * (iterations - 1)  # v's level at the last iteration
    return {"w": (last - 6, delta * delta / float(q[last - 5])), "v": (last - 7, delta)}
