"""Plain PyTorch reference of one LSTM step, float64 on the CPU.

The standard LSTM cell with a forget gate, gates in the order (f, i, o, c̃):

    a = W·x + U·h + b,  f, i, o = σ3(a_f, a_i, a_o),  c̃ = tanh3(a_c̃),
    c_t = f⊙c + i⊙c̃,  h_t = o⊙tanh3(c_t),

with the polynomial activations that the encrypted step evaluates (the model
that is encrypted): σ3(x) = 0.5 + 0.15012·x − 0.0015930·x³, the least-squares
fit of the logistic function on [−8, 8], and tanh3(x) = 2·σ3(2x) − 1 =
0.60048·x − 0.025488·x³, the least-squares fit of tanh on [−4, 4].  Each
activation's argument must lie in its fit's interval; ``step`` asserts it.

``bookkeeping`` gives the level and scale CKKS leaves on h_t and c_t for inputs
at the top level L and scale Δ, from a prime chain q_0..q_L.

Imports nothing but torch: no kernel, no cache, no batching.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SIGMOID3 = (0.5, 0.15012, 0.0, -0.0015930)
TANH3 = (0.0, 0.60048, 0.0, -0.025488)
SIGMOID_BOUND, TANH_BOUND = 8.0, 4.0


def poly(coeffs, x: torch.Tensor) -> torch.Tensor:
    return sum(c * x**k for k, c in enumerate(coeffs))


def step(W, U, b, x, h, c) -> tuple[torch.Tensor, torch.Tensor]:
    """(h_t, c_t) from W (4, p, p), U (4, p, p), b (4, p) and x, h, c (p,), float64."""
    W, U, b, x, h, c = (torch.as_tensor(t, dtype=torch.float64) for t in (W, U, b, x, h, c))
    a = W @ x + U @ h + b
    assert a[:3].abs().max() <= SIGMOID_BOUND and a[3].abs().max() <= TANH_BOUND, "a pre-activation leaves its fit"
    f, i, o = poly(SIGMOID3, a[:3])
    c_t = f * c + i * poly(TANH3, a[3])
    assert c_t.abs().max() <= TANH_BOUND, "c_t leaves tanh3's fit"
    return o * poly(TANH3, c_t), c_t


def bookkeeping(q, L: int, delta: float) -> dict:
    """{"h": (level, scale), "c": (level, scale)}: a matvec rescales the product
    with its diagonals at Δ; a degree-3 Chebyshev activation takes three levels
    and lands at Δ; a gate product of two values at Δ rescales once; c_t/4 is a
    relabelling of the scale."""
    gates = L - 1
    act = gates - 3
    c = (act - 1, delta * delta / float(q[act]))
    tanh = c[0] - 3
    return {"h": (tanh - 1, delta * delta / float(q[tanh])), "c": c}
