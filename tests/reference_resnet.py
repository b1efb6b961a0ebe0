"""Plain PyTorch reference of one ResNet-20 basic block, float64 on the CPU.

He, Zhang, Ren and Sun (CVPR 2016) §4.2, a stage-1 block with batch norm
folded into each convolution's weights and a per-channel bias:

    y = ReLU(x + conv₂(ReLU(conv₁(x) + b₁)) + b₂),

each convolution 3 × 3 of stride 1 with zero padding 1.  The ReLU is the one
that is encrypted: ReLU(t) = t·(1 + s(t/B))/2 with s = f₃ ∘ f₃ ∘ g₃ ∘ g₃ (the
g's first), Cheon, Kim, Kim and Lee's degree-7 composite for sgn on [−1, 1]
(ASIACRYPT 2020).  Every pre-activation must lie in [−B, B]; ``block``
asserts it.  The answer is y/B.

``bookkeeping`` gives the level and scale CKKS leaves on y/B for an input at
the top level L and scale Δ, from a prime chain q_0..q_L.

Imports nothing but torch: no kernel, no cache, no batching.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F3 = (0.0, 35 / 16, 0.0, -35 / 16, 0.0, 21 / 16, 0.0, -5 / 16)
G3 = (0.0, 4589 / 1024, 0.0, -16577 / 1024, 0.0, 25614 / 1024, 0.0, -12860 / 1024)


def poly(coeffs, x: torch.Tensor) -> torch.Tensor:
    return sum(c * x**k for k, c in enumerate(coeffs))


def sign(x: torch.Tensor, stages=(G3, G3, F3, F3)) -> torch.Tensor:
    for coeffs in stages:
        x = poly(coeffs, x)
    return x


def relu(t: torch.Tensor, bound: float, stages=(G3, G3, F3, F3)) -> torch.Tensor:
    assert t.abs().max() <= bound, "a pre-activation leaves the sign's interval"
    return t * (1 + sign(t / bound, stages)) / 2


def conv3x3(x: torch.Tensor, w, b) -> torch.Tensor:
    """x (C, H, W) through a 3 × 3 convolution of stride 1, zero padding 1, plus b."""
    w, b = (torch.as_tensor(a, dtype=torch.float64) for a in (w, b))
    return F.conv2d(x[None], w, b, padding=1)[0]


def block(x, w1, b1, w2, b2, bound: float, stages=(G3, G3, F3, F3)) -> torch.Tensor:
    """y/B of one block from x (C, H, W), the weights (C, C, 3, 3) and biases (C,)."""
    x = torch.as_tensor(x, dtype=torch.float64)
    r = relu(conv3x3(x, w1, b1), bound, stages)
    return relu(x + conv3x3(r, w2, b2), bound, stages) / bound


def bookkeeping(q, L: int, delta: float) -> tuple[int, float]:
    """(level, scale) of y/B: each convolution two levels down at Δ, each ReLU
    seventeen (four degree-7 series to Δ, then t times the last, rescaled)."""
    last = L - 2 - 17 - 2  # the second ReLU's input
    return last - 17, delta * delta / float(q[last - 16])
