"""Plain reference of ``resnet``: one basic block of ResNet-20 in NumPy float64,
with the configuration's composite-polynomial ReLU.

    y = ReLU(x + conv₂(ReLU(conv₁(x) + b₁)) + b₂),

each convolution 3 × 3 of stride 1 with zero padding 1 over C channels (the
weights ``conv1``, ``conv2`` of shape (C, C, 3, 3), output channel first, and
the biases ``b1``, ``b2``: batch norm folded in), and ReLU(t) = t·(1 + s(t/B))/2
with s the configuration's ``activations.relu`` stages (power coefficients,
applied in order) and B its bound.  Every pre-activation must lie in [−B, B],
and ``block`` asserts it.  A message is the map x (C, H, W); the answer is
y/B, and its slot i holds (y/B)[i mod C·H·W] in channel-major order.
Departures from ResNet-20: one block of nine, no bootstrap around it.

Level and scale follow CKKS's bookkeeping from the reference's own prime chain
for an input at the top level L and scale Δ: each convolution two levels at Δ,
each ReLU seventeen (four degree-7 series of four levels each landing at Δ,
then t times the last series, rescaled once), so y/B comes out at L − 38 at
scale Δ²/q_{L−37}.
"""

from __future__ import annotations

import numpy as np

from . import ckks


def _poly(power, x: np.ndarray) -> np.ndarray:
    return sum(c * x**k for k, c in enumerate(power))


def conv3x3(x: np.ndarray, w: np.ndarray, b: np.ndarray) -> np.ndarray:
    """A 3 × 3 convolution of stride 1 and zero padding 1 of x (C, H, W) plus a bias a channel."""
    _, height, width = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1)))
    out = np.zeros((w.shape[0], height, width)) + np.asarray(b)[:, None, None]
    for dh in range(3):
        for dw in range(3):
            out += np.einsum("oi,ihw->ohw", w[:, :, dh, dw], xp[:, dh : dh + height, dw : dw + width])
    return out


def relu(cfg: dict, t: np.ndarray) -> np.ndarray:
    r = cfg["activations"]["relu"]
    assert np.abs(t).max() <= r["bound"], "a pre-activation leaves the sign's interval"
    s = t / r["bound"]
    for stage in r["stages"]:
        s = _poly(r[stage], s)
    return t * (1 + s) / 2


def block(cfg: dict, weights: dict, x) -> np.ndarray:
    """y/B of one block."""
    x = np.asarray(x, np.float64)
    a1 = conv3x3(x, weights["conv1"], weights["b1"])
    y = relu(cfg, x + conv3x3(relu(cfg, a1), weights["conv2"], weights["b2"]))
    return y / cfg["activations"]["relu"]["bound"]


def bookkeeping(cfg: dict) -> tuple[int, float]:
    """(level, scale) of y/B."""
    q, _ = ckks.moduli(cfg["L"], cfg["dnum"])
    delta = float(2 ** cfg["scale_bits"])
    last = cfg["L"] - 2 - 17 - 2  # the second ReLU's input
    return last - 17, delta * delta / float(q[last - 16])


def expected(cfg: dict, mix: dict, inputs: dict) -> tuple[int, float, list[np.ndarray]]:
    """(level, scale, [slots of y/B for each message of the pool])."""
    level, scale = bookkeeping(cfg)
    net = cfg["network"]
    copies = cfg["n"] // 2 // (net["channels"] * net["height"] * net["width"])
    return level, scale, [np.tile(block(cfg, inputs["weights"], x).reshape(-1), copies) for x in inputs["pool"]]
