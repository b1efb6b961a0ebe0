"""Plain reference of ``lola``: the CryptoNets MNIST network on each image, in float64.

The image, padded with zeros below and to the right, goes through the
convolution (maps × kernel × kernel, stride s) plus its bias, a square, dense
845 → 100 plus bias, a square, and dense 100 → 10 plus bias.  The answer's slot
i holds logit (i mod R), R the last layer's rows padded to a power of two, and
0 where i mod R is past the last row: the layout the client decodes.

Level and scale follow CKKS's bookkeeping from the reference's own prime
chain: a linear layer multiplies by plaintexts at scale Δ and rescales by
q_level; a square multiplies the scale by itself and rescales.
"""

from __future__ import annotations

import numpy as np

from . import ckks


def logits(cfg: dict, weights: dict, image: np.ndarray) -> np.ndarray:
    net = cfg["network"]
    img, pad = net["image"], net["pad"]
    s, k, maps = net["conv"]["stride"], net["conv"]["kernel"], net["conv"]["maps"]
    x = np.zeros((img + pad, img + pad))
    x[:img, :img] = image
    out = (img + pad - k) // s + 1
    conv = np.zeros((maps, out, out))
    for dy in range(k):
        for dx in range(k):
            window = x[dy: dy + s * (out - 1) + 1: s, dx: dx + s * (out - 1) + 1: s]
            conv += weights["conv"][:, dy, dx][:, None, None] * window[None]
    y = (conv + weights["conv.bias"][:, None, None]).ravel() ** 2
    for j in range(1, len(net["dense"]) + 1):
        y = weights[f"dense.{j}"] @ y + weights[f"dense.{j}.bias"]
        if j < len(net["dense"]):
            y = y * y
    return y


def expected(cfg: dict, mix: dict, inputs: dict) -> tuple[int, float, list[np.ndarray]]:
    """(level, scale, [slots of the answer for each pool image])."""
    q, _ = ckks.moduli(cfg["L"], cfg["dnum"])
    delta = float(2 ** cfg["scale_bits"])
    layers = 1 + len(cfg["network"]["dense"])
    level, scale = cfg["L"], delta
    for j in range(layers):
        scale = scale * delta / float(q[level])
        level -= 1
        if j + 1 < layers:
            scale = scale * scale / float(q[level])
            level -= 1
    rows = cfg["network"]["dense"][-1]
    R = 1 << (rows - 1).bit_length()
    i = np.arange(cfg["n"] // 2) % R
    answers = []
    for image in inputs["pool"]:
        y = logits(cfg, inputs["weights"], image)
        answers.append(np.where(i < rows, y[np.minimum(i, rows - 1)], 0.0))
    return level, scale, answers
