"""The operations of one ``resnet`` job, as (name, level[, k]) for ``cost.least_seconds``.

A convolution from level ℓ: the lift (a plaintext product by a constant, not
rescaled) at ℓ; the BSGS matvec over its C·9 diagonals d = (Δc·H·W + Δh·W + Δw)
mod C·H·W with the configuration's n1 (``cost.lola.bsgs``: the hoisted baby
group, the products, the adds, the giant rotations and the rescale) at ℓ; the
second rescale at ℓ − 1; the bias (a plaintext add) at ℓ − 2.

A ReLU from ℓ: each of its four stages a degree-7 Chebyshev series as
``polyeval`` evaluates it (``series``), four levels each; then t times the last
series at ℓ − 16, relinearised and rescaled.  The shortcut: x dropped to the
second convolution's level plus one, a constant product rescaled there, and
the add.
"""

from __future__ import annotations

import numpy as np

from fhebench.cost.lola import bsgs

NONZERO = 1e-14  # coefficients below this are left out of the sum


def series(c: np.ndarray, level: int) -> list[tuple]:
    """Σ c_i·T_i from T_1 at ``level``: the basis T_j = 2·T_a·T_b − T_{b−a} (a = ⌊j/2⌋;
    a square less 1 where a = b), T_{b−a} negated and brought down by a plaintext product by one,
    then a plaintext product for each non-zero coefficient, each term brought down
    to the series' last level as needed, the adds and c_0."""
    lv = {1: level}
    out: list[tuple] = []
    for j in range(2, len(c)):
        a, b = j // 2, j - j // 2
        lv[j] = min(lv[a], lv[b]) - 1
        out += [("square" if a == b else "mul", lv[j] + 1), ("add", lv[j])]
        if a == b:
            out.append(("add_plain", lv[j]))
        else:
            out += [("negate", lv[b - a]), ("mul_plain_rescale", lv[j] + 1), ("add", lv[j])]
    star = min(lv.values()) - 1
    terms = [i for i in range(1, len(c)) if abs(c[i]) >= NONZERO]
    for i in terms:
        out.append(("mul_plain_rescale", lv[i]))
        if lv[i] - 1 > star:
            out.append(("mul_plain_rescale", star + 1))
    out += [("add", star)] * (len(terms) - 1)
    if abs(c[0]) >= NONZERO:
        out.append(("add_plain", star))
    return out


def stages(cfg: dict) -> list[np.ndarray]:
    """The ReLU's four series on [−1, 1]: the configuration's stages, the last as (1 + f)/2."""
    r = cfg["activations"]["relu"]
    out = [np.polynomial.chebyshev.poly2cheb(r[name]) for name in r["stages"]]
    out[-1] = out[-1] / 2
    out[-1][0] += 0.5
    return out


def diagonals(cfg: dict) -> list[int]:
    net = cfg["network"]
    c, h, w = net["channels"], net["height"], net["width"]
    return sorted({(dc * h * w + dh * w + dw) % (c * h * w) for dc in range(c) for dh in (-1, 0, 1)
                   for dw in (-1, 0, 1)})


def conv(ds, n1: int, level: int) -> list[tuple]:
    return [("mul_plain", level)] + bsgs(ds, n1, level) + [("rescale", level - 1), ("add_plain", level - 2)]


def relu(cfg: dict, level: int) -> list[tuple]:
    out: list[tuple] = []
    for k, c in enumerate(stages(cfg)):
        out += series(c, level - 4 * k)
    return out + [("mul", level - 16)]


def ops(cfg: dict, mix: dict) -> list[tuple]:
    ds, n1, top = diagonals(cfg), cfg["packing"]["n1"], cfg["L"]
    second = top - 2 - 17  # the second convolution's input level
    return (conv(ds, n1[0], top) + relu(cfg, top - 2) + conv(ds, n1[1], second)
            + [("mul_plain_rescale", second - 1), ("add", second - 2)] + relu(cfg, second - 2))
