"""The operations of one ``lola`` job, as (name, level[, k]) for ``cost.least_seconds``.

Worked out from the network's shapes and the packing's rules alone (see
``fhebench/jobs/lola_packing.py`` for the layout): the convolution's kernel²
diagonals d = (s·(dy mod s) + dx mod s)·w² + w·⌊dy/s⌋ + ⌊dx/s⌋; a dense layer's
R diagonals 0..R−1 (R its rows padded to a power of two) and log2(period/R)
folds.  A BSGS layer over diagonals D with n1 baby steps at level ℓ: the baby
rotations {d mod n1} ≠ 0 of the input (one hoisted group when there are two
or more), |D| plaintext products, the adds within each giant group, one
rotation per non-zero giant step, the adds of the giant sums and one rescale;
then each fold (a rotation and an add) and the bias (a plaintext add) at
ℓ − 1, and the square there, but after the last layer.
"""

from __future__ import annotations


def bsgs(ds, n1: int, level: int) -> list[tuple]:
    out: list[tuple] = []
    babies = {d % n1 for d in ds} - {0}
    groups: dict[int, int] = {}
    for d in ds:
        groups[d // n1] = groups.get(d // n1, 0) + 1
    if len(babies) >= 2:
        out.append(("rotate_group", level, len(babies)))
    else:
        out += [("rotate", level)] * len(babies)
    out += [("mul_plain", level)] * len(ds)
    out += [("add", level)] * sum(c - 1 for c in groups.values())
    out += [("rotate", level)] * sum(1 for g in groups if g)
    out += [("add", level)] * (len(groups) - 1)
    out.append(("rescale", level))
    return out


def ops(cfg: dict, mix: dict) -> list[tuple]:
    net, pack = cfg["network"], cfg["packing"]
    s, k, img = net["conv"]["stride"], net["conv"]["kernel"], net["image"]
    w = -(-img // s)
    conv = sorted({((dy % s) * s + dx % s) * w * w + w * (dy // s) + dx // s for dy in range(k) for dx in range(k)})
    layers = [(conv, pack["conv_n1"], 0)]
    period = cfg["n"] // 2
    for rows, n1 in zip(net["dense"], pack["dense_n1"]):
        R = 1 << (rows - 1).bit_length()
        layers.append((range(R), n1, (period // R).bit_length() - 1))
        period = R
    out: list[tuple] = []
    level = cfg["L"]
    for j, (ds, n1, folds) in enumerate(layers):
        out += bsgs(ds, n1, level)
        level -= 1
        out += [("rotate", level), ("add", level)] * folds
        out.append(("add_plain", level))
        if j + 1 < len(layers):
            out.append(("square", level))
            level -= 1
    return out
