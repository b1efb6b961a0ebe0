"""The operations of one ``lstm`` job, as (name, level[, k]) for ``cost.least_seconds``.

At the top level L, each of the 4 gates is two BSGS matvecs over the ``hidden``
period-``hidden`` diagonals with the configuration's n1 (``cost.lola.bsgs``),
their add and the bias (a plaintext add) at L − 1.  Each activation is a
degree-3 Chebyshev series on the normalised interval, from level ℓ: T_2 =
2·T_1² − 1 (a square, its doubling, a plaintext add), T_3 = 2·T_1·T_2 − T_1 (a
product at ℓ − 1, its doubling, −T_1 brought down to ℓ − 2: a negation, a
plaintext product by one and a rescale, and the add); then a plaintext product
and rescale for every non-zero coefficient, each brought down to ℓ − 3 as needed,
the adds of the sum and c_0 where it is not zero.  The cell: f·c and i·c̃ at
L − 4 and their add; tanh3 of c_t/4 from L − 5 (the quarter is a relabelling of
the scale); h_t = o·tanh3(c_t) at L − 8.
"""

from __future__ import annotations

import numpy as np

from fhebench.cost.lola import bsgs

NONZERO = 1e-14  # coefficients below this are left out of the sum


def chebyshev(power, bound: float) -> np.ndarray:
    """Coefficients of t ↦ p(bound·t) in the Chebyshev basis, p in the power basis."""
    return np.polynomial.chebyshev.poly2cheb([c * bound**k for k, c in enumerate(power)])


def activation(c: np.ndarray, level: int) -> list[tuple]:
    assert len(c) == 4, "a degree-3 series"
    lv, star = {1: level, 2: level - 1, 3: level - 2}, level - 3
    out = [("square", level), ("add", level - 1), ("add_plain", level - 1),
           ("mul", level - 1), ("add", level - 2), ("negate", level), ("mul_plain_rescale", level - 1),
           ("add", level - 2)]
    terms = [i for i in (1, 2, 3) if abs(c[i]) >= NONZERO]
    for i in terms:
        out.append(("mul_plain_rescale", lv[i]))
        if lv[i] - 1 > star:
            out.append(("mul_plain_rescale", star + 1))
    out += [("add", star)] * (len(terms) - 1)
    if abs(c[0]) >= NONZERO:
        out.append(("add_plain", star))
    return out


def ops(cfg: dict, mix: dict) -> list[tuple]:
    top, width, n1 = cfg["L"], cfg["network"]["hidden"], cfg["packing"]["n1"]
    sig, tanh = cfg["activations"]["sigmoid"], cfg["activations"]["tanh"]
    gates = [chebyshev(sig["power"], sig["bound"])] * 3 + [chebyshev(tanh["power"], tanh["bound"])]
    out: list[tuple] = []
    for _ in gates:
        out += bsgs(range(width), n1, top) * 2
        out += [("add", top - 1), ("add_plain", top - 1)]
    for c in gates:
        out += activation(c, top - 1)
    cell = top - 4
    out += [("mul", cell), ("mul", cell), ("add", cell - 1)]
    out += activation(chebyshev(tanh["power"], tanh["bound"]), cell - 1)
    out.append(("mul", cell - 4))
    return out
