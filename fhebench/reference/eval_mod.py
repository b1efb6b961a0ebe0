"""Plain reference of ``eval_mod``: the Chebyshev series of EvalMod's sine at the
normalised input, and the level and scale the answer must carry.

The series interpolates (q0/Δ)·sin(2π(K+½)t)/(2π) on [-1, 1] at the configured
degree (NumPy's Chebyshev interpolation); the input slot x enters as
t = input_norm·x.  The basis T_j = 2·T_a·T_b − T_{b−a}, a = ⌊j/2⌋, is one
level below the lower of T_a and T_b, T_1 one level below the input; the sum
lands one level below the lowest T_j, at scale Δ exactly.
"""

from __future__ import annotations

import numpy as np

from . import ckks


def coefficients(cfg: dict) -> np.ndarray:
    q, _ = ckks.moduli(cfg["L"], cfg["dnum"])
    em = cfg["eval_mod"]
    amp = float(q[0]) / float(2 ** cfg["scale_bits"])
    c = 2.0 * np.pi * (em["K"] + 0.5)
    f = lambda t: amp * np.sin(c * t) / (2.0 * np.pi)
    return np.polynomial.chebyshev.Chebyshev.interpolate(f, em["degree"], domain=[-1, 1]).coef


def basis_levels(top: int, degree: int) -> dict[int, int]:
    lv = {1: top - 1}
    for j in range(2, degree + 1):
        a = j // 2
        lv[j] = min(lv[a], lv[j - a]) - 1
    return lv


def expected(cfg: dict, mix: dict, inputs: dict) -> tuple[int, float, list[np.ndarray]]:
    coeffs = coefficients(cfg)
    level = min(basis_levels(cfg["L"], cfg["eval_mod"]["degree"]).values()) - 1
    answers = [np.polynomial.chebyshev.chebval(mix["input_norm"] * np.asarray(z, np.float64), coeffs)
               for z in inputs["pool"]]
    return level, float(2 ** cfg["scale_bits"]), answers
