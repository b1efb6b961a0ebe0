"""Plain reference of ``lstm``: one step of the LSTM cell with a forget gate, in
NumPy float64, with the configuration's polynomial activations.

Gates in the order (f, i, o, c̃): a = W·x + U·h + b; f, i, o = σ3(a); c̃ =
tanh3(a_c̃); c_t = f⊙c + i⊙c̃; h_t = o⊙tanh3(c_t).  σ3 and tanh3 are the
configuration's ``activations`` (power coefficients and the interval [−B, B]
of each fit); every argument must lie in its interval, and ``step`` asserts
it.  A message is (x, h, c); the answer's slot i holds h_t[i mod hidden].

Level and scale follow CKKS's bookkeeping from the reference's own prime chain
for inputs at the top level and scale Δ: a matvec multiplies by diagonals at
Δ and rescales; a degree-3 Chebyshev activation takes three levels and lands at
Δ; a gate product of two values at Δ rescales once; c_t/4 relabels the scale.
"""

from __future__ import annotations

import numpy as np

from . import ckks


def _poly(power, x: np.ndarray) -> np.ndarray:
    return sum(c * x**k for k, c in enumerate(power))


def step(cfg: dict, weights: dict, x, h, c) -> tuple[np.ndarray, np.ndarray]:
    """(h_t, c_t) of one step."""
    sig, tanh = cfg["activations"]["sigmoid"], cfg["activations"]["tanh"]
    a = weights["W"] @ np.asarray(x) + weights["U"] @ np.asarray(h) + weights["b"]
    assert np.abs(a[:3]).max() <= sig["bound"] and np.abs(a[3]).max() <= tanh["bound"], \
        "a pre-activation leaves its fit"
    f, i, o = _poly(sig["power"], a[:3])
    c_t = f * c + i * _poly(tanh["power"], a[3])
    assert np.abs(c_t).max() <= tanh["bound"], "c_t leaves tanh3's fit"
    return o * _poly(tanh["power"], c_t), c_t


def bookkeeping(cfg: dict) -> tuple[int, float]:
    """(level, scale) of h_t."""
    q, _ = ckks.moduli(cfg["L"], cfg["dnum"])
    delta = float(2 ** cfg["scale_bits"])
    act = cfg["L"] - 1 - 3
    tanh = act - 1 - 3
    return tanh - 1, delta * delta / float(q[tanh])


def expected(cfg: dict, mix: dict, inputs: dict) -> tuple[int, float, list[np.ndarray]]:
    """(level, scale, [slots of h_t for each message of the pool])."""
    level, scale = bookkeeping(cfg)
    copies = cfg["n"] // 2 // cfg["network"]["hidden"]
    answers = [np.tile(step(cfg, inputs["weights"], *msg)[0], copies) for msg in inputs["pool"]]
    return level, scale, answers
