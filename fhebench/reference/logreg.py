"""Plain reference of ``logreg``: one period of HELR training (Nesterov's
accelerated gradient on a mini-batch's log-likelihood) in NumPy float64, with
the configuration's polynomial sigmoid.

A message is the batch z (m, f), z_i = y_i·x_i; the model starts at w = v = w_0,
the configuration's weight ``w0``.  Each iteration t, with the configuration's
learning rate γ_t and momentum η_t:

    w⁺ = v + (γ_t/m)·Σ_i σ3(−z_i·v)·z_i,    v⁺ = (1 − η_t)·w⁺ + η_t·w.

σ3 is the configuration's ``activations.sigmoid`` (power coefficients and its
interval [−B, B]); every z_i·v must lie in the interval, and ``train`` asserts
it.  The answer's slot i holds w_k[i mod f].  Departures from HELR: one batch
serves the whole period, and no bootstrap follows it.

Level and scale follow CKKS's bookkeeping from the reference's own prime chain
for inputs at the top level and scale Δ: an iteration from v at ℓ leaves w⁺ at
ℓ − 6, at scale Δ²/q_{ℓ−5} (g at Δ times Z at Δ, rescaled), and v⁺ at ℓ − 7
at Δ.
"""

from __future__ import annotations

import numpy as np

from . import ckks


def _poly(power, x: np.ndarray) -> np.ndarray:
    return sum(c * x**k for k, c in enumerate(power))


def train(cfg: dict, w0, z) -> tuple[np.ndarray, np.ndarray]:
    """(w_k, v_k) of one period."""
    sig, sched = cfg["activations"]["sigmoid"], cfg["schedule"]
    z = np.asarray(z, np.float64)
    w = v = np.asarray(w0, np.float64)
    for gamma, eta in zip(sched["learning_rate"], sched["momentum"], strict=True):
        a = z @ v
        assert np.abs(a).max() <= sig["bound"], "an argument z·v leaves σ3's fit"
        w_next = v + gamma / z.shape[0] * (_poly(sig["power"], -a) @ z)
        v = (1 - eta) * w_next + eta * w
        w = w_next
    return w, v


def bookkeeping(cfg: dict) -> tuple[int, float]:
    """(level, scale) of w_k."""
    q, _ = ckks.moduli(cfg["L"], cfg["dnum"])
    delta = float(2 ** cfg["scale_bits"])
    last = cfg["L"] - 7 * (cfg["iterations"] - 1)  # v's level at the last iteration
    return last - 6, delta * delta / float(q[last - 5])


def expected(cfg: dict, mix: dict, inputs: dict) -> tuple[int, float, list[np.ndarray]]:
    """(level, scale, [slots of w_k for each message of the pool])."""
    level, scale = bookkeeping(cfg)
    copies = cfg["n"] // 2 // cfg["network"]["features"]
    w0 = inputs["weights"]["w0"]
    return level, scale, [np.tile(train(cfg, w0, z)[0], copies) for z in inputs["pool"]]
