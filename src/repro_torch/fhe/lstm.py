"""One step of an encrypted LSTM cell (FLASH-FHE's deep ``lstm`` workload, §6.1).

The standard LSTM cell with a forget gate, its weights unencrypted: each gate
g ∈ (f, i, o, c̃) has the pre-activation a_g = W_g·x + U_g·h + b_g; then

    f, i, o = σ3(a),  c̃ = tanh3(a_c̃),  c_t = f⊙c + i⊙c̃,  h_t = o⊙tanh3(c_t),

with the degree-3 least-squares fits σ3 on [−8, 8] and tanh3 = 2·σ3(2x) − 1 on
[−4, 4].  x, h and c are vectors of width p replicated with period p over the
slots (``pack``), so a p×p matrix is p period-p diagonals and each matvec is one
BSGS transform (``linear``).  Each gate's 1/8 or 1/4 normalisation is folded into
its rows of W, U and b, so the activations are Chebyshev series on [−1, 1]
(``polyeval``); c_t/4 costs nothing, being a relabelling of the scale.

Levels from the top L: the gates at L − 1, the activations at L − 4, c_t at
L − 5, tanh3(c_t) at L − 8, h_t at L − 9, at scale Δ²/q_{L−8}.  Run a step
through a context: ``ctx.lstm_step(plan, x, h, c)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.obs.spans import span

from . import linear, ops, polyeval
from .params import CkksParams

TANH3 = (0.0, 0.60048, 0.0, -0.025488)  # 2·σ3(2x) − 1, least squares on [−4, 4]
BOUNDS = (8.0, 8.0, 8.0, 4.0)  # the fit interval [−B, B] of each gate, in the order f, i, o, c̃
CELL_BOUND = 4.0  # tanh3 of c_t, on [−4, 4]
pack = linear.pack  # the layout of x, h and c


def _diagonals(m: np.ndarray, slots: int) -> dict[int, np.ndarray]:
    """The p period-p diagonals of a p×p matrix over the slots: slot i of
    diagonal d holds m[i mod p, (i + d) mod p]."""
    p = m.shape[0]
    rows = np.arange(p)
    return {d: linear.pack(m[rows, (rows + d) % p], slots) for d in range(p)}


@dataclasses.dataclass
class LstmPlan:
    """The step's BSGS plans (W_g and U_g over their gate's bound), the biases
    b_g over the bound, and the activations' Chebyshev coefficients on [−1, 1]."""

    w: tuple[linear.BsgsPlan, ...]
    u: tuple[linear.BsgsPlan, ...]
    bias: tuple[np.ndarray, ...]
    gate_coeffs: tuple[np.ndarray, ...]
    cell_coeffs: np.ndarray
    _biases: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    def rotations(self) -> frozenset[int]:
        """Slot rotations whose Galois keys the step needs."""
        return frozenset().union(*(plan.rotations() for plan in self.w + self.u))

    def bias_plaintext(self, ctx, g: int, level: int, scale: float) -> ops.Plaintext:
        """b_g encoded once at the level and scale where the first step meets it."""
        key = (g, level, scale, ctx.device)
        if key not in self._biases:
            self._biases[key] = ops._encode(ctx, pack(self.bias[g], ctx.params.slots), level, scale)
        return self._biases[key]


def build_plan(W: np.ndarray, U: np.ndarray, b: np.ndarray, params: CkksParams, n1: int = 8) -> LstmPlan:
    """The plan of a step from W (4, p, p), U (4, p, p) and b (4, p), gates in
    the order f, i, o, c̃; p must divide the slot count."""
    W, U, b = (np.asarray(a, np.float64) for a in (W, U, b))
    p = W.shape[-1]
    if not (W.shape == U.shape == (4, p, p) and b.shape == (4, p) and params.slots % p == 0):
        raise ValueError(f"W {W.shape}, U {U.shape} and b {b.shape} are no step of width p dividing {params.slots}")
    plan = lambda m: linear.plan_diags(_diagonals(m, params.slots), params, params.L, hoisting=True, n1=n1)
    return LstmPlan(
        w=tuple(plan(W[g] / BOUNDS[g]) for g in range(4)),
        u=tuple(plan(U[g] / BOUNDS[g]) for g in range(4)),
        bias=tuple(b[g] / BOUNDS[g] for g in range(4)),
        gate_coeffs=tuple(polyeval.chebyshev_on_unit(polyeval.SIGMOID3 if g < 3 else TANH3, BOUNDS[g])
                          for g in range(4)),
        cell_coeffs=polyeval.chebyshev_on_unit(TANH3, CELL_BOUND),
    )


def _activation(ctx, a: ops.Ciphertext, coeffs: np.ndarray) -> ops.Ciphertext:
    """A degree-3 Chebyshev series: three levels down, at scale Δ exactly."""
    with span("fhe.lstm.act"):
        return polyeval._eval_chebyshev(ctx, polyeval.ChebyshevBasis(ctx, a, len(coeffs) - 1), coeffs)


def _lstm_step(ctx, plan: LstmPlan, x: ops.Ciphertext, h: ops.Ciphertext,
               c: ops.Ciphertext) -> tuple[ops.Ciphertext, ops.Ciphertext]:
    """(h_t, c_t) of one step from x, h_{t−1} and c_{t−1}, each packed by ``pack``."""
    rlk = ctx.require_keys().rlk
    pre = []
    with span("fhe.lstm.gates"):
        for g in range(4):
            a = ops._add(ctx, linear._apply_bsgs(ctx, x, plan.w[g]), linear._apply_bsgs(ctx, h, plan.u[g]))
            pre.append(ops._add_plain(ctx, a, plan.bias_plaintext(ctx, g, a.level, a.scale)))
    f, i, o, cand = (_activation(ctx, a, coeffs) for a, coeffs in zip(pre, plan.gate_coeffs))
    with span("fhe.lstm.cell"):
        c_t = polyeval._add_any(ctx, ops._mul(ctx, f, c, rlk), ops._mul(ctx, i, cand, rlk))
    quarter = ops.Ciphertext(c_t.c0, c_t.c1, c_t.level, c_t.scale * CELL_BOUND)  # c_t / 4, exactly
    tanh_c = _activation(ctx, quarter, plan.cell_coeffs)
    with span("fhe.lstm.cell"):
        h_t = ops._mul(ctx, o, tanh_c, rlk)
    return h_t, c_t
