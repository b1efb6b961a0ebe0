"""Encrypted logistic-regression training (HELR; FLASH-FHE's deep ``logreg`` workload, §6.1).

Han, Hong, Cheon and Park, "Logistic Regression on Homomorphic Encrypted Data
at Scale" (AAAI 2019): the training data and the model are both encrypted, and
each iteration is one step of Nesterov's accelerated gradient on the
log-likelihood of a mini-batch of m samples z_i = y_i·x_i (the bias feature is
one of the features):

    w⁺ = v + (γ_t/m)·Σ_i σ3(−z_i·v)·z_i,    v⁺ = (1 − η_t)·w⁺ + η_t·w,

with σ3 the degree-3 least-squares fit of the logistic function on [−8, 8]
(``polyeval.SIGMOID3``, the LSTM's).

Packing: a ciphertext holds slots/f rows of the batch, f features each,
row-major (``pack_batch``); w and v are replicated with period f
(``linear.pack``).  One iteration, for each ciphertext Z of the batch:

  * a = Z⊙v (a ciphertext product), summed over each row by the rotations
    1, 2, …, f/2 (``fhe.logreg.rotsum``): slot r·f holds z_r·v;
  * a mask keeps slot r·f of each row and divides it by 8, σ3's interval;
  * the rotations −1, −2, …, −f/2 copy it across the row (a second rotsum);
  * g = (γ_t/m)·σ3(−a) as a degree-3 Chebyshev series on [−1, 1], the factor
    and the sign folded into its coefficients (``fhe.logreg.sigmoid``);
  * g⊙Z (a ciphertext product);

then the products of every ciphertext are added and summed over the rows by
the rotations f, 2f, …, slots/2, which leaves Σ_i g_i·z_i replicated with
period f; w⁺ and v⁺ follow with real constants (``fhe.logreg.update``).  Each
rotation is a standard one: each depends on the last, so none can share a
ModUp.  The batch's ciphertexts run their chains in lockstep, each step on
every ciphertext in turn, so each step's Galois key, rebuilt at every level by
``keyswitch.hoisted_ksk``, serves all of them.  Each chain runs on its product
before the rescale, at a scale near Δ² = 2^60: a key-switch adds noise of a
fixed size in the ring, which against Δ = 2^30 is ≈ 0.1 of a slot on the
``logreg`` chain at N = 2^16 and against Δ² 2^30 times smaller.  (The ModUp's
fast basis conversion hands each digit to the key's error as a non-negative
polynomial of mean ≈ (α/2)·D_j, not one centred below D_j/2: at α = 17 that is
≈ 30 times the noise of an exact, centred decomposition.)

Levels from v at ℓ: the product ℓ − 1, the mask ℓ − 2, σ3 ℓ − 5, g⊙Z and w⁺
ℓ − 6 at scale Δ²/q_{ℓ−5}, v⁺ ℓ − 7 at Δ.  From the top L = 33 four
iterations fit: w_4 at level 6, v_4 at 5.  Run them through a context:
``ctx.logreg_step(plan, zs, w, v)``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.obs.spans import span

from . import ops, polyeval
from .params import CkksParams

BOUND = 8.0  # σ3's fit interval [−8, 8]; the mask divides a by it


def pack_batch(z: np.ndarray, slots: int) -> list[np.ndarray]:
    """The batch (m, f) as slot vectors of slots/f rows each, row-major."""
    z = np.asarray(z, np.float64)
    rows = slots // z.shape[1]
    return [z[i : i + rows].reshape(-1) for i in range(0, z.shape[0], rows)]


def _doublings(first: int, last: int) -> tuple[int, ...]:
    """first, 2·first, 4·first, … up to last."""
    out, r = [], first
    while r <= last:
        out.append(r)
        r *= 2
    return tuple(out)


@dataclasses.dataclass
class LogregPlan:
    """One period of training: the batch's shape, each iteration's momentum η_t,
    and its σ3 as Chebyshev coefficients with the learning rate γ_t, 1/m and the
    sign folded in (t ↦ (γ_t/m)·σ3(−8t) on [−1, 1])."""

    slots: int
    features: int
    batch: int
    momenta: tuple[float, ...]
    sigmoid_coeffs: tuple[np.ndarray, ...]
    _masks: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def iterations(self) -> int:
        return len(self.sigmoid_coeffs)

    @property
    def feature_steps(self) -> tuple[int, ...]:
        """The rotations that sum a row: 1, 2, …, f/2."""
        return _doublings(1, self.features // 2)

    @property
    def row_steps(self) -> tuple[int, ...]:
        """The rotations that sum the rows: f, 2f, …, slots/2."""
        return _doublings(self.features, self.slots // 2)

    def rotations(self) -> frozenset[int]:
        """Slot rotations whose Galois keys the iterations need (−r rotates right)."""
        return frozenset(self.feature_steps) | {-r for r in self.feature_steps} | frozenset(self.row_steps)

    def mask_plaintext(self, ctx, level: int, scale: float) -> ops.Plaintext:
        """1/8 in slot r·f of every row, 0 elsewhere, encoded once at the level and
        scale where the first iteration meets it."""
        key = (level, scale, ctx.device)
        if key not in self._masks:
            mask = np.zeros(self.slots)
            mask[:: self.features] = 1.0 / BOUND
            self._masks[key] = ops._encode(ctx, mask, level, scale)
        return self._masks[key]


def build_plan(params: CkksParams, features: int, batch: int, learning_rates, momenta) -> LogregPlan:
    """The plan of one period: f features (a power of two below the slot count),
    a batch of m rows filling whole ciphertexts, and one (γ_t, η_t) an iteration."""
    slots = params.slots
    if features & (features - 1) or not 1 < features < slots or batch % (slots // features):
        raise ValueError(f"{features} features and a batch of {batch} do not pack into ciphertexts of {slots} slots")
    if len(learning_rates) != len(momenta):
        raise ValueError("one learning rate and one momentum an iteration")
    neg = [c * (-1) ** k for k, c in enumerate(polyeval.SIGMOID3)]  # σ3(−x)
    return LogregPlan(
        slots=slots, features=features, batch=batch, momenta=tuple(float(e) for e in momenta),
        sigmoid_coeffs=tuple(polyeval.chebyshev_on_unit(neg, BOUND) * (g / batch) for g in learning_rates),
    )


def _rotsum(ctx, cts: list[ops.Ciphertext], steps) -> list[ops.Ciphertext]:
    """ct + rot(ct, r) for each r in turn, for each ct: chains of standard
    rotations in lockstep, each step on every ciphertext before the next step."""
    keys = ctx.require_keys()
    with span("fhe.logreg.rotsum"):
        for r in steps:
            cts = [ops._add(ctx, ct, ops._rotate_standard(ctx, ct, r, keys)) for ct in cts]
        return cts


def _gradient_terms(ctx, plan: LogregPlan, t: int, zs, v: ops.Ciphertext) -> list[ops.Ciphertext]:
    """g⊙Z for each ciphertext Z of the batch, g = (γ_t/m)·σ3(−Z·v) replicated
    over each row; the products are left unrescaled, for the row sum to follow."""
    rlk = ctx.require_keys().rlk
    scale = ctx.params.scale
    prods = [ops._mul(ctx, z, v, rlk, rescale_after=False) for z in zs]
    a = [ops._rescale(ctx, x) for x in _rotsum(ctx, prods, plan.feature_steps)]
    enc_scale = scale * float(ctx.params.q_primes[a[0].level]) / a[0].scale  # lands at Δ, as mul_const_exact
    mask = plan.mask_plaintext(ctx, a[0].level, enc_scale)
    a = [ops._mul_plain(ctx, x, mask, rescale_after=False) for x in a]
    a = [ops._rescale(ctx, x) for x in _rotsum(ctx, a, [-r for r in plan.feature_steps])]
    coeffs = plan.sigmoid_coeffs[t]
    terms = []
    for x, z in zip(a, zs):
        with span("fhe.logreg.sigmoid"):
            basis = polyeval.ChebyshevBasis(ctx, ops.Ciphertext(x.c0, x.c1, x.level, scale), len(coeffs) - 1)
            g = polyeval._eval_chebyshev(ctx, basis, coeffs)
        terms.append(ops._mul(ctx, g, z, rlk, rescale_after=False))
    return terms


def _logreg_step(ctx, plan: LogregPlan, zs, w: ops.Ciphertext,
                 v: ops.Ciphertext) -> tuple[ops.Ciphertext, ops.Ciphertext]:
    """(w_k, v_k) after the plan's k iterations from the batch's ciphertexts zs
    (``pack_batch``) and the model w, v (``linear.pack``)."""
    if len(zs) * (plan.slots // plan.features) != plan.batch:
        raise ValueError(f"{len(zs)} ciphertexts hold no batch of {plan.batch}")
    scale = ctx.params.scale
    for t in range(plan.iterations):
        with span("fhe.logreg.iter"):
            delta = functools.reduce(lambda a, b: ops._add(ctx, a, b), _gradient_terms(ctx, plan, t, zs, v))
            delta = ops._rescale(ctx, _rotsum(ctx, [delta], plan.row_steps)[0])
            with span("fhe.logreg.update"):
                w_next = polyeval._add_any(ctx, delta, v)
                eta = plan.momenta[t]
                v = ops._add(ctx, ops._mul_const_exact(ctx, w_next, 1.0 - eta, scale),
                             ops._mul_const_exact(ctx, ops.level_drop(w, w_next.level), eta, scale))
                w = w_next
    return w, v
