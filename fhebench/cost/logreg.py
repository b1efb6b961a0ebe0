"""The operations of one ``logreg`` job, as (name, level[, k]) for ``cost.least_seconds``.

Iteration t from v at ℓ = L − 7t, for each of the batch's ciphertexts: Z⊙v
(relinearised, rescaled at ℓ) whose row sum, log2(f) rotations and adds, runs at
ℓ before the rescale; the mask (a plaintext product, rescaled at ℓ − 1) whose
copy across the row, log2(f) rotations and adds, runs at ℓ − 1; σ3 as a
degree-3 Chebyshev series from ℓ − 2 (``cost.lstm.activation``); g⊙Z at ℓ − 5.
Then the products' adds and the sum over the rows, log2(slots/f) rotations and
adds, at ℓ − 5 before the rescale; w⁺ = Δw + v, with v brought down to ℓ − 6 (a
plaintext product by one, rescaled at ℓ − 5), and v⁺ = (1 − η)·w⁺ + η·w, two
constant products rescaled at ℓ − 6 and their add at ℓ − 7.

The program rescales the sum of the g⊙Z products once, after the rotations;
the count has no product without its rescale, so it charges each product one:
an iteration's ciphertexts less one rescales at ℓ − 5 too many (one at ≤ 29
limbs an iteration at the cell: 0.34% of a job's least time).
"""

from __future__ import annotations

from fhebench.cost.lstm import activation, chebyshev


def ops(cfg: dict, mix: dict) -> list[tuple]:
    top, f, m = cfg["L"], cfg["network"]["features"], cfg["network"]["batch"]
    rows = cfg["n"] // 2 // f
    per_row, over_rows = f.bit_length() - 1, rows.bit_length() - 1
    sig = cfg["activations"]["sigmoid"]
    neg = [c * (-1) ** k for k, c in enumerate(sig["power"])]  # σ3(−x)
    out: list[tuple] = []
    for t, gamma in enumerate(cfg["schedule"]["learning_rate"]):
        lv = top - 7 * t
        for _ in range(m // rows):
            out += [("mul", lv)] + [("rotate", lv), ("add", lv)] * per_row
            out += [("mul_plain_rescale", lv - 1)] + [("rotate", lv - 1), ("add", lv - 1)] * per_row
            out += activation(chebyshev(neg, sig["bound"]) * (gamma / m), lv - 2)
            out.append(("mul", lv - 5))
        out += [("add", lv - 5)] * (m // rows - 1) + [("rotate", lv - 5), ("add", lv - 5)] * over_rows
        out += [("mul_plain_rescale", lv - 5), ("add", lv - 6)]
        out += [("mul_plain_rescale", lv - 6)] * 2 + [("add", lv - 7)]
    return out
