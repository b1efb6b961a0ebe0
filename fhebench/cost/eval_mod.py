"""The operations of one ``eval_mod`` job, as (name, level[, k]) for ``cost.least_seconds``.

The normalisation x·norm at the top level (a plaintext product and rescale);
each T_j, j = 2..degree: the product T_a·T_b (relinearised, rescaled), its
doubling, then − 1 (even j) or − T_1 brought down to the product's level (odd
j: a negation, a plaintext product by one and a rescale); then one plaintext
product and rescale for every non-zero coefficient, each brought down to the
sum's level as needed, and the adds of the sum.
"""

from __future__ import annotations

from fhebench.reference import eval_mod as ref

NONZERO = 1e-14  # coefficients below this are left out of the sum


def ops(cfg: dict, mix: dict) -> list[tuple]:
    top, degree = cfg["L"], cfg["eval_mod"]["degree"]
    lv = ref.basis_levels(top, degree)
    out: list[tuple] = [("mul_plain_rescale", top)]
    for j in range(2, degree + 1):
        a = j // 2
        here = min(lv[a], lv[j - a])
        out += [("mul", here), ("add", here - 1)]
        if a == j - a:
            out.append(("add_plain", here - 1))
        else:
            out += [("negate", lv[j - 2 * a]), ("mul_plain_rescale", here), ("add", here - 1)]
    star = min(lv.values()) - 1
    c = ref.coefficients(cfg)
    terms = [i for i in range(1, len(c)) if abs(c[i]) >= NONZERO]
    for i in terms:
        out.append(("mul_plain_rescale", lv[i]))
        if lv[i] - 1 > star:
            out.append(("mul_plain_rescale", star + 1))
    out += [("add", star)] * (len(terms) - 1)
    if abs(c[0]) >= NONZERO:
        out.append(("add_plain", star))
    return out

