"""Where the port's dispatch counts leave the reference's on a BSGS matvec.

The reference multiplies each of a matvec's D diagonals into its baby rotation
(one ``mulmod`` per component) and sums each of its G giant groups (one
``addmod`` per component for every term after the group's first).  The port
computes all of those products and sums in one ``bsgs_mac`` launch, and still
records the reference's ``PMULT``/``PADD`` instructions for each diagonal in
its order, so its ``fhe.trace`` stream is the reference's and its dispatch
counts are the reference's less 2D ``mulmod`` and 2(D − G) ``addmod``, plus
one ``bsgsmac``, for each matvec (``ROADMAP.md`` Queue 3).
"""

from __future__ import annotations


def diagonals_and_giants(plan) -> tuple[int, int]:
    """(D, G) of a plan of either package."""
    return len(plan.diags), len({d // plan.n1 for d in plan.diags})


def port_counts(counts: dict, plans) -> dict:
    """The reference's dispatch ``counts`` of a block that applied each of
    ``plans`` once, as the port's: less the products and sums of every
    matvec, plus one ``bsgsmac`` a matvec."""
    out = dict(counts)
    for plan in plans:
        d, g = diagonals_and_giants(plan)
        out["mulmod"] = out.get("mulmod", 0) - 2 * d
        out["addmod"] = out.get("addmod", 0) - 2 * (d - g)
        out["bsgsmac"] = out.get("bsgsmac", 0) + 1
    assert all(v >= 0 for v in out.values()), out
    return {k: v for k, v in out.items() if v}
