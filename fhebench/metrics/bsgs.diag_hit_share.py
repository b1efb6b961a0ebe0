"""The share of the window's BSGS diagonals whose plaintext the plan already
held: ``fhe.bsgs.diag_hit`` spans over those spans and the outermost
``fhe.encode`` spans, each counted inside an outermost ``fhe.bsgs`` span, in %;
no reading where the window has no ``fhe.bsgs`` span."""

from fhebench import spans, tracing


def read(t: tracing.Trace):
    bsgs = spans.outermost(t, ("fhe.bsgs",))
    if not bsgs:
        return None
    inside = lambda names: sum(1 for a, b in spans.outermost(t, names)
                               if any(g0 <= a and b <= g1 for g0, g1 in bsgs))
    hits, encodes = inside(("fhe.bsgs.diag_hit",)), inside(("fhe.encode",))
    if not hits + encodes:
        return None
    return 100.0 * hits / (hits + encodes)
