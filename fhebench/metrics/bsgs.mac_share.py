"""The share of the window's BSGS matvecs whose diagonal products and sums ran
as one ``bsgs_mac`` launch: outermost ``fhe.bsgs`` spans that hold an
``fhe.bsgs.mac`` span, over all outermost ``fhe.bsgs`` spans, in %.  No reading
where the window has no ``fhe.bsgs`` span, or no ``fhe.bsgs.mac`` span at all
(a program that runs the products one launch each)."""

from fhebench import spans, tracing


def read(t: tracing.Trace):
    bsgs = spans.outermost(t, ("fhe.bsgs",))
    macs = spans.outermost(t, ("fhe.bsgs.mac",))
    if not bsgs or not macs:
        return None
    held = sum(1 for g0, g1 in bsgs if any(g0 <= a and b <= g1 for a, b in macs))
    return 100.0 * held / len(bsgs)
