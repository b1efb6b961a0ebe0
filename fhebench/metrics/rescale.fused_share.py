"""The share of the window's CKKS rescales that ran both components as one
``fused_rescale`` launch: outermost ``fhe.rescale`` spans that hold an
``fhe.rescale.fused`` span, over all outermost ``fhe.rescale`` spans, in %.  No
reading where the window has no ``fhe.rescale`` span, or no
``fhe.rescale.fused`` span at all (a program that rescales one component at a
time)."""

from fhebench import spans, tracing


def read(t: tracing.Trace):
    rescales = spans.outermost(t, ("fhe.rescale",))
    fused = spans.outermost(t, ("fhe.rescale.fused",))
    if not rescales or not fused:
        return None
    held = sum(1 for r0, r1 in rescales if any(r0 <= a and b <= r1 for a, b in fused))
    return 100.0 * held / len(rescales)
