"""The share of the window's real-constant encodes built on the card: outermost
``fhe.encode_const`` spans that hold an ``fhe.encode.const_column`` span (the
residue column made where it is used, with no host array, copy or NTT), in %
of all outermost ``fhe.encode_const`` spans in the window."""

from fhebench import spans, tracing


def read(t: tracing.Trace):
    consts = spans.outermost(t, ("fhe.encode_const",))
    if not consts:
        return None
    columns = [(ts, ts + dur) for ts, dur, name in t.spans if name == "fhe.encode.const_column"]
    on_card = sum(1 for a, b in consts if any(a <= c0 and c1 <= b for c0, c1 in columns))
    return 100.0 * on_card / len(consts)
