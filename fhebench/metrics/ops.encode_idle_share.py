"""The share of the window's device-idle time that lies under an encode span: idle
stretches intersected with the outermost ``fhe.encode``/``fhe.encode_const`` spans,
so a gap that straddles several spans is split between them."""

from fhebench import spans, tracing


def read(t: tracing.Trace):
    if not (t.kernels or t.copies):
        return None
    encodes = spans.outermost(t, spans.ENCODES)
    idle = [(start, start + length) for start, length in tracing.idle_gaps(t)]
    total = sum(b - a for a, b in idle)
    if not encodes or total <= 0:
        return None
    return 100.0 * spans.overlap_us(idle, encodes) / total
