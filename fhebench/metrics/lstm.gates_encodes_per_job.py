"""Plaintexts encoded on the host per job inside the LSTM step's gates: the
outermost ``fhe.encode`` spans that lie inside an outermost ``fhe.lstm.gates``
span, over the jobs (the diagonals; the biases are encoded once, before the
window)."""

from fhebench import spans, tracing


def read(t: tracing.Trace):
    gates = spans.outermost(t, ("fhe.lstm.gates",))
    if not gates or not t.jobs:
        return None
    encodes = spans.outermost(t, ("fhe.encode",))
    return sum(1 for a, b in encodes if any(g0 <= a and b <= g1 for g0, g1 in gates)) / t.jobs
