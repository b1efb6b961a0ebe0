"""Plaintexts encoded on the host per job: the outermost ``fhe.encode`` and
``fhe.encode_const`` spans that start in the window, over the jobs."""

from fhebench import spans, tracing


def read(t: tracing.Trace):
    n = len(spans.outermost(t, spans.ENCODES))
    if not n or not t.jobs:
        return None
    return n / t.jobs
