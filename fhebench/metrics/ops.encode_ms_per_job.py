"""Host time a job spends encoding plaintexts (diagonals and constants): the union of
the outermost ``fhe.encode`` and ``fhe.encode_const`` spans in the window, in ms."""

from fhebench import spans, tracing


def read(t: tracing.Trace):
    return spans.ms_per_job(t, spans.ENCODES)
