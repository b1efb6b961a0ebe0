"""Host time a job spends in the training period's polynomial sigmoid (σ3 of
each ciphertext's replicated z·v, each iteration): the union of the outermost
``fhe.logreg.sigmoid`` spans, in ms."""

from fhebench import spans, tracing


def read(t: tracing.Trace):
    return spans.ms_per_job(t, ("fhe.logreg.sigmoid",))
