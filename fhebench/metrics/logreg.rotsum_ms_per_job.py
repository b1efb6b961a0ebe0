"""Host time a job spends in the training period's rotate-and-sum chains (the
row sums, the copies across each row and the sum over the rows): the union of
the outermost ``fhe.logreg.rotsum`` spans, in ms."""

from fhebench import spans, tracing


def read(t: tracing.Trace):
    return spans.ms_per_job(t, ("fhe.logreg.rotsum",))
