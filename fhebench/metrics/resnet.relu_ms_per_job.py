"""Host time a job spends in the block's composite-polynomial ReLUs (four Chebyshev
series and the product, each ReLU): the union of the outermost
``fhe.resnet.relu`` spans, in ms."""

from fhebench import spans, tracing


def read(t: tracing.Trace):
    return spans.ms_per_job(t, ("fhe.resnet.relu",))
