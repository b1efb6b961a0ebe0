"""Host time a job spends in the block's convolutions (each one's lift, BSGS matvec,
second rescale and bias): the union of the outermost
``fhe.resnet.conv`` spans, in ms."""

from fhebench import spans, tracing


def read(t: tracing.Trace):
    return spans.ms_per_job(t, ("fhe.resnet.conv",))
