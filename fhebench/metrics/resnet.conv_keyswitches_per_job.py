"""Key-switches per job inside the block's convolutions: the outermost
``fhe.keyswitch`` spans that lie inside an outermost ``fhe.resnet.conv`` span,
over the jobs (a hoisted baby group is one span, each giant rotation one)."""

from fhebench import spans, tracing


def read(t: tracing.Trace):
    convs = spans.outermost(t, ("fhe.resnet.conv",))
    if not convs or not t.jobs:
        return None
    switches = spans.outermost(t, spans.KEYSWITCH)
    return sum(1 for a, b in switches if any(c0 <= a and b <= c1 for c0, c1 in convs)) / t.jobs
