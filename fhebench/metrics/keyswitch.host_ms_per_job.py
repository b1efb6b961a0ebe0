"""Host time a job spends inside key-switches (relinearisations and rotations, from
ModUp through the automorphism), the host's side of what ``kernels_roofline``
times on the device: the union of the outermost ``fhe.keyswitch`` spans, in ms."""

from fhebench import spans, tracing


def read(t: tracing.Trace):
    return spans.ms_per_job(t, spans.KEYSWITCH)
