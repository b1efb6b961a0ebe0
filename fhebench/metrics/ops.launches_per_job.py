"""Device kernels launched per job (the port's and torch's alike), from the trace."""

from fhebench import tracing


def read(t: tracing.Trace):
    n = sum(1 for k in t.kernels if t.window[0] <= k[0] < t.window[1])
    if not n or not t.jobs:
        return None
    return n / t.jobs
