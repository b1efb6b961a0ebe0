"""The share of the traced window in which no kernel, copy or memset ran on the device."""

from fhebench import tracing


def read(t: tracing.Trace):
    if t.window_s <= 0 or not (t.kernels or t.copies):
        return None
    return 100.0 * (1.0 - tracing.busy_s(t) / t.window_s)
