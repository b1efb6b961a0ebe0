"""The job's least time from the frozen work count (``fhebench/cost``) as a share
of the time the device spent in kernels per job (the union of their intervals)."""

from fhebench import tracing


def read(t: tracing.Trace):
    busy = tracing.union_us(tracing.kernel_intervals(t)) * 1e-6
    if busy <= 0 or not t.jobs or t.least_s_per_job <= 0:
        return None
    return 100.0 * t.least_s_per_job * t.jobs / busy
