"""The job's least time from the frozen work count as a share of the wall time per
job in the traced window: how much of the chip's peak the whole job uses."""

from fhebench import tracing


def read(t: tracing.Trace):
    if t.window_s <= 0 or not t.jobs or t.least_s_per_job <= 0:
        return None
    return 100.0 * t.least_s_per_job * t.jobs / t.window_s
