"""Megabytes copied from host to device per job: constants encoded on the host and
the input ciphertext, from the bytes of the trace's HtoD copies."""

from fhebench import tracing


def read(t: tracing.Trace):
    moved = [c[3] for c in t.copies if "HtoD" in c[2] and t.window[0] <= c[0] < t.window[1]]
    if not moved or not t.jobs:
        return None
    return sum(moved) / t.jobs / 1e6
