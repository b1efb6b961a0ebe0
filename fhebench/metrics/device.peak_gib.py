"""Peak device memory allocated during the window (``torch.cuda.max_memory_allocated``
after a reset at the window's start), in GiB."""

from fhebench import tracing


def read(t: tracing.Trace):
    if not t.peak_bytes:
        return None
    return t.peak_bytes / 2**30
