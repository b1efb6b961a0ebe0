"""Wall-clock spans inside the port, on the profiler's clock.

``span(name)`` marks a stretch of host work (an encode, a key-switch, a table
build) for ``torch.profiler``.  While a profiler is recording it returns
``torch.profiler.record_function(name)``, whose ``user_annotation`` event Kineto
puts on the same clock as the device's kernel, copy and memset events, so an
idle stretch of the device can be laid against what the host was doing.  With
no profiler recording it returns one shared no-op context manager: one C call
and one ``with``, no allocation (an ungated ``record_function`` costs more than
ten times as much even with the profiler off).

This is the real-time seam.  ``Tracer`` (``obs.trace``) is the simulated-time
seam of the simulator and serving model, and neither feeds the other.  A span
records no ``fhe.trace`` instruction and no kernel dispatch.  Span names start
with ``fhe.``; ``window`` and ``job`` are left to the caller that times whole
requests.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` while a profiler records, else a no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
