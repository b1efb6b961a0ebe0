"""Kernel-dispatch counting — the measurable half of the fusion story.

Every public op wrapper (ntt, bconv, modops, fusedks, hoistrot) records one dispatch per
device-kernel launch it issues.  The fused key-switch pipeline's whole point is
collapsing the staged per-digit launch train (prescale, BConv, NTT, two MACs,
two accumulates — each a separate launch whose intermediates round-trip through
HBM-equivalent buffers) into one kernel launch; this module lets benchmarks and
tests *measure* that collapse instead of asserting it.

Counting happens at Python call time, once per launch: PyTorch runs eagerly,
so the count is the number of kernels the call issued.  The op names are the
reference package's, so the counts of the two packages compare key for key.

``hook_dispatches`` lets an observer see every launch in a block:
``repro_torch.obs.Tracer.dispatch_hook()`` plugs into it (through
``ExecPolicy.traced``) and turns each launch into a unit-width slice at its
dispatch index.
"""

from __future__ import annotations

import contextlib
import contextvars

_COUNTS: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "kernel_dispatch_counts", default=None
)
_HOOKS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "kernel_dispatch_hooks", default=()
)


def record(op: str) -> None:
    """Count one kernel dispatch under ``op`` when a counter is active."""
    c = _COUNTS.get()
    if c is not None:
        c[op] = c.get(op, 0) + 1
    for hook in _HOOKS.get():
        hook(op)


@contextlib.contextmanager
def count_dispatches():
    """Collect {op: dispatch_count} for every kernel launched in the block."""
    token = _COUNTS.set({})
    try:
        yield _COUNTS.get()
    finally:
        _COUNTS.reset(token)


@contextlib.contextmanager
def hook_dispatches(fn):
    """Invoke ``fn(op)`` on every kernel dispatch inside the block.

    Unlike ``count_dispatches`` (one aggregate dict per block), hooks compose:
    nested blocks stack, and every active hook sees every dispatch.  This is
    the mechanism behind ``ExecPolicy.dispatch_hook`` — an evaluation context
    can observe its own kernel-launch stream without owning the call site.
    """
    token = _HOOKS.set(_HOOKS.get() + (fn,))
    try:
        yield
    finally:
        _HOOKS.reset(token)


def total(counts: dict) -> int:
    return sum(counts.values())


def counting() -> bool:
    return _COUNTS.get() is not None
