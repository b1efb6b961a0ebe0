"""Instruction-trace hooks.

FHE programs are data-oblivious, so the exact instruction stream (NTT/INTT/BCONV/
PMULT/PADD/AUTO/KSK loads...) is known statically.  The FHE ops record into an
ambient trace when one is active; a scheduler can replay these traces
through a cycle-level simulator — mirroring the paper's design, where
software generates the static control instructions.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses


@dataclasses.dataclass
class Instr:
    op: str  # NTT | INTT | BCONV | PMULT | PADD | PSUB | AUTO | LOAD_KSK | RESCALE_DIV
    n: int  # ring degree
    limbs: int  # limbs processed
    meta: dict


_TRACE: contextvars.ContextVar[list | None] = contextvars.ContextVar("fhe_trace", default=None)


def record(op: str, n: int, limbs: int, **meta) -> None:
    t = _TRACE.get()
    if t is not None:
        t.append(Instr(op, n, limbs, meta))


@contextlib.contextmanager
def capture_trace():
    token = _TRACE.set([])
    try:
        yield _TRACE.get()
    finally:
        _TRACE.reset(token)


def tracing() -> bool:
    return _TRACE.get() is not None
