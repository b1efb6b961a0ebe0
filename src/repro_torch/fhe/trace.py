"""Instruction-trace hooks.

FHE programs are data-oblivious, so the exact instruction stream (NTT/INTT/BCONV/
PMULT/PADD/AUTO/KSK loads...) is known statically.  The FHE ops record into an
ambient trace when one is active; the scheduler (repro_torch.core) replays these
traces through the cycle-level simulator and the cache model — mirroring the
paper's "software driver generates static control instructions" design.
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
