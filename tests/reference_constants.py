"""Where the port's instruction and dispatch streams leave the reference's.

The reference package encodes every constant on the host and transforms it:
one ``NTT`` instruction (n, level+1) and one ``ntt`` dispatch a constant.  The
port builds a real constant's eval-domain column where it is used and runs no
NTT for it, so its streams are the reference's with exactly that instruction
and that dispatch taken out for each real constant.  ``track()`` wraps the
reference's ``ops._encode_const`` and marks the position of each such NTT in
the trace that is being captured, so a test can state the port's stream
exactly instead of finding the positions by hand.
"""

from __future__ import annotations

import contextlib
import dataclasses

from repro.fhe import ops as R_ops
from repro.fhe import trace as R_trace
from repro_torch.fhe import encoder as T_encoder
from repro_torch.fhe import ops as T_ops
from repro_torch.fhe import trace as T_trace


def is_on_card(c, scale: float) -> bool:
    """True where the port builds the constant as a residue column (no NTT)."""
    v = T_encoder.const_integer(c, scale)
    return v is not None and abs(v) < 1 << 62


@dataclasses.dataclass
class Marks:
    ref: list = dataclasses.field(default_factory=list)  # (captured trace, index, n, limbs)
    port: list = dataclasses.field(default_factory=list)  # (captured trace, c, level) of the port's real constants

    def of(self, trace) -> list:
        return [(i, n, limbs) for t, i, n, limbs in self.ref if t is trace]

    def port_constants(self, trace) -> int:
        """The real constants the port encoded while ``trace`` was captured."""
        return sum(1 for t, _, _ in self.port if t is trace)

    def stream(self, trace) -> list:
        """The reference's captured ``trace`` without the NTT of each real constant."""
        drop = set()
        for i, n, limbs in self.of(trace):
            assert (trace[i].op, trace[i].n, trace[i].limbs) == ("NTT", n, limbs), (i, trace[i])
            drop.add(i)
        return [instr for i, instr in enumerate(trace) if i not in drop]

    def counts(self, counts: dict, trace) -> dict:
        """The reference's dispatch counts without one ``ntt`` a real constant."""
        out = dict(counts)
        out["ntt"] = out.get("ntt", 0) - len(self.of(trace))
        return {k: v for k, v in out.items() if v}


@contextlib.contextmanager
def track():
    """Mark the reference's real-constant NTTs in every captured trace, and
    count the real constants the port encodes, inside the block."""
    marks = Marks()
    r_orig, t_orig = R_ops._encode_const, T_ops._encode_const

    def r_wrapped(ctx, c, level, scale):
        t = R_trace._TRACE.get()
        start = None if t is None else len(t)
        out = r_orig(ctx, c, level, scale)
        if start is not None and is_on_card(c, scale):
            marks.ref.append((t, start, ctx.params.n, level + 1))
        return out

    def t_wrapped(ctx, c, level, scale):
        t = T_trace._TRACE.get()
        if t is not None and is_on_card(c, scale):
            marks.port.append((t, c, level))
        return t_orig(ctx, c, level, scale)

    R_ops._encode_const, T_ops._encode_const = r_wrapped, t_wrapped
    try:
        yield marks
    finally:
        R_ops._encode_const, T_ops._encode_const = r_orig, t_orig
