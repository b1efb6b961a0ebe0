"""Where the port's dispatch counts leave the reference's on a CKKS rescale.

The reference rescales each component of a ciphertext with an ``intt`` of the
dropped limb, an ``ntt`` over the remaining ones, a ``submod`` and a
``mulmod``.  Under the fused pipeline the port runs both components as one
``fused_rescale`` launch, one ``rescale`` dispatch, and still records the
reference's ``INTT``/``NTT``/``PSUB``/``PMULT`` instructions in its order, so
its ``fhe.trace`` stream is the reference's and its dispatch counts are the
reference's less 2 ``intt``, 2 ``ntt``, 2 ``submod`` and 2 ``mulmod``, plus
one ``rescale``, for each rescale (``ROADMAP.md`` Queue 3).  The staged
pipeline runs the reference's composition and counts.

``track()`` wraps the reference's ``ops._rescale`` and counts its calls, and
marks where each one's dispatches lie in the block's dispatch stream, so a
test states the port's counts and slice names from the reference's instead of
by hand.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import pathlib

from repro.fhe import ops as R_ops
from repro.kernels import dispatch as R_dispatch


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _chip_smoke()
OPS = chip_smoke.RESCALE_OPS
ONE = {op: 2 for op in OPS}  # the reference's dispatches of one rescale


def port_counts(ref_counts: dict, rescales: int) -> dict:
    """The reference's dispatch counts of a block that ran ``rescales``
    rescales, as the port's under the fused pipeline."""
    return chip_smoke.fused_rescale_counts(ref_counts, rescales)


@dataclasses.dataclass
class Rescales:
    spans: list = dataclasses.field(default_factory=list)  # (first, end) dispatch index of each rescale

    @property
    def count(self) -> int:
        return len(self.spans)

    def counts(self, ref_counts: dict) -> dict:
        """``port_counts`` of the block's reference counts."""
        return port_counts(ref_counts, self.count)

    def names(self, ref_names: list) -> list:
        """The reference's dispatch names in the block (a traced policy's slice
        names), with each rescale's as the port's one ``rescale``."""
        out, at = [], 0
        for first, end in self.spans:
            assert ref_names[first:end] == [op for _ in range(2) for op in OPS], ref_names[first:end]
            out += ref_names[at:first] + ["rescale"]
            at = end
        return out + ref_names[at:]


@contextlib.contextmanager
def track():
    """Count the reference's rescales inside the block, with their places in
    the block's dispatch stream."""
    marks = Rescales()
    seen = [0]
    orig = R_ops._rescale

    def hook(op):
        seen[0] += 1

    def wrapped(ctx, ct):
        first = seen[0]
        out = orig(ctx, ct)
        marks.spans.append((first, seen[0]))
        return out

    R_ops._rescale = wrapped
    try:
        with R_dispatch.hook_dispatches(hook):
            yield marks
    finally:
        R_ops._rescale = orig
