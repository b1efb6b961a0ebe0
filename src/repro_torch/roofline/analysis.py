"""Three-term roofline of one step on H100 cards (no hardware needed).

  compute    = FLOPs / (cards × peak bf16 FLOP/s)
  memory     = HBM bytes / (cards × HBM bytes/s)
  collective = collective bytes / (cards × one NVLink's bytes/s)

The constants are the H100 SXM's (``core.hardware``).  ``collective_bytes``
parses XLA HLO text (all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute result sizes), as the reference does.  The port's own
source is ``CollectiveRecorder``, a dispatch mode that records every
collective a torch program issues (DTensor's redistributions, the
``torch.distributed`` calls of the int8 compression); ``collective_bytes_of``
sums it as ``collective_bytes`` sums the HLO: result-shape bytes per kind.
"""

from __future__ import annotations

import dataclasses
import re

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.hardware import H100_HBM_BPS, H100_NVLINK_BPS, H100_PEAK_FLOPS_BF16

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    """'f32[16,128]' → bytes.  Tuples handled by the caller via findall."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> dict:
    """Sum result-shape bytes per collective kind over the optimised HLO."""
    out = {k: 0 for k in _COLLECTIVES}
    count = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        ls = line.strip()
        # match "<name> = <shape(s)> <op>(" — the op name before the paren
        m = re.search(r"=\s*(\([^)]*\)|[^\s]+)\s+([\w-]+)", ls)
        if not m:
            continue
        op = m.group(2)
        # strip fusion suffixes like all-reduce-start
        base = None
        for c in _COLLECTIVES:
            if op == c or op.startswith(c + "-"):
                base = c
                break
        if base is None or op.endswith("-done"):
            continue
        out[base] += _shape_bytes(m.group(1))
        count[base] += 1
    return {"bytes": out, "count": count, "total_bytes": sum(out.values())}


# torch ops → the reference's collective kinds: the functional collectives
# (``_c10d_functional``, DTensor's) and the in-place ``c10d`` ops of
# ``torch.distributed``'s eager calls
_TORCH_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}


def _result_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_result_bytes(o) for o in out)
    return 0


class CollectiveRecorder(TorchDispatchMode):
    """Records (kind, result bytes) of every collective dispatched while it
    is on.  DTensor operations pass through to DTensor first (the mode
    answers ``NotImplemented`` to them), so the collectives they lower to are
    what it sees, at each rank's local shapes — the per-device sizes that the
    reference reads from the partitioned HLO.  For an eager in-place op the
    result is the tensor it writes."""

    def __init__(self):
        super().__init__()
        self.records: list[tuple[str, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.namespace in ("_c10d_functional", "c10d"):
            kind = _TORCH_COLLECTIVES.get(func._opname)
            if kind is not None:
                result = out[0] if func.namespace == "c10d" and isinstance(out, tuple) else out
                self.records.append((kind, _result_bytes(result)))
        return out


def collective_bytes_of(recorder: CollectiveRecorder) -> dict:
    """``collective_bytes``' dict from what ``recorder`` saw."""
    out = {k: 0 for k in _COLLECTIVES}
    count = {k: 0 for k in _COLLECTIVES}
    for kind, nbytes in recorder.records:
        out[kind] += nbytes
        count[kind] += 1
    return {"bytes": out, "count": count, "total_bytes": sum(out.values())}


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   chips: int) -> Roofline:
    comp = flops / (chips * H100_PEAK_FLOPS_BF16)
    mem = hbm_bytes / (chips * H100_HBM_BPS)
    coll = coll_bytes / (chips * H100_NVLINK_BPS)
    dominant = max((("compute", comp), ("memory", mem), ("collective", coll)),
                   key=lambda kv: kv[1])[0]
    return Roofline(flops=flops, hbm_bytes=hbm_bytes, coll_bytes=coll_bytes,
                    chips=chips, compute_s=comp, memory_s=mem,
                    collective_s=coll, dominant=dominant)


def model_flops_per_step(param_count: int, active_param_count: int,
                         tokens: int, kind: str) -> float:
    """6·N·D (train) / 2·N·D (inference) with N = active parameters."""
    n = active_param_count
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens
