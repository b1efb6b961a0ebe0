"""The one memo of the port's precomputed tables.

Every table the hot path reads (NTT plans and their device copies, BConv
tables, Montgomery constants, per-limb columns, the rescale's constants) is
built by a function decorated with ``table(name)``:

  * a miss runs the builder inside ``obs.span(f"fhe.table.{name}")``;
  * a result holding CUDA tensors is complete on return: the miss synchronises
    the current stream once, so a table one stream built is safe for any
    stream to read (``_cuda_device`` says which result types it looks inside,
    and raises on any other);
  * nothing is ever evicted, so no stream reads a freed block.  The keys are
    (params, limb set, device), a finite set in any process.

Each builder keeps ``cache_info()``/``cache_clear()``; ``clear()`` and
``builds()`` act on all of them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.obs.spans import span

_REGISTRY: dict[str, Callable] = {}


def _cuda_device(out) -> torch.device | None:
    """The device of the first CUDA tensor in ``out``, else None.

    Walks tensors, tuples, lists, dicts and dataclasses; numbers, strings,
    dtypes, devices and numpy arrays hold no tensor.  Any other type raises,
    so no builder's CUDA result can skip the synchronise."""
    if isinstance(out, torch.Tensor):
        return out.device if out.is_cuda else None
    if out is None or isinstance(out, (int, float, str, bytes, np.ndarray, np.generic, torch.dtype, torch.device)):
        return None
    if isinstance(out, dict):
        items = out.values()
    elif isinstance(out, (tuple, list)):
        items = out
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        items = (getattr(out, f.name) for f in dataclasses.fields(out))
    else:
        raise TypeError(f"a table builder returned a {type(out).__name__}, which kernels.tables cannot look inside")
    for v in items:
        if (dev := _cuda_device(v)) is not None:
            return dev
    return None


def table(name: str):
    """Memoise a table builder under span ``fhe.table.<name>`` (module docstring)."""
    if name in _REGISTRY:
        raise ValueError(f"a table named {name!r} is already registered")

    def wrap(builder):
        @functools.cache
        @functools.wraps(builder)
        def memo(*args):
            with span(f"fhe.table.{name}"):
                out = builder(*args)
                if (dev := _cuda_device(out)) is not None:
                    torch.cuda.current_stream(dev).synchronize()
            return out

        _REGISTRY[name] = memo
        return memo

    return wrap


def registry() -> dict[str, Callable]:
    """Every registered builder by name."""
    return dict(_REGISTRY)


def builds() -> int:
    """Misses of every builder since its last clear."""
    return sum(f.cache_info().misses for f in _REGISTRY.values())


def clear() -> None:
    """Drop every table (after the card has finished reading them)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for f in _REGISTRY.values():
        f.cache_clear()
