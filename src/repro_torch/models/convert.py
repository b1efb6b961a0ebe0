"""The reference's model parameters as the port's.

``repro.models`` keeps each model's parameters as a tree of arrays whose
per-layer entries (``blocks``, ``enc_blocks``, ``dec_blocks``) are stacked on
a leading layer axis.  ``params_from_reference`` takes that tree as numpy
arrays and gives the port's ``ParamTree``, one module per layer, on a device.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .lm import ParamTree, resolve_device


def _layer_counts(cfg: ModelConfig) -> dict[str, int]:
    if cfg.family == "audio":
        return {"enc_blocks": cfg.enc_layers, "dec_blocks": cfg.n_layers}
    return {"blocks": cfg.n_layers}


def _tensors(tree, dev, layer=None):
    if isinstance(tree, dict):
        return {k: _tensors(v, dev, layer) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype != np.float32:
        raise TypeError(f"reference parameters are float32, got {a.dtype}")
    return torch.from_numpy(np.array(a if layer is None else a[layer], copy=True)).to(dev)


def params_from_reference(cfg: ModelConfig, tree: dict, device="cuda") -> ParamTree:
    """``tree``: the reference's ``init_params`` output as numpy float32 arrays."""
    dev = resolve_device(device)
    out = {}
    for k, v in tree.items():
        n = _layer_counts(cfg).get(k)
        if n is None:
            out[k] = _tensors(v, dev)
            continue
        lead = {np.shape(a)[0] for a in _leaves(v)}
        if lead != {n}:
            raise ValueError(f"{k}: leading axes {sorted(lead)}, expected {n} layers")
        out[k] = [_tensors(v, dev, i) for i in range(n)]
    return ParamTree(out)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
