"""The reference's model parameters as the port's.

``repro.models`` keeps each model's parameters as a tree of arrays whose
per-layer entries (``blocks``, ``enc_blocks``, ``dec_blocks``) are stacked on
a leading layer axis.  ``params_from_reference`` takes that tree as numpy
arrays and gives the port's ``ParamTree``, one module per layer, on a device;
``params_to_reference`` is its inverse.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

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
    return ParamTree(tree_from_reference(cfg, tree, device))


def tree_from_reference(cfg: ModelConfig, tree: dict, device="cuda") -> dict:
    """A tree of the reference's parameter layout (the parameters, or AdamW's
    moments) as plain dicts of tensors on a device, one list entry per layer."""
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
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def params_to_reference(cfg: ModelConfig, params) -> dict:
    """The port's ``ParamTree`` (or a tree of its shape, such as AdamW's
    moments) as the reference's: numpy float32, per-layer lists stacked on a
    leading layer axis."""
    tree = reference_layout(params)
    for k, n in _layer_counts(cfg).items():
        lead = {np.shape(a)[0] for a in _leaves(tree[k])}
        if lead != {n}:
            raise ValueError(f"{k}: {sorted(lead)} layers, expected {n}")
    bad = sorted({str(a.dtype) for a in _leaves(tree)} - {"float32"})
    if bad:
        raise TypeError(f"parameters must be float32, got {bad}")
    return tree


def reference_layout(tree):
    """A tree of ``ParamTree``s, dicts, per-layer lists, tensors and numpy
    arrays as nested dicts of numpy arrays, each list stacked on a leading
    axis (the layout of the reference's trees and checkpoints)."""
    if isinstance(tree, ParamTree):
        tree = {k: tree[k] for k in tree.keys()}
    if isinstance(tree, dict):
        return {k: reference_layout(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        return _stack([reference_layout(t) for t in tree])
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _stack(layers: list):
    if isinstance(layers[0], dict):
        return {k: _stack([layer[k] for layer in layers]) for k in layers[0]}
    return np.stack(layers)
