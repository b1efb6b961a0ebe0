"""AdamW with global-norm clipping, on tensor trees.

Moments are float32 trees in the parameters' structure and on their device,
plain nested dicts and per-layer lists of tensors; ``step`` is an int32
scalar tensor.  Moments share the parameters' specs (``state_specs``), so
optimizer state is ZeRO-sharded wherever weights are FSDP-sharded: on DTensor
leaves every element-wise update runs on the local shards, and
``global_norm`` sums the shards' partial sums over the mesh.  A tree is a ``ParamTree``, a dict, a per-layer list or a
tensor.  ``apply_updates`` is functional, as the
reference's: it returns new tensors and leaves its inputs as they were.
The schedule and the bias corrections are float32 tensor arithmetic, in the
reference's order.  Every division has a tensor divisor (``over``): CUDA
divides by a Python number as a product with its reciprocal, which rounds
otherwise than the reference's division.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn

from repro_torch.models.lm import ParamTree

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _items(tree):
    if isinstance(tree, ParamTree):
        return [(k, tree[k]) for k in sorted(tree.keys())]
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        return list(enumerate(tree))
    return None


def _map(fn, tree, rest):
    items = _items(tree)
    if items is None:
        return fn(tree, *rest)
    out = {k: _map(fn, v, [r[k] for r in rest]) for k, v in items}
    return out if isinstance(tree, (dict, ParamTree)) else [out[i] for i in range(len(items))]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of its structure in
    ``rest``, as a plain tree: a ``ParamTree`` or dict gives a dict, a list a
    list."""
    return _map(fn, tree, list(rest))


def tree_leaves(tree) -> list:
    """The leaves in ``tree_map``'s order (dict keys sorted, as ``jax.tree``)."""
    items = _items(tree)
    if items is None:
        return [tree]
    return [leaf for _, v in items for leaf in tree_leaves(v)]


def tree_unflatten(like, leaves):
    """``leaves`` (in ``tree_leaves`` order) in the plain structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def over(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, rounded as one float32 division on every device (``d`` filled
    on x's device: no copy from the host, no wait for the card)."""
    return x / torch.full((), d, dtype=F32, device=x.device)


def lr_at(cfg: AdamWConfig, step):
    """Warm-up then cosine decay, float32, at an int step or int32 tensor."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = over(cfg.lr_peak * (step + 1), cfg.warmup_steps)
    prog = torch.clamp(over(step - cfg.warmup_steps, max(1, cfg.total_steps - cfg.warmup_steps)), 0.0, 1.0)
    cos = 0.5 * cfg.lr_peak * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params) -> dict:
    zeros = lambda p: torch.zeros_like(p, dtype=F32, requires_grad=False)
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def state_specs(param_specs) -> dict:
    """Optimizer state specs mirror the parameters'."""
    from repro_torch.distributed.sharding import Spec

    return {"m": param_specs, "v": param_specs, "step": Spec()}


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32))) for x in leaves))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state):
    """One AdamW step; returns (new_params, new_state, grad_norm)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(torch.full((), cfg.clip_norm, dtype=F32, device=gnorm.device)
                            / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = lr_at(cfg, state["step"])
    b1c = 1.0 - cfg.b1 ** step.to(F32)
    b2c = 1.0 - cfg.b2 ** step.to(F32)

    def upd(p, g, m, v):
        g = g.to(F32) * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m_new / b1c
        vh = v_new / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.to(F32)
        return (p.to(F32) - lr * delta).to(p.dtype), m_new, v_new

    flat = [upd(*a) for a in zip(*(tree_leaves(t) for t in (params, grads, state["m"], state["v"])))]
    new_p = tree_unflatten(params, [o[0] for o in flat])
    if isinstance(params, ParamTree):
        new_p = ParamTree(new_p)
    new_m = tree_unflatten(params, [o[1] for o in flat])
    new_v = tree_unflatten(params, [o[2] for o in flat])
    return new_p, {"m": new_m, "v": new_v, "step": step}, gnorm
