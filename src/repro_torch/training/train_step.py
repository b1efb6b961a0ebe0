"""The train step: loss and gradients → (int8 pod all-reduce) → clip → AdamW.

``build_train_step`` gives the reference's step on one device: the model's
loss and its backward pass, both under ``layers.reference_precision()`` (a
backward outside it would run its GEMMs, remat's recompute included, with
cuBLAS's bf16-reduced reductions and TF32 where the process allows them),
optional microbatch accumulation in float32, and one AdamW update.  With
``compress_pods`` the gradients are mean-all-reduced in int8 over ``group``
(``training.compress``).  Meshes and sharded steps are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.registry import ModelApi

from . import compress, optimizer as opt

F32 = torch.float32


def _vg(api: ModelApi, params, batch: dict):
    leaves = opt.tree_leaves(params)
    with L.reference_precision():
        loss = api.train_loss(params, **batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # pin gradient dtypes to the parameter dtypes; a leaf the loss does not
    # reach gets zeros, as jax.grad gives
    grads = [torch.zeros_like(p) if g is None else g.to(p.dtype) for g, p in zip(grads, leaves)]
    return loss.detach().to(F32), grads


def loss_and_grads(api: ModelApi, params, batch: dict, microbatch: int = 0):
    """(float32 loss, gradients as a tree of ``params``' structure and dtypes).

    With ``microbatch`` > 1 the batch's leading axis is split in that many
    parts, run one after another; losses and gradients are summed in float32
    and divided by ``microbatch``."""
    if microbatch and microbatch > 1:
        parts = {k: v.reshape(microbatch, v.shape[0] // microbatch, *v.shape[1:]) for k, v in batch.items()}
        leaves = opt.tree_leaves(params)
        loss = torch.zeros((), dtype=F32, device=leaves[0].device)
        grads = [torch.zeros_like(p, dtype=F32) for p in leaves]
        for i in range(microbatch):
            loss_i, g_i = _vg(api, params, {k: p[i] for k, p in parts.items()})
            loss = loss + loss_i
            grads = [a + b for a, b in zip(grads, g_i)]
        inv = 1.0 / microbatch
        loss, grads = loss * inv, [(g * inv).to(p.dtype) for g, p in zip(grads, leaves)]
    else:
        loss, grads = _vg(api, params, batch)
    return loss, opt.tree_unflatten(params, grads)


def build_train_step(api: ModelApi, mesh, acfg: opt.AdamWConfig, compress_pods: bool = False,
                     microbatch: int = 0, group=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics),
    metrics = {"loss", "grad_norm", "lr"} as float32 scalar tensors.

    ``mesh`` must be None (one device).  ``compress_pods`` needs ``group``, a
    ``torch.distributed`` process group over the pods."""
    if mesh is not None:
        raise NotImplementedError("sharded train steps over a mesh are not ported yet; pass mesh=None")
    if compress_pods and group is None:
        raise ValueError("compress_pods needs the pods' process group (group=)")

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(api, params, batch, microbatch)
        if compress_pods:
            grads = compress.compressed_psum_mean(grads, group)
        params, opt_state, gnorm = opt.apply_updates(acfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": opt.lr_at(acfg, opt_state["step"] - 1)}

    return train_step
