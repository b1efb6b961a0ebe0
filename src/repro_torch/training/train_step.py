"""The train step: loss and gradients → (int8 pod all-reduce) → clip → AdamW.

``build_train_step`` gives the reference's step: the model's loss and its
backward pass, both under ``layers.reference_precision()`` (a backward
outside it would run its GEMMs, remat's recompute included, with cuBLAS's
bf16-reduced reductions and TF32 where the process allows them), optional
microbatch accumulation in float32, and one AdamW update.

Without a mesh it runs on plain tensors on one device; with
``compress_pods`` the gradients are then mean-all-reduced in int8 over
``group`` (``training.compress``).  With a ``DeviceMesh`` the params, the
AdamW state and the batch are DTensors (``jit_train_step`` places them by
the spec trees): the loss and its backward run under
``sharding.sharded_run()``, and each gradient is redistributed to its
parameter's placements — the in-mesh gradient reduction, as a reduce-scatter
or an all-reduce, that XLA's partitioner inserts in the reference.  With
``compress_pods`` on a mesh whose "pod" axis has more than one pod, the
"pod" axis is manual, as the reference's ``shard_map`` makes it: each pod
runs the loss on its own batch over its ("data", "model") sub-mesh, and the
gradients cross pods only through ``compressed_psum_mean`` over the mesh's
"pod" group, in int8.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.models import layers as L
from repro_torch.models.registry import ModelApi

from . import compress, optimizer as opt

F32 = torch.float32


def _vg(api: ModelApi, params, batch: dict, mesh=None):
    leaves = opt.tree_leaves(params)
    with L.reference_precision():
        loss = api.train_loss(params, mesh=mesh, **batch)
        loss = sh.replicate(loss)  # a DTensor's backward starts from the replicated loss
        with sh.sharded_run() if mesh is not None else contextlib.nullcontext():
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # pin gradient dtypes (and placements) to the parameters'; a leaf the loss
    # does not reach gets zeros, as jax.grad gives
    grads = [torch.zeros_like(p) if g is None else _like(g.to(p.dtype), p) for g, p in zip(grads, leaves)]
    return loss.detach().to(F32), grads


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g`` in ``p``'s placements (the gradient reduction over the mesh)."""
    if sh.is_dtensor(g):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def loss_and_grads(api: ModelApi, params, batch: dict, microbatch: int = 0, mesh=None):
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
            loss_i, g_i = _vg(api, params, {k: p[i] for k, p in parts.items()}, mesh)
            loss = loss + loss_i
            grads = [a + b for a, b in zip(grads, g_i)]
        inv = 1.0 / microbatch
        loss, grads = loss * inv, [(g * inv).to(p.dtype) for g, p in zip(grads, leaves)]
    else:
        loss, grads = _vg(api, params, batch, mesh)
    return loss, opt.tree_unflatten(params, grads)


def build_train_step(api: ModelApi, mesh, acfg: opt.AdamWConfig, compress_pods: bool = False,
                     microbatch: int = 0, group=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics),
    metrics = {"loss", "grad_norm", "lr"} as float32 scalar tensors.

    ``mesh`` None runs on plain tensors, a ``DeviceMesh`` on DTensors placed
    on it.  ``compress_pods`` reduces the gradients over the pods in int8:
    over ``group`` (a ``torch.distributed`` process group) where one is
    given, else over the mesh's "pod" axis, and not at all on a mesh of one
    pod, as the reference."""
    from torch.distributed.device_mesh import DeviceMesh

    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be None or a torch.distributed DeviceMesh, not {type(mesh).__name__}")
    pods = mesh is not None and sh.axis_size(mesh, "pod") > 1
    if compress_pods and group is None and mesh is None:
        raise ValueError("compress_pods needs the pods' process group (group=) or a mesh with a 'pod' axis")
    sharded = (lambda: sh.sharded_run()) if mesh is not None else contextlib.nullcontext

    def train_step(params, opt_state, batch):
        with sharded():
            if compress_pods and group is None and pods:
                loss, grads = _pod_loss_and_grads(api, params, batch, microbatch, mesh)
            else:
                loss, grads = loss_and_grads(api, params, batch, microbatch, mesh)
                if compress_pods and group is not None:
                    grads = compress.compressed_psum_mean(grads, group)
            params, opt_state, gnorm = opt.apply_updates(acfg, params, grads, opt_state)
            return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                       "lr": opt.lr_at(acfg, opt_state["step"] - 1)}

    return train_step


def _pod_loss_and_grads(api: ModelApi, params, batch: dict, microbatch: int, mesh):
    """Loss and gradients with the "pod" axis manual: each pod's loss and
    backward over its ("data", "model") sub-mesh, on its own shards of the
    params and the batch, then the int8 ``compressed_psum_mean`` of every
    rank's gradient shard over the mesh's "pod" group (the ranks holding the
    same shard in each pod).  The loss is the pods' float mean."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.models.lm import ParamTree

    names = mesh.mesh_dim_names
    pod = names.index("pod")
    inner = mesh[tuple(n for n in names if n != "pod")]

    def down(x):
        kept = [p for i, p in enumerate(x.placements) if i != pod]
        return DTensor.from_local(x.to_local().detach(), inner, kept, run_check=False)

    local = ParamTree(opt.tree_map(down, params))
    loss, grads = loss_and_grads(api, local, {k: down(v) for k, v in batch.items()}, microbatch, inner)
    group = mesh.get_group("pod")
    reduced = compress.compressed_psum_mean(opt.tree_map(lambda g: g.to_local(), grads), group)
    grads = opt.tree_map(lambda g, p: DTensor.from_local(g, mesh, p.placements, run_check=False), reduced, params)
    loss = loss.to_local().clone()
    dist.all_reduce(loss, group=group)
    loss = opt.over(loss, dist.get_world_size(group))
    return sh.as_replicated(loss, mesh), grads


def jit_train_step(api: ModelApi, mesh, acfg: opt.AdamWConfig, batch_specs: dict, compress_pods: bool = False,
                   microbatch: int = 0):
    """The sharded step with explicit in/out placements — the dry-run's entry
    point.  The returned step places the params by ``api.param_specs(mesh)``,
    the AdamW state by ``optimizer.state_specs`` of them and the batch by
    ``batch_specs`` ({name: Spec}); a leaf that is already a DTensor is
    redistributed, a plain tensor (the same on every rank) distributed.  Its
    params and state come out in those placements, its metrics as
    replicated scalars.

    The reference's jit donates the params and the state to the step.  Torch
    has no donation: the step returns new tensors and leaves its inputs as
    they were; a caller that keeps no reference to them frees them."""
    pspecs = api.param_specs(mesh)
    sspecs = opt.state_specs(pspecs)
    step = build_train_step(api, mesh, acfg, compress_pods, microbatch)

    def run(params, opt_state, batch):
        params = sh.distribute_tree(params, mesh, pspecs)
        opt_state = sh.distribute_tree(opt_state, mesh, sspecs)
        batch = {k: sh.distribute(v, mesh, batch_specs[k]) for k, v in batch.items()}
        params, opt_state, metrics = step(params, opt_state, batch)
        return (sh.distribute_tree(params, mesh, pspecs), sh.distribute_tree(opt_state, mesh, sspecs),
                {k: sh.distribute(v, mesh, sh.Spec()) for k, v in metrics.items()})

    return run
