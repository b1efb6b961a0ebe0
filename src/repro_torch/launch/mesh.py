"""Device meshes.

Defined as functions (never module-level constants) so importing this module
starts no process group.

``make_production_mesh`` gives the reference's 16×16 ("data", "model") pod
or its 2×16×16 ("pod", "data", "model") pair of pods.  A mesh is built over
the running process group, and raises where none runs.  Only a caller that
asks for it with ``fake=True`` (the dry-run) gets one over torch's ``fake``
backend (``FakeStore``), started here, in which this process is rank 0 and
every collective returns at once without moving data: shapes, placements
and the collectives' sizes are real, their values are not.
``single_device_mesh`` is a real 1×1 mesh over a one-rank group: gloo on
the CPU, NCCL on a card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _device_type(device_type: str) -> str:
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a mesh on device type 'cuda' needs a CUDA card; pass device_type='cpu' for the CPU")
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"device_type {device_type!r}: 'cpu' or 'cuda'")
    return device_type


def fake_process_group(world_size: int) -> None:
    """Start a ``fake`` process group of ``world_size`` ranks (this process
    rank 0): keep a running fake group of that size, end one of another
    size; a running group of another backend raises."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group is running; end it before a fake mesh")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str = "cuda", *, fake: bool = False):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the running process
    group; with ``fake``, over a fake group of that size
    (``fake_process_group``).  Without ``fake``, no running group raises."""
    from torch.distributed.device_mesh import init_device_mesh

    kind = _device_type(device_type)
    if fake:
        n = 1
        for s in shape:
            n *= s
        fake_process_group(n)
    elif not dist.is_initialized():
        raise RuntimeError("no process group runs: call torch.distributed.init_process_group first "
                           "(or pass fake=True for a dry-run mesh whose collectives move nothing)")
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda", fake: bool = False):
    """16×16 = 256 chips per pod; 2 pods = 512 chips when multi_pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type, fake=fake)


def single_device_mesh(device="cuda"):
    """A 1×1 ("data", "model") mesh over a one-rank process group on
    ``device`` (gloo on the CPU, NCCL on a card), started here unless one
    runs.  The caller ends it with ``torch.distributed.destroy_process_group()``."""
    dev = torch.device(device)
    kind = _device_type(dev.type)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if kind == "cuda" else "gloo", store=dist.HashStore(), rank=0, world_size=1)
    if kind == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return make_mesh((1, 1), ("data", "model"), kind)
