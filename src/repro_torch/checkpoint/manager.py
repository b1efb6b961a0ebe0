"""Atomic checkpointing in the reference's on-disk layout.

Layout:  <dir>/step_<N>/
           manifest.msgpack    — tree structure, shapes, dtypes
           shard_0.npz         — every array
           COMMIT              — written last; restore ignores dirs without it

Fault-tolerance properties:
  * atomic commit: the step directory is staged under a tmp name and renamed
    after the COMMIT marker is in place — a preempted save never corrupts the
    latest checkpoint;
  * retention: keep the last K steps.

A saved tree may hold ``ParamTree``s, tensors and numpy arrays; per-layer
lists are stacked on a leading axis (``models.convert.reference_layout``),
so the port and the reference restore each other's checkpoints.  The
manifest is MessagePack, written and read by the small codec below (str,
int, list and str-keyed map: the manifest's types), byte for byte what
``msgpack.packb`` writes.  ``restore`` gives numpy arrays, plain tensors on
``device``, or DTensors placed by ``shardings`` (elastic restore: the saved
arrays are global, so any mesh can take them).
"""

from __future__ import annotations

import os
import shutil
import struct

import numpy as np
import torch

from repro_torch.models.convert import reference_layout
from repro_torch.models.lm import resolve_device

# (exclusive bound, tag, struct format) of MessagePack's integer, string,
# array and map headers, smallest first
_UINT = ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"), (1 << 32, 0xCE, ">I"), (1 << 64, 0xCF, ">Q"))
_SINT = ((1 << 7, 0xD0, ">b"), (1 << 15, 0xD1, ">h"), (1 << 31, 0xD2, ">i"), (1 << 63, 0xD3, ">q"))
_STR = ((1 << 8, 0xD9, ">B"), (1 << 16, 0xDA, ">H"), (1 << 32, 0xDB, ">I"))
_ARRAY = ((1 << 16, 0xDC, ">H"), (1 << 32, 0xDD, ">I"))
_MAP = ((1 << 16, 0xDE, ">H"), (1 << 32, 0xDF, ">I"))


def _header(n: int, fix_limit: int, fix_tag: int, wide) -> bytes:
    if n < fix_limit:
        return bytes([fix_tag | n])
    for limit, tag, fmt in wide:
        if n < limit:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"{n} does not fit a MessagePack header")


def packb(obj) -> bytes:
    """``obj`` (str, int, list or tuple, dict with str keys) as MessagePack."""
    if isinstance(obj, bool) or not isinstance(obj, (int, str, list, tuple, dict)):
        raise TypeError(f"the manifest codec does not pack {type(obj).__name__}")
    if isinstance(obj, int):
        if -32 <= obj < 128:
            return struct.pack(">b", obj)
        for limit, tag, fmt in _UINT if obj > 0 else _SINT:
            if -limit <= obj < limit:
                return bytes([tag]) + struct.pack(fmt, obj)
        raise ValueError(f"{obj} does not fit 64 bits")
    if isinstance(obj, str):
        data = obj.encode("utf-8")
        return _header(len(data), 32, 0xA0, _STR) + data
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise TypeError("manifest map keys must be str")
        return _header(len(obj), 16, 0x80, _MAP) + b"".join(packb(k) + packb(v) for k, v in obj.items())
    return _header(len(obj), 16, 0x90, _ARRAY) + b"".join(packb(v) for v in obj)


def unpackb(data: bytes):
    """The value ``packb`` wrote (lists for arrays, dicts for maps)."""
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} bytes after the manifest")
    return obj


# tag → (kind, struct format of its length or value) for the wide headers
_WIDE = {tag: (kind, fmt) for kind, table in (("int", _UINT), ("int", _SINT), ("str", _STR), ("array", _ARRAY),
                                              ("map", _MAP)) for _, tag, fmt in table}


def _unpack(buf: memoryview, i: int):
    tag = buf[i]
    i += 1
    if tag < 0x80:
        return tag, i
    if tag >= 0xE0:
        return tag - 0x100, i
    for lo, hi, kind in ((0xA0, 0xBF, "str"), (0x90, 0x9F, "array"), (0x80, 0x8F, "map")):
        if lo <= tag <= hi:
            return _body(buf, i, kind, tag - lo)
    if tag not in _WIDE:
        raise ValueError(f"MessagePack tag {tag:#04x} is not a manifest type")
    kind, fmt = _WIDE[tag]
    (n,) = struct.unpack_from(fmt, buf, i)
    i += struct.calcsize(fmt)
    return (n, i) if kind == "int" else _body(buf, i, kind, n)


def _body(buf: memoryview, i: int, kind: str, n: int):
    if kind == "str":
        return bytes(buf[i:i + n]).decode("utf-8"), i + n
    items = []
    for _ in range(n * (2 if kind == "map" else 1)):
        v, i = _unpack(buf, i)
        items.append(v)
    if kind == "map":
        return dict(zip(items[0::2], items[1::2])), i
    return items, i


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(flat: dict):
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return root


def save(ckpt_dir: str, step: int, tree, keep: int = 3) -> str:
    """Write one checkpoint step (one writer covers the global view)."""
    arrays = _flatten(reference_layout(tree))
    manifest = {
        "step": step,
        "keys": list(arrays),
        "shapes": {k: list(a.shape) for k, a in arrays.items()},
        "dtypes": {k: str(a.dtype) for k, a in arrays.items()},
    }
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(packb(manifest))
    np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for d in sorted(os.listdir(ckpt_dir)):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "COMMIT")):
                best = int(d.split("_")[1])
    return best


def restore(ckpt_dir: str, step: int | None = None, shardings=None, device=None):
    """Load a checkpoint: (step, tree of numpy arrays), or of tensors on
    ``device`` if given.  ``shardings`` maps paths of the saved tree to
    (mesh, placements) pairs (``sharding.named``): as a tree of the saved
    structure, or flat ({"params/embed": ...}); each such array becomes a
    DTensor with those placements on the mesh's device type, the rest stay
    as ``device`` says."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.exists(os.path.join(d, "COMMIT")):
        raise FileNotFoundError(f"checkpoint {d} has no COMMIT marker")
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        manifest = unpackb(f.read())
    with np.load(os.path.join(d, "shard_0.npz")) as z:
        flat = {k: z[k] for k in manifest["keys"]}
    placed = _flatten(shardings) if shardings is not None else {}
    if device is not None:
        dev = resolve_device(device)
        flat = {k: v if k in placed else torch.from_numpy(v).to(dev) for k, v in flat.items()}
    for k, (mesh, placements) in placed.items():
        from torch.distributed.tensor import distribute_tensor

        whole = torch.from_numpy(flat[k]).to(resolve_device(mesh.device_type))
        flat[k] = distribute_tensor(whole, mesh, list(placements), src_data_rank=None)
    return manifest["step"], _unflatten(flat)
