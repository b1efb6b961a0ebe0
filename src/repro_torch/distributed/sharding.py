"""Sharding rules for the multi-pod mesh, as DTensor placements.

Logical mesh axes:
  pod    — cross-pod pure data parallelism (gradient all-reduce, compressible)
  data   — in-pod data parallel + FSDP (weights/optimizer sharded over it)
  model  — tensor/expert/sequence parallel

Divisibility-aware rules: a tensor dim is sharded on an axis only when the
axis size divides it — configs like hymba (25 heads) or vocab 32001 fall back
to the next-best layout instead of failing.

A ``Spec`` is the reference's ``PartitionSpec``: one entry per tensor dim,
None, an axis name or a tuple of axis names.  The rules read a mesh's axis
sizes from a ``DeviceMesh`` (``mesh_dim_names``, ``size(i)``) or from any
object whose ``.shape`` maps axis names to sizes, so they run without a
process group.  ``placements`` turns a spec into DTensor placements: a mesh
dim named in a tensor dim's entry is ``Shard(that dim)``, any other mesh dim
``Replicate()``.

Placement rules.  XLA's partitioner shards every op of the reference;
DTensor shards an op only where it has a strategy, and torch 2.11 has fewer
than 2.13.  Where it has none, or one that fails on these programs, a rule
below says what runs (each a real collective where its input is sharded,
which the dry-run's collective bytes count):

  * ``sharded_run`` — tensors the model makes itself (positions, masks,
    zeros) are read as replicated (DTensor's ``implicit_replication``);
  * ``Gathered`` — weights whole over the data axes at each use (FSDP);
  * ``gather_rows`` — the embedding lookup on a vocab-sharded table: the
    table gathered, each rank's tokens looked up locally;
  * ``take_gold`` — the cross-entropy's gold logit, row by row locally
    (``take_along_dim`` on vocab-sharded logits has no strategy);
  * ``TokenRows`` — the MoE routing, dispatch and combine on each rank's
    own tokens, with the one-device capacity positions (``bincount`` and the
    dispatch's ``index_put`` have none): the buffer reduce-scattered to the
    expert products, their output all-gathered back;
  * ``pad``, ``along`` and ``write_slot`` — ``F.pad``, the SSD scan's
    ``cumsum`` (its backward's ``flip``) and the decode cache write
    (``index_copy_``), shard by shard: torch 2.11 has no working strategy;
  * ``placements`` — a mesh dim of size 1 is ``Replicate()``;
  * the models' own ``constrain`` sites beside the reference's: q/k/v whole
    over 'model' before the heads split (a head count the axis does not
    divide gives strided shards), a row-parallel product's input whole, the
    decode attention output whole, the mixer's output reduced before the
    residual add.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple

import torch

# Sharding policy:
#   "tp"  — default: tensor-parallel over 'model', FSDP over 'data'
#   "dp"  — pure data parallel: batch over every mesh axis, weights FSDP over
#           ('data','model'); right for small models whose TP all-gathers
#           dominate
_POLICY: contextvars.ContextVar[str] = contextvars.ContextVar("shard_policy", default="tp")


class Spec(tuple):
    """A partition spec: ``Spec("data", None, ("pod", "data"))``, one entry
    per leading tensor dim (missing trailing entries are None).  As JAX's
    ``PartitionSpec``, an entry of one axis is that axis's name and an empty
    entry is None."""

    def __new__(cls, *parts):
        norm = lambda p: (p[0] if len(p) == 1 else p or None) if isinstance(p, tuple) else p
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


@contextlib.contextmanager
def policy(name: str):
    if name not in ("tp", "dp"):
        raise ValueError(f"unknown sharding policy {name!r}: 'tp' or 'dp'")
    tok = _POLICY.set(name)
    try:
        yield
    finally:
        _POLICY.reset(tok)


def current_policy() -> str:
    return _POLICY.get()


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of anything with such a ``.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def dp_axes(mesh) -> tuple[str, ...]:
    """Batch-sharding axes: ('pod', 'data') when multi-pod; under the pure-DP
    policy the 'model' axis carries batch too."""
    names = ("pod", "data", "model") if _POLICY.get() == "dp" else ("pod", "data")
    shape = mesh_shape(mesh)
    return tuple(a for a in names if a in shape)


def divisible(dim: int, mesh, *axes: str) -> bool:
    total = 1
    for a in axes:
        total *= axis_size(mesh, a)
    return dim % total == 0


def weight_spec(mesh, shape: tuple[int, ...], tp_dim: int | None, fsdp_dim: int | None) -> Spec:
    """Spec for a weight: tensor-parallel on `tp_dim`, FSDP on `fsdp_dim`.

    Falls back to replication per-dim when sizes don't divide.  Under the
    pure-DP policy nothing is tensor-parallel; FSDP spans ('data','model').
    """
    parts: list = [None] * len(shape)
    if _POLICY.get() == "dp":
        if fsdp_dim is None:
            fsdp_dim = tp_dim
        if fsdp_dim is not None:
            if divisible(shape[fsdp_dim], mesh, "data", "model"):
                parts[fsdp_dim] = ("data", "model")
            elif divisible(shape[fsdp_dim], mesh, "data"):
                parts[fsdp_dim] = "data"
        return Spec(*parts)
    if tp_dim is not None and divisible(shape[tp_dim], mesh, "model"):
        parts[tp_dim] = "model"
    if fsdp_dim is not None and fsdp_dim != tp_dim and \
            divisible(shape[fsdp_dim], mesh, "data"):
        parts[fsdp_dim] = "data"
    return Spec(*parts)


def batch_spec(mesh, ndim: int, seq_axis: int | None = None, shard_seq: bool = False) -> Spec:
    """Activations: batch dim over ('pod','data'); optionally seq over 'model'."""
    parts: list = [None] * ndim
    parts[0] = dp_axes(mesh) or None
    if shard_seq and seq_axis is not None:
        parts[seq_axis] = "model"
    return Spec(*parts)


def sanitize_spec(spec, shape: tuple[int, ...], mesh) -> Spec:
    """Drop any axis assignment that doesn't divide its dimension."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, part in zip(shape, parts):
        if part is None:
            out.append(None)
            continue
        axes = part if isinstance(part, tuple) else (part,)
        total = 1
        for a in axes:
            total *= axis_size(mesh, a)
        out.append(part if dim % total == 0 else None)
    return Spec(*out)


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def spec_map(fn, spec_tree, *rest):
    """``fn`` over the specs of ``spec_tree`` (a nested dict / per-layer list
    of ``Spec``s) and the leaves at the same places in ``rest``."""
    if is_spec(spec_tree):
        return fn(spec_tree, *rest)
    if isinstance(spec_tree, dict):
        return {k: spec_map(fn, v, *(r[k] for r in rest)) for k, v in spec_tree.items()}
    return [spec_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(spec_tree)]


def sanitize_tree(spec_tree, struct_tree, mesh):
    """sanitize_spec over matching (spec, tensor-or-shaped) trees."""
    return spec_map(lambda s, x: sanitize_spec(s, tuple(x.shape), mesh), spec_tree, struct_tree)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


class Named(NamedTuple):
    """The port's ``NamedSharding``: a mesh and one placement per mesh dim."""

    mesh: object
    placements: tuple


def placements(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: mesh dim i is
    ``Shard(d)`` where tensor dim d's entry names it, else ``Replicate()``.

    A tensor dim over several axes is split major-to-minor in the entry's
    order, as JAX splits it; DTensor splits it in mesh-dim order, so the
    entry must list its axes in the mesh's order.  A mesh dim of size 1 is
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: dim {d} lists its axes {axes} out of the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]!r} shards two dims")
            out[i] = Shard(d)
    # a 1-way shard is the whole tensor: Replicate() says so to every DTensor strategy
    return tuple(Replicate() if mesh.size(i) == 1 else p for i, p in enumerate(out))


def named(mesh, spec) -> Named:
    return Named(mesh, placements(spec, mesh))


def tree_shardings(mesh, spec_tree):
    return spec_map(lambda s: named(mesh, s), spec_tree)


def distribute(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """``x`` placed by ``spec`` on ``mesh``: a DTensor redistributed, a plain
    tensor (the whole value, the same on every rank) cut into its shards."""
    if is_dtensor(x):
        return x.detach().redistribute(mesh, placements(spec, mesh))
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x.detach(), mesh, placements(spec, mesh), src_data_rank=None)


def distribute_tree(tree, mesh, spec_tree):
    """Every leaf of ``tree`` (a ``ParamTree``, dict, per-layer list or
    tensor) distributed by the spec at its place; a ``ParamTree`` gives a
    ``ParamTree`` of DTensor parameters."""
    from repro_torch.models.lm import ParamTree
    from repro_torch.training.optimizer import tree_map

    out = tree_map(lambda x, s: distribute(x, mesh, s), tree, spec_tree)
    return ParamTree(out) if isinstance(tree, ParamTree) else out


def constrain(x, mesh, spec):
    """``x`` redistributed to ``spec``'s placements; a no-op on a one-device
    mesh, as the reference's ``with_sharding_constraint`` off-mesh."""
    if mesh.size() == 1:
        return x
    if not is_dtensor(x):
        x = as_replicated(x, mesh)
    return x.redistribute(mesh, placements(spec, mesh))


def replicate(x: torch.Tensor) -> torch.Tensor:
    """A DTensor redistributed to ``Replicate()`` on every mesh dim (a
    collective where it is sharded or partial); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, placements(Spec(), x.device_mesh))


def as_replicated(x: torch.Tensor, mesh):
    """``x``, the same local tensor on every rank, as a replicated DTensor on
    ``mesh``; ``x`` itself where ``mesh`` is None."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


class TokenRows:
    """The MoE dispatch's rule, for (T, d) DTensor tokens ``x`` and expert
    weights ``w`` (E, ...).  Each rank routes its own rows: the mesh dims
    that shard x's dim 0 (the token dims) keep it sharded, the others
    ('model' among them) hold the rows whole.  The capacity positions stay
    the one-device ones, global in token order, through ``before``: the
    entries of each expert on the ranks before this one (an all-gather of E
    counts a rank).  ``bincount`` and the dispatch's ``index_put`` have no
    DTensor strategy, so the routing runs on local tensors between ``local``
    and ``place``.

    Each rank scatters its tokens' entries for its own experts (``e0`` and
    ``ne``: its range on the mesh dims that shard w's dim 0, the expert
    dims) into an (ne, C, d) buffer; ``summed`` reduce-scatters it over the
    token dims along C (each slot holds one token: the sum adds zeros); the
    expert products run on DTensors; ``whole`` all-gathers their output over
    the token dims only; each rank combines its tokens from its experts, and
    ``place`` sums that over the expert dims.  A gradient that a rank holds
    for its own tokens or experts is declared partial over those dims."""

    def __init__(self, x: torch.Tensor, w: torch.Tensor):
        from torch.distributed.tensor import Partial, Replicate, Shard

        self.mesh, self.n, self.e = x.device_mesh, x.shape[0], w.shape[0]
        nd = self.mesh.ndim
        tok = [i for i, p in enumerate(x.placements) if type(p) is Shard and p.dim == 0]
        wpl = w.placements if is_dtensor(w) else (Replicate(),) * nd
        exp = [i for i, p in enumerate(wpl) if type(p) is Shard and p.dim == 0 and i not in tok]
        self.tokens_sharded = bool(tok)

        def pl(on_tok, on_exp):
            return tuple(on_tok if i in tok else on_exp if i in exp else Replicate() for i in range(nd))

        self.pl = pl(Shard(0), Replicate())  # this rank's rows, whole along the other dims
        self.x_grad, self.w_grad = pl(Shard(0), Partial()), pl(Partial(), Partial())
        self.buf, self.by_slot = pl(Partial(), Shard(0)), pl(Shard(1), Shard(0))
        self.col, self.col_grad = pl(Replicate(), Shard(0)), pl(Partial(), Shard(0))
        self.out = pl(Shard(0), Partial())
        self.e0, self.ne = _shard_range(self.e, self.mesh, pl(Replicate(), Shard(0)), 0)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x``, whole along the other dims."""
        return x.redistribute(self.mesh, self.pl).to_local(grad_placements=self.x_grad)

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """``w`` (the router) whole on this rank."""
        return replicate(w).to_local(grad_placements=self.w_grad)

    def before(self, counts: torch.Tensor):
        """``counts`` (this rank's entries per expert) summed over the ranks
        that hold earlier rows; None where the rows are not sharded."""
        if not self.tokens_sharded:
            return None
        from torch.distributed.tensor import Shard

        # DTensor splits a dim over several mesh dims major-to-minor in mesh order
        coord, me, n = self.mesh.get_coordinate(), 0, 1
        for i, p in enumerate(self.pl):
            if p == Shard(0):
                me, n = me * self.mesh.size(i) + coord[i], n * self.mesh.size(i)
        every = _local_like(counts[None], self.mesh, self.pl, (n, counts.shape[0])).full_tensor()
        return every[:me].sum(0)

    def summed(self, buf: torch.Tensor) -> torch.Tensor:
        """The ranks' (ne, C, d) buffers of their experts, summed over the
        token dims: an (E, C, d) DTensor sharded along C over the token dims
        and along E over the expert dims."""
        return _local_like(buf, self.mesh, self.buf, (self.e, *buf.shape[1:])).redistribute(self.mesh, self.by_slot)

    def whole(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's experts of ``y`` (E, C, d), whole along C."""
        return y.redistribute(self.mesh, self.col).to_local(grad_placements=self.col_grad)

    def place(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the routed output (its experts' share) summed
        over the expert dims, as a DTensor placed as ``local``'s input."""
        return _local_like(y, self.mesh, self.out, (self.n, *y.shape[1:])).redistribute(self.mesh, self.pl)

    def place_rows(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's rows ``y`` (equal over the other dims) as a DTensor."""
        return _local_like(y, self.mesh, self.pl, (self.n, *y.shape[1:]))


class Gathered:
    """A read-only view of a parameter tree whose DTensor leaves are
    all-gathered over the data-parallel axes ("pod", "data", and "model"
    under the "dp" policy) at each read — FSDP: weights are stored sharded
    over those axes and whole along them where they are used, their
    gradients come back as reduce-scatters.  Shards over "model" (tensor
    and expert parallelism) stay.  Read as the tree: ``p["attn"]["wqkv"]``,
    ``"bqkv" in p``, ``p.get("sw1")``; a per-layer list reads as a list of
    views."""

    def __init__(self, tree, mesh):
        self._tree, self._mesh = tree, mesh
        self._axes = set(dp_axes(mesh)) | {"data"}

    def _wrap(self, v):
        if isinstance(v, torch.Tensor):
            if not is_dtensor(v):
                return v
            from torch.distributed.tensor import Replicate

            names = v.device_mesh.mesh_dim_names
            pl = [Replicate() if names[i] in self._axes else p for i, p in enumerate(v.placements)]
            return v if list(pl) == list(v.placements) else v.redistribute(v.device_mesh, pl)
        if isinstance(v, (list, tuple, torch.nn.ModuleList)):
            return [Gathered(t, self._mesh) for t in v]
        return Gathered(v, self._mesh)

    def __getitem__(self, k):
        return self._wrap(self._tree[k])

    def __contains__(self, k) -> bool:
        return k in self._tree

    def get(self, k, default=None):
        return self[k] if k in self else default

    def keys(self):
        return self._tree.keys()


def pad(x: torch.Tensor, pads: tuple, value: float = 0.0) -> torch.Tensor:
    """``F.pad(x, pads, value=value)``; a DTensor is padded shard by shard
    (its padded dims replicated first), with its placements kept — DTensor's
    own pad strategy in torch 2.11 drops every placement but one on a mesh of
    more than one dim."""
    import torch.nn.functional as F

    if not is_dtensor(x):
        return F.pad(x, pads, value=value)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    padded = {x.ndim - 1 - i // 2 for i, p in enumerate(pads) if p}
    pl = [Replicate() if isinstance(p, Shard) and p.dim in padded else p for p in x.placements]
    x = x.redistribute(x.device_mesh, pl)
    shape = list(x.shape)
    for i in range(0, len(pads), 2):
        shape[x.ndim - 1 - i // 2] += pads[i] + pads[i + 1]
    stride, acc = [0] * len(shape), 1
    for d in reversed(range(len(shape))):
        stride[d], acc = acc, acc * shape[d]
    local = F.pad(x.to_local(), pads, value=value)
    return DTensor.from_local(local, x.device_mesh, pl, run_check=False, shape=torch.Size(shape), stride=tuple(stride))


def _local_like(local: torch.Tensor, mesh, pl, shape) -> torch.Tensor:
    """``local`` (this rank's shard) as a DTensor of global ``shape``."""
    from torch.distributed.tensor import DTensor

    stride, acc = [0] * len(shape), 1
    for d in reversed(range(len(shape))):
        stride[d], acc = acc, acc * shape[d]
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=torch.Size(shape), stride=tuple(stride))


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``.  On DTensors (the embedding lookup's rule): the table
    whole on every rank (an all-gather where it is sharded), each rank's own
    indices looked up locally, the rows placed as the indices are; the
    table's gradient is the partial sum over the ranks' tokens, reduced back
    into its placements."""
    if not is_dtensor(table) and not is_dtensor(idx):
        return table[idx]
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = (table if is_dtensor(table) else idx).device_mesh
    ipl = tuple(idx.placements) if is_dtensor(idx) else (Replicate(),) * mesh.ndim
    whole = replicate(table) if is_dtensor(table) else as_replicated(table, mesh)
    local = whole.to_local(grad_placements=[Partial() if isinstance(p, Shard) else Replicate() for p in ipl])
    rows = local[idx.to_local() if is_dtensor(idx) else idx]
    return _local_like(rows, mesh, ipl, (*idx.shape, *table.shape[1:]))


def take_gold(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_dim(logits, idx[..., None], -1)[..., 0]``: on DTensors (the
    cross-entropy's rule) the logits whole along the vocab, each rank's rows
    taken locally, placed as the logits' leading dims are."""
    if not is_dtensor(logits):
        return torch.take_along_dim(logits, idx[..., None], dim=-1)[..., 0]
    from torch.distributed.tensor import Replicate, Shard

    mesh = logits.device_mesh
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim in (-1, logits.ndim - 1) else p for p in logits.placements)
    logits = logits.redistribute(mesh, pl)
    idx = idx.redistribute(mesh, pl) if is_dtensor(idx) else idx
    local = torch.take_along_dim(logits.to_local(), (idx.to_local() if is_dtensor(idx) else idx)[..., None], dim=-1)
    return _local_like(local[..., 0], mesh, pl, tuple(logits.shape[:-1]))


def along(fn, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``fn(x)`` for a shape-keeping ``fn`` that mixes values only along
    ``dim``; a DTensor (whole along ``dim`` first) runs it shard by shard — the
    SSD scan's cumsum, whose backward's ``flip`` has no DTensor strategy in
    torch 2.11."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Replicate, Shard

    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim % x.ndim == dim % x.ndim else p for p in x.placements)
    x = x.redistribute(x.device_mesh, pl)
    return _local_like(fn(x.to_local()), x.device_mesh, pl, tuple(x.shape))


def _shard_range(size: int, mesh, pl, dim: int) -> tuple[int, int]:
    """(offset, length) of this rank's shard of a dim of ``size`` placed by
    ``pl``: DTensor cuts a dim as ``torch.chunk`` does, mesh dim by mesh dim."""
    from torch.distributed.tensor import Shard

    offset, coord = 0, mesh.get_coordinate()
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-size // mesh.size(i))
            offset += coord[i] * chunk
            size = max(0, min(chunk, size - coord[i] * chunk))
    return offset, size


def write_slot(cache: torch.Tensor, dim: int, slot: torch.Tensor, value: torch.Tensor) -> None:
    """``cache.index_copy_(dim, slot, value)`` (one slot).  On a DTensor cache
    (the decode write's rule) each rank writes its shard where the slot falls
    in the shard's range along ``dim``, and nowhere else."""
    if not is_dtensor(cache):
        cache.index_copy_(dim, slot, value)
        return
    mesh = cache.device_mesh
    local = cache.to_local()
    offset, _ = _shard_range(cache.shape[dim], mesh, cache.placements, dim % cache.ndim)
    pos = torch.arange(local.shape[dim], device=local.device) + offset
    at = (pos == (slot.to_local() if is_dtensor(slot) else slot)).view([-1 if d == dim else 1 for d in range(local.ndim)])
    v = value.redistribute(mesh, cache.placements).to_local() if is_dtensor(value) else value
    local.copy_(torch.where(at, v, local))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def sharded_run():
    """The context of a sharded entry point: plain tensors beside DTensors
    are read as replicated (``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()
