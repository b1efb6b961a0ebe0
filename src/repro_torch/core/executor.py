"""Multi-job executor: one shallow FHE job per cluster affiliation.

The paper's scheduler runs one shallow job on each cluster affiliation.  The
reference package maps an affiliation to a device group of a ``shard_map``
mesh; on one H100 the counterpart is a CUDA stream.  ``parallel_shallow_mul``
gives each affiliation its own stream and issues the jobs of each affiliation
in order on it, from one host thread: the kernels launch on the current stream
(``kernels.cuda.CudaKernel.launch``), and the dispatch counter stays exact
because one thread issues every launch.  On the CPU, which the caller asks for
with ``device="cpu"``, the affiliations run one after another.

Stream hazards, and what this module does about each:

  * device tables (NTT twiddles, Montgomery constants, BConv tables, per-limb
    columns, the rescale's moduli) are built lazily, complete before their
    builder returns, and never freed (``kernels.tables``), so a side stream may
    build one that another stream then reads;
  * each side stream waits for the caller's stream before it reads the jobs'
    inputs;
  * the caller's stream waits for every side stream before returning, and
    each output is recorded on the caller's stream, so the caching allocator
    hands out no output's block again while the caller may still read it.

``affiliation_mesh`` and ``lower_multi_job_step`` are the reference's
lowering dry run: one affiliation's body (its jobs' ``ctx.mul`` under the
reference's "ref" backend) traced by ``make_fx`` on fake inputs, the local
shard of the ("aff",)-sharded stacked jobs, into a ``GraphModule`` without
running it.  It is traced on the CPU, where "ref" runs the plain versions
(aten operations a trace records; a card's kernels launch through ctypes,
which it cannot); ``place_graph`` moves the graph to a card, where it runs
on real inputs and launches none of the Hopper kernels.
"""

from __future__ import annotations

import collections
import contextlib

import torch

from repro_torch.fhe import ops
from repro_torch.fhe.context import ExecPolicy, FheContext
from repro_torch.fhe.keys import KeySet
from repro_torch.fhe.params import CkksParams

N_AFFILIATIONS = 8  # FLASH-FHE's clusters form 8 affiliations


def affiliation_streams(n_groups: int = N_AFFILIATIONS, device="cuda") -> list[torch.cuda.Stream | None]:
    """One CUDA stream per affiliation on ``device``; on the CPU, ``n_groups``
    lanes with no stream (they run one after another)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [None] * n_groups
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"affiliation streams on {dev} need a CUDA card; pass device='cpu' for the CPU")
    return [torch.cuda.Stream(device=dev) for _ in range(n_groups)]


def parallel_shallow_mul(
    params: CkksParams,
    keys: KeySet,
    pairs: list[tuple[ops.Ciphertext, ops.Ciphertext]],
    affiliations: list[torch.cuda.Stream | None] | None = None,
    device="cuda",
) -> list[ops.Ciphertext]:
    """One homomorphic multiplication (rescale included) per job, the jobs
    split over ``affiliations`` (``affiliation_streams``; by default 8).  Job j
    runs on affiliation j // (jobs / affiliations), as the reference's
    ``P("aff")`` splits its stacked job axis.  The policy is the reference's,
    ``ExecPolicy(backend="ref")``: the staged pipeline."""
    ctx = FheContext(params=params, keys=keys, policy=ExecPolicy(backend="ref"), device=device)
    if affiliations is None:
        affiliations = affiliation_streams(device=ctx.device)
    n_jobs, n_aff = len(pairs), len(affiliations)
    if n_jobs == 0 or n_jobs % n_aff:
        raise ValueError(f"{n_jobs} jobs must tile {n_aff} affiliations")
    level, scale = pairs[0][0].level, pairs[0][0].scale
    for a, b in pairs:
        if not (a.level == b.level == level and a.scale == b.scale == scale):
            raise ValueError("every job must share one level and one scale")
    per = n_jobs // n_aff
    on_card = ctx.device.type == "cuda"
    if on_card:
        caller = torch.cuda.current_stream(pairs[0][0].c0.device)
    outs = []
    for i, stream in enumerate(affiliations):
        if on_card:
            stream.wait_stream(caller)
        with torch.cuda.stream(stream) if on_card else contextlib.nullcontext():
            outs += [ctx.mul(a, b) for a, b in pairs[i * per : (i + 1) * per]]
    if on_card:
        for stream in affiliations:
            caller.wait_stream(stream)
        for out in outs:
            out.c0.record_stream(caller)
            out.c1.record_stream(caller)
    out_scale = scale * scale / float(params.q_primes[level])
    return [ops.Ciphertext(o.c0, o.c1, level - 1, out_scale) for o in outs]


def affiliation_mesh(n_groups: int = N_AFFILIATIONS, device_type: str = "cuda", *, fake: bool = False):
    """1-D ("aff",) ``DeviceMesh``: one rank per affiliation, over the running
    process group, or with ``fake`` over a fake one of ``n_groups`` ranks
    (``launch.mesh.make_mesh``): the lowering reads only its names and size."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh((n_groups,), ("aff",), device_type, fake=fake)


def lower_multi_job_step(params: CkksParams, keys: KeySet, mesh, jobs_per_aff: int = 1):
    """Lower (without executing) the multi-job step for dry-run analysis:
    one affiliation's body — ``ctx.mul`` (rescale included) of each of its
    ``jobs_per_aff`` jobs at the top level, backend "ref" — traced by
    ``make_fx`` on fake (jobs_per_aff, L+1, n) int32 residues on the keys'
    device, the local shard of the four ("aff",)-sharded
    (mesh.size()·jobs_per_aff, L+1, n) inputs a0, a1, b0, b1.

    Returns (GraphModule, {op: count}); the module maps (a0, a1, b0, b1) to
    the stacked (c0, c1) of the jobs.  The keys and the device tables are
    constants of the graph.  ``keys`` live on the CPU (see the module's
    docstring)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    if tuple(mesh.mesh_dim_names) != ("aff",):
        raise ValueError(f"the multi-job step lowers over an ('aff',) mesh, not {mesh.mesh_dim_names}")
    device = keys.rlk.k.device
    if device.type != "cpu":
        raise ValueError(f"lower the multi-job step on CPU keys, not {device}; place_graph moves the graph")
    level, scale = params.L, params.scale
    ctx = FheContext(params=params, keys=keys, policy=ExecPolicy(backend="ref"), device=device)

    def body(a0s, a1s, b0s, b1s):
        outs0, outs1 = [], []
        for j in range(a0s.shape[0]):
            out = ctx.mul(ops.Ciphertext(a0s[j], a1s[j], level, scale), ops.Ciphertext(b0s[j], b1s[j], level, scale),
                          rescale_after=True)
            outs0.append(out.c0)
            outs1.append(out.c1)
        return torch.stack(outs0), torch.stack(outs1)

    # one eager job on zeros first: it builds (or finds) every table the body
    # reads, so the trace finds them all cached and caches no fake tensor
    body(*[torch.zeros((1, level + 1, params.n), dtype=torch.int32, device=device)] * 4)
    shape = (jobs_per_aff, level + 1, params.n)
    local = [torch.empty(shape, dtype=torch.int32, device=device) for _ in range(4)]
    gm = make_fx(body, tracing_mode="fake", _allow_non_fake_inputs=True)(*local)
    counts = collections.Counter(str(n.target) for n in gm.graph.nodes if n.op == "call_function")
    return gm, dict(counts)


def place_graph(gm, device):
    """``gm`` (``lower_multi_job_step``'s graph) on ``device``: its constants
    moved there, and every operation that makes a tensor on the CPU makes it
    there instead."""
    dev = torch.device(device)
    for node in gm.graph.nodes:
        if node.op == "call_function" and isinstance(node.kwargs.get("device"), torch.device):
            node.kwargs = {**node.kwargs, "device": dev}
    gm.recompile()
    return gm.to(dev)
