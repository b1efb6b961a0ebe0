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
    columns, the rescale's moduli) are built lazily and cached per device;
    ``_upload_tables`` builds every one a staged multiply reads on the
    caller's stream before the fan-out, so no side stream creates a table
    that another reads;
  * each side stream waits for the caller's stream before it reads the jobs'
    inputs;
  * the caller's stream waits for every side stream before returning, and
    each output is recorded on the caller's stream, so the caching allocator
    hands out no output's block again while the caller may still read it.

The reference's ``lower_multi_job_step``, a JAX lowering dry run, has no
counterpart here.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.fhe import keyswitch, ops, poly
from repro_torch.fhe.context import ExecPolicy, FheContext
from repro_torch.fhe.keys import KeySet
from repro_torch.fhe.params import CkksParams
from repro_torch.kernels.bconv import ops as bconv_ops
from repro_torch.kernels.modops import ops as modops
from repro_torch.kernels.ntt import ops as ntt_ops

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


def _upload_tables(params: CkksParams, level: int, device: torch.device) -> None:
    """Build, on the current stream, every device table that a staged
    ``ctx.mul`` (rescale included) at ``level`` reads from the caches."""
    q, ext, p = poly.q_idx(params, level), poly.ext_idx(params, level), poly.p_idx(params)
    for idx in (q, ext, p, (level,), poly.q_idx(params, level - 1)):
        ntt_ops.kernel_tables(poly.plan_for(params, idx), len(idx), device)
    moduli = [poly.primes_for(params, idx) for idx in (q, ext, p, poly.q_idx(params, level - 1))]
    for j in range(params.beta(level)):
        digit_idx, bhat_inv, w, dst = keyswitch._digit_tables(params, level, j)
        moduli.append(poly.primes_for(params, digit_idx))
        keyswitch._limb_column(tuple(int(c) for c in bhat_inv), device)
        bconv_ops._table(np.ascontiguousarray(np.asarray(w, np.uint64)).tobytes(), len(digit_idx),
                         tuple(int(c) for c in dst), device)
    bhat_inv, w, q_primes, pinv = keyswitch._moddown_tables(params, level)
    for consts in (bhat_inv, pinv):
        keyswitch._limb_column(tuple(int(c) for c in consts), device)
    bconv_ops._table(np.ascontiguousarray(np.asarray(w, np.uint64)).tobytes(), params.alpha,
                     tuple(int(c) for c in q_primes), device)
    for qs in moduli:
        modops._constants(tuple(int(c) for c in qs), device)
    ops._rescale_tables(int(params.q_primes[level]), ops._qs(params, level - 1), device)


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
        dev = pairs[0][0].c0.device  # the caches key on the tensors' device, index included
        caller = torch.cuda.current_stream(dev)
        _upload_tables(params, level, dev)
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
