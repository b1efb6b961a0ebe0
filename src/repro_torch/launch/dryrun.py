"""Multi-pod dry-run: one step of every (arch × shape × mesh) cell on a fake mesh.

Proves the distribution config is coherent without hardware: a step that
runs on the 16×16 (single-pod) and 2×16×16 (multi-pod) meshes means the
placements, the collectives and the per-rank memory are valid.  The mesh
lives on torch's ``fake`` process group (``launch.mesh``): this process is
rank 0 of 256 or 512, every collective returns at once.  The parameters,
the AdamW state and the inputs are DTensors of fake tensors
(``FakeTensorMode``: shapes and dtypes, no memory), placed by the
reference's specs; the train, prefill or decode step runs on them under
``FlopCounterMode`` (DTensor operations counted at their global shapes,
once) and ``roofline.analysis.CollectiveRecorder`` (each collective at rank
0's local result size).  Emits per-cell JSON in the reference's schema:
collectives, memory, and the three-term roofline, whose constants are one
H100's (``core.hardware``) — a model of the reference's TPU pod mesh with
H100 numbers, not a measurement.

The reference compiles with XLA, whose cost analysis counts a while-loop
body once, and rebuilds exact costs from unrolled probe lowerings.  The
port's layers run in Python loops, so every layer's operations are counted
as they run: there are no probes (``--no-probes`` is accepted and changes
nothing), and the port has no counterpart of ``models/scan_util.py``, which
only the probes use.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry
from repro_torch.models.lm import ParamTree
from repro_torch.models.registry import SHAPES
from repro_torch.roofline import analysis as roofl
from repro_torch.roofline import memory_model as mem_model
from repro_torch.training import optimizer as opt, train_step as ts

ORDER = ("smollm-135m", "phi3-medium-14b", "granite-20b", "qwen1.5-110b",
         "phi-3-vision-4.2b", "whisper-medium", "deepseek-moe-16b",
         "moonshot-v1-16b-a3b", "mamba2-1.3b", "hymba-1.5b")


def _local_bytes(tree) -> int:
    """Rank 0's bytes of a tree's DTensor (or plain) leaves."""
    total = 0
    for x in opt.tree_leaves(tree):
        local = x.to_local() if sh.is_dtensor(x) else x
        total += local.numel() * local.element_size()
    return total


def _fake_inputs(inputs: dict, mesh, device) -> tuple[dict, dict]:
    """Fake tensors of ``input_specs``' shapes and dtypes, placed by their
    sanitised specs; and those specs."""
    specs = {k: sh.sanitize_spec(spec, shape, mesh) for k, ((shape, _), spec) in inputs.items()}
    vals = {k: sh.distribute(torch.zeros(shape, dtype=dtype, device=device), mesh, specs[k])
            for k, ((shape, dtype), _) in inputs.items()}
    return vals, specs


def lower_cell(arch: str, shape_name: str, multi_pod: bool, with_probes: bool = True,
               device_type: str = "cpu", memory: bool = True) -> dict:
    """One cell's record.  ``with_probes`` is the reference's argument and
    changes nothing here (no probes: every layer's operations are counted)."""
    cfg = configs.get_config(arch)
    return lower(cfg, shape_name, multi_pod, device_type, memory)


def lower(cfg, shape_name: str, multi_pod: bool, device_type: str = "cpu", memory: bool = True) -> dict:
    """``lower_cell`` of a config (a full one, or a cut one in tests).  With
    ``memory`` the step runs a second time under ``MemTracker`` alone for
    rank 0's peak bytes: stacked with the other dispatch modes it counts
    DTensor results at their global size, and on the first pass it counts
    the global-shape tensors of DTensor's sharding propagation (cached by
    the second).  Without, the record says the peak was not measured."""
    api = registry.build(cfg)
    rec = {
        "arch": cfg.arch_id, "shape": shape_name,
        "mesh": "pod2x16x16" if multi_pod else "16x16",
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "device_type": device_type,
    }
    ok, reason = api.supports_shape(shape_name)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type, fake=True)
    chips = mesh.size()
    rec["chips"] = chips
    info = SHAPES[shape_name]
    kind = info["kind"]
    dev = torch.device(device_type)
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        tree = opt.tree_map(lambda x: x.to(dev), api.init_tree(0))
        pspecs = sh.sanitize_tree(api.param_specs(mesh), tree, mesh)
        params = ParamTree(sh.distribute_tree(tree, mesh, pspecs))
        del tree
        inputs, in_specs = _fake_inputs(api.input_specs(shape_name, mesh), mesh, dev)
        if kind == "train":
            state = opt.init_state(params)
            state = sh.distribute_tree(state, mesh, opt.state_specs(pspecs))
            step = ts.jit_train_step(api, mesh, opt.AdamWConfig(), in_specs)
            run = lambda: step(params, state, inputs)
            args = (params, state, inputs)
            tokens = info["batch"] * info["seq"]
        else:
            cache = opt.tree_map(lambda x: x.to(dev), api.init_cache(info["batch"], info["seq"], device="cpu"))
            cache = sh.distribute_tree(cache, mesh, sh.sanitize_tree(api.cache_specs(mesh), cache, mesh))
            if kind == "prefill":
                run = lambda: api.prefill(params, cache, mesh=mesh, **inputs)
                tokens = info["batch"] * info["seq"]
            else:
                run = lambda: api.decode_step(params, inputs["token"], cache, mesh=mesh)
                tokens = info["batch"]  # one new token per sequence
            args = (params, cache, inputs)
        rec["memory"] = {"argument_bytes": sum(_local_bytes(a) for a in args)}
        recorder = roofl.CollectiveRecorder()
        # the recorder outside the counter: the counter then sees each DTensor
        # operation once, at its global shape, and none of the local ones
        with recorder, FlopCounterMode(display=False) as flop_counter:
            run()
        rec["lower_s"] = round(time.time() - t0, 2)
        if memory:
            from torch.distributed._tools.mem_tracker import MemTracker

            tracker = MemTracker()
            with tracker:
                run()
            rec["memory"]["bytes_per_device"] = int(sum(
                snap["Total"] for snap in tracker.get_tracker_snapshot("peak").values() if "Total" in snap))
            rec["memory_pass_s"] = round(time.time() - t0 - rec["lower_s"], 2)
        else:
            rec["memory"]["bytes_per_device_absent"] = "not measured: lower(memory=False) ran no MemTracker pass"

    model_flops = roofl.model_flops_per_step(cfg.param_count(), cfg.active_param_count(), tokens,
                                             "train" if kind == "train" else "serve")
    flops = float(flop_counter.get_total_flops())
    coll = roofl.collective_bytes_of(recorder)
    coll_total = float(coll["total_bytes"]) * chips  # rank 0's bytes → every rank's
    hbm = mem_model.hbm_bytes(cfg, kind, info["batch"], info["seq"])
    rl = roofl.roofline_terms(flops, hbm, coll_total, chips)
    rec.update(
        status="ok",
        flops=flops, hbm_bytes=hbm,
        collectives=coll,
        coll_bytes_total=coll_total,
        roofline=rl.to_dict(),
        model_flops=model_flops,
        useful_flops_ratio=(model_flops / flops) if flops else None,
    )
    return rec


def main(argv=None) -> int:
    """The sweep's command line; returns 1 if a cell failed, else 0."""
    ap = argparse.ArgumentParser(description="Dry-run of the sharded steps on a fake 16×16 or 2×16×16 mesh.")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-probes", action="store_true",
                    help="accepted for the reference's command line; changes nothing (the port needs no probes)")
    ap.add_argument("--policy", default="tp", choices=("tp", "dp"),
                    help="sharding policy (perf hillclimb knob)")
    ap.add_argument("--block-skip", action="store_true",
                    help="causal block skipping in flash attention (hillclimb)")
    ap.add_argument("--tag", default="", help="suffix for output files")
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    # cheap archs first so the table fills up early
    archs = [a for a in ORDER if a in configs.ARCH_IDS] if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    os.makedirs(args.out_dir, exist_ok=True)

    from repro_torch.models.layers import causal_block_skipping

    knobs = contextlib.ExitStack()
    if args.policy != "tp":
        knobs.enter_context(sh.policy(args.policy))
    if args.block_skip:
        knobs.enter_context(causal_block_skipping())
    suffix = args.tag or ""
    if args.policy != "tp":
        suffix += f"_{args.policy}"
    if args.block_skip:
        suffix += "_skip"

    failures = 0
    with knobs:
        for arch in archs:
            for shape in shapes:
                tag = f"{arch}_{shape}_{'pod2' if args.multi_pod else 'pod1'}{suffix}"
                out_path = os.path.join(args.out_dir, tag + ".json")
                if os.path.exists(out_path):
                    print(f"[dryrun] {tag}: cached")
                    continue
                print(f"[dryrun] {tag}: running...", flush=True)
                try:
                    rec = lower_cell(arch, shape, args.multi_pod, with_probes=not args.no_probes)
                    rec["policy"] = args.policy
                    rec["block_skip"] = args.block_skip
                except Exception as e:  # the sweep goes on; the record says what failed
                    rec = {"arch": arch, "shape": shape, "status": "FAILED",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    failures += 1
                with open(out_path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    print(f"[dryrun] {tag}: ok run={rec['lower_s']}s "
                          f"compute={r['compute_s']:.2e}s memory={r['memory_s']:.2e}s "
                          f"collective={r['collective_s']:.2e}s dom={r['dominant']}", flush=True)
                else:
                    print(f"[dryrun] {tag}: {rec['status']} "
                          f"{rec.get('reason', rec.get('error', ''))}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
