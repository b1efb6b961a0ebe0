"""The sharded train step (``training.train_step`` on a ``DeviceMesh``) against
the one-device step, on the CPU over gloo processes.

Four ranks on a (2, 2) ("data", "model") mesh run ``jit_train_step`` on the
SMOKE configs of ``smollm-135m`` and ``deepseek-moe-16b``: params, AdamW
moments and batch as DTensors by the reference's specs.  Against
``build_train_step(mesh=None)`` on the same weights and batch in this
process, within ``chip_smoke.TRAIN_TOL``: the loss and the gradient norm;
for the dense arch also each leaf's gradient (correlation) and the AdamW
update weight by weight (``chip_smoke.update_gap``).  The gap is bf16
rounding: a tensor-parallel product sums its partial results after rounding
them to bf16, where the one-device product rounds once.  In the MoE arch
that moves a few tokens across router near-ties (router probabilities move
by up to 9e-3, top-k margins are as small as 5e-5), and every gradient
after them: at bf16 it is held to the loss and the gradient norm, as phase
3j holds the SMOKE archs.  With f32 activations on both sides (``lm.BF16``
set to f32) no token crosses a tie, and the MoE arch is held leaf by leaf
as the dense one is: the expert-sharded products, the capacity positions of
``sharding.TokenRows`` and its dispatch buffer's reduce-scatter.

The same mesh serves: prefill and two decode steps of ``smollm-135m`` and
``hymba-1.5b`` (attention and SSD heads, a sliding-window KV cache) against
the one-device path, within ``chip_smoke.SMOKE_TOL``.

Two ranks on a (2, 1, 1) ("pod", "data", "model") mesh with
``compress_pods=True``: each pod's gradients and the step's weights equal,
bit for bit, ``build_train_step(mesh=None, compress_pods=True,
group=WORLD)`` run on each pod's half of the batch.

Workers are separate interpreters (a ``FileStore`` under the test's
directory, a 120 s timeout), as ``tests/test_torch_compress.py`` runs them.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.models import lm, registry
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ACFG = dict(lr_peak=3e-3, warmup_steps=5, total_steps=40)
BATCH, SEQ = 8, 32

WORKER = r"""
import datetime, json, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm, registry
from repro_torch.training import compress, optimizer as opt, train_step as ts

rank, world, io, arch, kind = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
acfg = opt.AdamWConfig(**json.loads(sys.argv[6]))
b, s = int(sys.argv[7]), int(sys.argv[8])
dist.init_process_group("gloo", store=dist.FileStore(io + "/store", world), rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120))
try:
    out = {}
    for dtype in sys.argv[9].split(","):  # f32: the embedding's cast, which every later op follows
        lm.BF16 = torch.float32 if dtype == "f32" else torch.bfloat16
        pre = "" if dtype == "bf16" else dtype + "/"
        cfg = configs.get_config(arch, smoke=True)
        api = registry.build(cfg)
        params = api.init_params(0, device="cpu")
        tokens = torch.from_numpy(pipeline.synthetic_lm_batch(0, 0, b, s, cfg.vocab))
        full = lambda x: x.full_tensor() if sh.is_dtensor(x) else x
        if kind == "tp":
            mesh = make_mesh((2, 2), ("data", "model"), "cpu")
            specs = {k: v[1] for k, v in api.input_specs("train_4k", mesh).items()}
            new, state, metrics = ts.jit_train_step(api, mesh, acfg, specs)(params, opt.init_state(params),
                                                                             {"tokens": tokens})
            dparams = sh.distribute_tree(params, mesh, api.param_specs(mesh))
            dtok = sh.distribute(tokens, mesh, specs["tokens"])
            _, grads = ts.loss_and_grads(api, dparams, {"tokens": dtok}, mesh=mesh)
            placed = all(m.placements == p.placements
                         for m, p in zip(opt.tree_leaves(state["m"]), opt.tree_leaves(new)))
            out[pre + "meta"] = json.dumps({"moments_placed_as_params": placed,
                                            "metrics_replicated": all(str(v.placements) == "(Replicate(), Replicate())"
                                                                      for v in metrics.values())})
        elif kind == "serve":  # prefill of 4 × 16 tokens and two decode steps
            mesh = make_mesh((2, 2), ("data", "model"), "cpu")
            dparams = sh.distribute_tree(params, mesh, api.param_specs(mesh))
            cache = api.init_cache(4, 32, device="cpu")
            cache = sh.distribute_tree(cache, mesh, sh.sanitize_tree(api.cache_specs(mesh), cache, mesh))
            prompt = tokens[:4, :16]
            logits, cache = api.prefill(dparams, cache, mesh=mesh,
                                        tokens=sh.distribute(prompt, mesh, sh.Spec("data")))
            steps = [full(logits)]
            for i in range(2):
                tok = sh.distribute(tokens[:4, 16 + i], mesh, sh.Spec("data"))
                logits, cache = api.decode_step(dparams, tok, cache, mesh=mesh)
                steps.append(full(logits))
            for i, x in enumerate(steps):
                out[pre + f"logits/{i}"] = x.numpy()
            for k, v in cache.items():
                out[pre + f"cache/{k}"] = full(v).float().numpy()
            grads, new = [], []
            metrics = {"loss": torch.zeros(()), "grad_norm": torch.zeros(()), "lr": torch.zeros(())}
        else:  # "pod": each pod's half of the batch, int8 over the pods
            mesh = make_mesh((2, 1, 1), ("pod", "data", "model"), "cpu")
            spec = sh.Spec(("pod", "data"))
            dparams = sh.distribute_tree(params, mesh, api.param_specs(mesh))
            dtok = sh.distribute(tokens, mesh, spec)
            with sh.sharded_run():
                _, grads = ts._pod_loss_and_grads(api, dparams, {"tokens": dtok}, 0, mesh)
            new, state, metrics = ts.jit_train_step(api, mesh, acfg, {"tokens": spec}, compress_pods=True)(
                params, opt.init_state(params), {"tokens": tokens})
            mine = tokens[rank * b // 2:(rank + 1) * b // 2]
            _, plain = ts.loss_and_grads(api, params, {"tokens": mine})
            want = compress.compressed_psum_mean(plain, dist.group.WORLD)
            step = ts.build_train_step(api, None, acfg, compress_pods=True, group=dist.group.WORLD)
            p_new, _, p_metrics = step(params, opt.init_state(params), {"tokens": mine})
            for i, leaf in enumerate(opt.tree_leaves(want)):
                out[pre + f"want_grads/{i}"] = leaf.numpy()
            for i, leaf in enumerate(opt.tree_leaves(p_new)):
                out[pre + f"plain_params/{i}"] = leaf.detach().numpy()
            out[pre + "plain_grad_norm"] = np.asarray(float(p_metrics["grad_norm"]))
        grads = [full(g) for g in opt.tree_leaves(grads)]
        new = [full(p).detach() for p in opt.tree_leaves(new)]
        metrics = {k: float(full(v)) for k, v in metrics.items()}
        if rank == 0 or kind == "pod":
            for i, g in enumerate(grads):
                out[pre + f"grads/{i}"] = g.numpy()
            for i, p in enumerate(new):
                out[pre + f"params/{i}"] = p.numpy()
            out[pre + "metrics"] = np.asarray([metrics["loss"], metrics["grad_norm"], metrics["lr"]])
    if rank == 0 or kind == "pod":
        np.savez(f"{io}/out_{rank}.npz", **out)
finally:
    dist.destroy_process_group()
"""


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(tmp_path, world: int, arch: str, kind: str, dtypes: str = "bf16") -> list[dict]:
    """Each rank's outputs; with ``dtypes`` "bf16,f32" the step runs again
    with f32 activations, its outputs under the prefix "f32/"."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(tmp_path), arch, kind,
                               json.dumps(ACFG), str(BATCH), str(SEQ), dtypes], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    outs = []
    for r in range(world):
        path = tmp_path / f"out_{r}.npz"
        if path.exists():
            with np.load(path) as z:
                outs.append({k: z[k] for k in z.files})
    return outs


def _one_device(arch: str):
    cfg = configs.get_config(arch, smoke=True)
    api = registry.build(cfg)
    params = api.init_params(0, device="cpu")
    tokens = torch.from_numpy(pipeline.synthetic_lm_batch(0, 0, BATCH, SEQ, cfg.vocab))
    acfg = opt.AdamWConfig(**ACFG)
    _, grads = ts.loss_and_grads(api, params, {"tokens": tokens})
    new, _, metrics = ts.build_train_step(api, None, acfg)(params, opt.init_state(params), {"tokens": tokens})
    return params, grads, new, metrics, acfg


def _hold_step(got, arch: str, leaf_by_leaf: bool) -> None:
    """The 2×2 step's outputs ``got`` against the one-device step, within
    ``chip_smoke.TRAIN_TOL``: loss and gradient norm; with ``leaf_by_leaf``
    also each leaf's gradient (correlation) and each weight's update."""
    smoke = _chip_smoke()
    tol = smoke.TRAIN_TOL
    meta = json.loads(str(got["meta"]))
    assert meta == {"moments_placed_as_params": True, "metrics_replicated": True}
    params, grads, new, metrics, acfg = _one_device(arch)
    w0 = [p.detach().numpy() for p in opt.tree_leaves(params)]
    ref_g = [g.numpy() for g in opt.tree_leaves(grads)]
    ref_p = [p.detach().numpy() for p in opt.tree_leaves(new)]
    got_g = [got[f"grads/{i}"] for i in range(len(ref_g))]
    got_p = [got[f"params/{i}"] for i in range(len(ref_p))]
    loss, gnorm, lr = got["metrics"]
    assert lr == float(metrics["lr"])
    assert abs(loss - float(metrics["loss"])) <= tol["loss"]
    assert abs(gnorm - float(metrics["grad_norm"])) / float(metrics["grad_norm"]) <= tol["grad_norm_rel"]
    if not leaf_by_leaf:
        return
    corr = min(float(np.corrcoef(a.ravel(), b.ravel())[0, 1]) for a, b in zip(ref_g, got_g)
               if a.size > 1 and a.std() > 0)
    assert corr >= tol["grad_corr"], corr
    gap = smoke.update_gap(w0, ref_p, got_p, ref_g, float(opt.lr_at(acfg, 0)))
    assert gap["kept"] <= tol["update_lr"] and gap["all"] <= tol["params_lr"], gap


_TP_RUNS: dict = {}


def _tp_run(tmp_path_factory, arch: str) -> dict:
    """The 2×2 train step's outputs, run once per arch for this module: the
    MoE arch's run holds its f32 step too."""
    if arch not in _TP_RUNS:
        dtypes = "bf16,f32" if configs.get_config(arch).is_moe else "bf16"
        (_TP_RUNS[arch],) = _run(tmp_path_factory.mktemp(arch), 4, arch, "tp", dtypes)
    return _TP_RUNS[arch]


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b"])
def test_sharded_step_on_a_2x2_mesh_matches_one_device(tmp_path_factory, arch):
    _hold_step(_tp_run(tmp_path_factory, arch), arch, leaf_by_leaf=not configs.get_config(arch).is_moe)


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b"])
def test_sharded_step_on_a_one_rank_gloo_mesh_is_bit_equal(arch):
    """``jit_train_step`` on a 1×1 gloo mesh equals the plain step bit for bit
    (a one-rank mesh's shards are whole tensors): the metrics, every weight
    and both moments; in the MoE arch through ``sharding.TokenRows``."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import single_device_mesh

    cfg = configs.get_config(arch, smoke=True)
    api = registry.build(cfg)
    tokens = torch.from_numpy(pipeline.synthetic_lm_batch(0, 0, BATCH, SEQ, cfg.vocab))
    acfg = opt.AdamWConfig(**ACFG)
    params = api.init_params(0, device="cpu")
    want = ts.build_train_step(api, None, acfg)(params, opt.init_state(params), {"tokens": tokens})
    if dist.is_initialized():
        dist.destroy_process_group()
    mesh = single_device_mesh("cpu")
    try:
        spec = {k: v[1] for k, v in api.input_specs("train_4k", mesh).items()}
        params = api.init_params(0, device="cpu")
        got = ts.jit_train_step(api, mesh, acfg, spec)(params, opt.init_state(params), {"tokens": tokens})
    finally:
        dist.destroy_process_group()
    local = lambda x: (x.to_local() if sh.is_dtensor(x) else x).detach()
    for k in want[2]:
        assert float(local(got[2][k])) == float(want[2][k]), k
    for tree_w, tree_g in ((want[0], got[0]), (want[1]["m"], got[1]["m"]), (want[1]["v"], got[1]["v"])):
        leaves_w, leaves_g = opt.tree_leaves(tree_w), opt.tree_leaves(tree_g)
        assert len(leaves_w) == len(leaves_g)
        assert all(sh.is_dtensor(g) for g in leaves_g)
        for i, (a, b) in enumerate(zip(leaves_w, leaves_g)):
            assert torch.equal(a.detach(), local(b)), i


def test_sharded_moe_step_in_f32_matches_one_device_leaf_by_leaf(tmp_path_factory, monkeypatch):
    """deepseek-moe-16b's 2×2 step with f32 activations on both sides: every
    leaf's gradient and every weight's update within ``TRAIN_TOL``, the
    router's and the expert-sharded weights' among them."""
    run = _tp_run(tmp_path_factory, "deepseek-moe-16b")
    got = {k[len("f32/"):]: v for k, v in run.items() if k.startswith("f32/")}
    monkeypatch.setattr(lm, "BF16", torch.float32)
    _hold_step(got, "deepseek-moe-16b", leaf_by_leaf=True)


@pytest.mark.parametrize("arch", ["smollm-135m", "hymba-1.5b"])
def test_sharded_prefill_and_decode_on_a_2x2_mesh_match_one_device(tmp_path, arch):
    """Prefill and two decode steps with params and caches as DTensors (KV
    cache sequence-sharded over 'model', the decode write shard by shard)
    against the one-device path, within ``chip_smoke.SMOKE_TOL``."""
    smoke = _chip_smoke()
    (got,) = _run(tmp_path, 4, arch, "serve")
    cfg = configs.get_config(arch, smoke=True)
    api = registry.build(cfg)
    params = api.init_params(0, device="cpu")
    tokens = torch.from_numpy(pipeline.synthetic_lm_batch(0, 0, BATCH, SEQ, cfg.vocab))
    cache = api.init_cache(4, 32, device="cpu")
    logits, cache = api.prefill(params, cache, tokens=tokens[:4, :16])
    ref = [logits]
    for i in range(2):
        logits, cache = api.decode_step(params, tokens[:4, 16 + i], cache)
        ref.append(logits)
    for i, r in enumerate(ref):
        err, corr, ok = smoke.compare(r, torch.from_numpy(got[f"logits/{i}"]), **smoke.SMOKE_TOL["logits"])
        assert ok, (i, err, corr)
    for k, v in cache.items():
        tol = smoke.SMOKE_TOL["ssm" if k == "ssm" else "cache"] if k != "t" else None
        g = torch.from_numpy(got[f"cache/{k}"])
        if tol is None:
            assert float(g) == float(v)
        else:
            err, corr, ok = smoke.compare(v, g, **tol)
            assert ok, (k, err, corr)


def test_pod_compressed_step_equals_the_group_path(tmp_path):
    outs = _run(tmp_path, 2, "smollm-135m", "pod")
    assert len(outs) == 2
    for got in outs:
        n = len([k for k in got if k.startswith("want_grads/")])
        assert n == len([k for k in got if k.startswith("grads/")]) > 0
        for i in range(n):
            assert np.array_equal(got[f"grads/{i}"].view(np.uint32), got[f"want_grads/{i}"].view(np.uint32)), i
            assert np.array_equal(got[f"params/{i}"].view(np.uint32), got[f"plain_params/{i}"].view(np.uint32)), i
        assert got["metrics"][1] == got["plain_grad_norm"]
    # both pods end with the same weights
    for i in range(n):
        assert np.array_equal(outs[0][f"params/{i}"], outs[1][f"params/{i}"])


def test_build_train_step_takes_a_mesh_and_compress_pods_needs_pods():
    api = registry.build(configs.get_config("smollm-135m", smoke=True))
    with pytest.raises(ValueError, match="group"):
        ts.build_train_step(api, None, opt.AdamWConfig(), compress_pods=True)
