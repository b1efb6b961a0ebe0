"""The port's dry-run (``repro_torch.launch.dryrun``), its collective recorder
and the lowered multi-job step, on the CPU.

``dryrun.lower`` runs a two-layer cut of ``smollm-135m`` (full widths, 2 of
30 layers) at ``train_4k`` on the fake 16×16 mesh and at ``decode_32k`` on
the 16×16 and 2×16×16 meshes; ``main`` writes the reference's skip record
for ``long_500k``.  The records pass the reference's own checks
(``tests/test_dryrun_records.py``, run in a subprocess on them with
``DRYRUN_DIR`` set); their ``model_flops`` is the reference's formula; their
argument bytes are rank 0's shards, counted here from the specs.  The
recorder's bytes for a known all-gather, reduce-scatter and all-reduce, and
``FlopCounterMode`` on a sharded product (global FLOPs, once) are pinned.
``lower_multi_job_step`` at n = 2^9, L = 6, 2 affiliations × 2 jobs: its
graph, run on real inputs, gives the reference's ``ctx.mul`` bytes.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.fhe import keys as ref_keys
from repro.fhe import params as ref_params
from repro.fhe.context import ExecPolicy as RefPolicy, FheContext as RefContext
from repro.roofline import analysis as ref_roofline
from repro_torch import configs
from repro_torch.core import executor as E
from repro_torch.distributed import sharding as sh
from repro_torch.fhe import keys as K, params as P
from repro_torch.fhe.context import ExecPolicy, FheContext
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import registry
from repro_torch.roofline import analysis

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CUT = dataclasses.replace(configs.get_config("smollm-135m"), n_layers=2)
CELLS = (("train_4k", False), ("decode_32k", False), ("decode_32k", True))


@pytest.fixture(scope="module", autouse=True)
def _no_group_after():
    """The dry-run leaves its fake process group running; end it after."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def records():
    out = {}
    for shape, multi_pod in CELLS:
        rec = dryrun.lower(CUT, shape, multi_pod)
        out[(shape, multi_pod)] = rec
    return out


def test_records_pass_the_reference_checks(records, tmp_path):
    for (shape, multi_pod), rec in records.items():
        # the reference's checks know its ten arch ids: file the cut under its arch
        rec = dict(rec, arch="smollm-135m", policy="tp", block_skip=False)
        tag = f"smollm-135m_{shape}_{'pod2' if multi_pod else 'pod1'}"
        (tmp_path / f"{tag}.json").write_text(json.dumps(rec))
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "long_500k", "--out-dir", str(tmp_path), "--no-probes"]) == 0
    skip = json.loads((tmp_path / "smollm-135m_long_500k_pod1.json").read_text())
    assert skip["status"] == "skipped" and "524288" in skip["reason"]
    env = dict(os.environ, DRYRUN_DIR=str(tmp_path), PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:xdist",
                          "tests/test_dryrun_records.py"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-3000:]
    assert "4 passed" in out.stdout, out.stdout[-500:]


def test_record_contents(records):
    for (shape, multi_pod), rec in records.items():
        assert rec["status"] == "ok" and rec["chips"] == (512 if multi_pod else 256)
        assert rec["mesh"] == ("pod2x16x16" if multi_pod else "16x16")
        info = registry.SHAPES[shape]
        kind = "train" if info["kind"] == "train" else "serve"
        tokens = info["batch"] * (info["seq"] if kind == "train" else 1)
        want = ref_roofline.model_flops_per_step(CUT.param_count(), CUT.active_param_count(), tokens, kind)
        assert rec["model_flops"] == want == analysis.model_flops_per_step(
            CUT.param_count(), CUT.active_param_count(), tokens, kind)
        assert rec["useful_flops_ratio"] == rec["model_flops"] / rec["flops"]
        assert rec["coll_bytes_total"] == rec["collectives"]["total_bytes"] * rec["chips"] > 0
        mem = rec["memory"]
        assert ("bytes_per_device" in mem) != ("bytes_per_device_absent" in mem)
        rl = rec["roofline"]
        assert rl["chips"] == rec["chips"] and rl["flops"] == rec["flops"] and rl["hbm_bytes"] == rec["hbm_bytes"]
    train = records[("train_4k", False)]
    # remat: the forward runs twice and the backward once, ≥ 6·N·D of the model's products
    assert 0.5 < train["useful_flops_ratio"] < 1.0
    assert train["collectives"]["count"]["all-gather"] > 0 and train["collectives"]["count"]["reduce-scatter"] > 0


def test_argument_bytes_are_rank_zeros_shards(records):
    """Params (f32), AdamW m and v (f32) and step (int32) or the decode
    cache, and the inputs: each leaf's bytes divided by the sizes of the mesh
    axes its sanitised spec names."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    api = registry.build(CUT)
    for shape, multi_pod in CELLS:
        sizes = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
        mesh = type("M", (), {"shape": sizes})()
        info = registry.SHAPES[shape]
        with FakeTensorMode():
            tree = api.init_tree(0)
            cache = api.init_cache(info["batch"], info["seq"], device="cpu")
        local = []
        each = lambda s, x: local.append(x.numel() * x.element_size() // _ways(s, sizes))
        sh.spec_map(each, sh.sanitize_tree(api.param_specs(mesh), tree, mesh), tree)
        if info["kind"] == "train":
            want = 3 * sum(local) + 4
        else:
            sh.spec_map(each, sh.sanitize_tree(api.cache_specs(mesh), cache, mesh), cache)
            want = sum(local)
        for (in_shape, dtype), spec in api.input_specs(shape, mesh).values():
            n = int(np.prod(in_shape)) * torch.empty((), dtype=dtype).element_size()
            want += n // _ways(sh.sanitize_spec(spec, in_shape, mesh), sizes)
        assert records[(shape, multi_pod)]["memory"]["argument_bytes"] == want, shape


def _ways(spec, sizes) -> int:
    n = 1
    for part in spec:
        for a in (part if isinstance(part, tuple) else (part,) if part else ()):
            n *= sizes[a]
    return n


def test_collective_recorder_counts_result_bytes():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    mesh = make_mesh((16, 16), ("data", "model"), "cpu", fake=True)
    x = distribute_tensor(torch.randn(64, 128), mesh, [Shard(0), Replicate()], src_data_rank=None)
    part = DTensor.from_local(torch.randn(64, 128), mesh, [Partial(), Replicate()])
    rec = analysis.CollectiveRecorder()
    with rec:
        x.redistribute(mesh, [Replicate(), Replicate()])  # all-gather: the whole 64 × 128 f32
        part.redistribute(mesh, [Shard(0), Replicate()])  # reduce-scatter: a 4 × 128 f32 shard
        part.redistribute(mesh, [Replicate(), Replicate()])  # all-reduce: the whole
        t = torch.ones(32, dtype=torch.bfloat16)
        dist.all_reduce(t)  # an eager c10d all-reduce: 32 bf16
    got = analysis.collective_bytes_of(rec)
    assert got["bytes"] == {"all-gather": 64 * 128 * 4, "all-reduce": 64 * 128 * 4 + 64,
                            "reduce-scatter": 4 * 128 * 4, "all-to-all": 0, "collective-permute": 0}
    assert got["count"] == {"all-gather": 1, "all-reduce": 2, "reduce-scatter": 1, "all-to-all": 0,
                            "collective-permute": 0}
    assert got["total_bytes"] == sum(got["bytes"].values())
    assert set(got) == set(analysis.collective_bytes("")) and list(got["bytes"]) == list(analysis._COLLECTIVES)


def test_memtracker_alone_counts_rank_zeros_shards():
    """The dry-run's memory pass: ``MemTracker`` alone over DTensor operations
    of fake tensors, after a first pass has cached their sharding propagation
    (which evaluates each op at its global shape on a cache miss), tracks
    each result's local shard (two 256 × 4096 f32 shards of a row-sharded
    4096 × 4096)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = make_mesh((16, 16), ("data", "model"), "cpu", fake=True)
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = distribute_tensor(torch.zeros(4096, 4096), mesh, [Shard(0), Replicate()], src_data_rank=None)
        (x * 2) + 1  # the counting pass
        tracker = MemTracker()
        with tracker:
            y = x * 2
            z = y + 1
        assert z.to_local().shape == (256, 4096)
    peak = sum(s["Total"] for s in tracker.get_tracker_snapshot("peak").values())
    assert peak == 2 * 256 * 4096 * 4


def test_flop_counter_counts_a_sharded_product_globally_once():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    mesh = make_mesh((16, 16), ("data", "model"), "cpu", fake=True)
    m, k, n = 64, 128, 256
    a = distribute_tensor(torch.randn(m, k), mesh, [Replicate(), Replicate()], src_data_rank=None)
    b = distribute_tensor(torch.randn(k, n), mesh, [Replicate(), Shard(1)], src_data_rank=None)
    rec = analysis.CollectiveRecorder()
    with rec, FlopCounterMode(display=False) as fc:  # the dry-run's order of modes
        c = a @ b
    assert c.placements == (Replicate(), Shard(1))
    assert fc.get_total_flops() == 2 * m * n * k


def test_lower_cell_takes_the_reference_arguments(monkeypatch):
    seen = {}
    monkeypatch.setattr(dryrun, "lower", lambda cfg, *args: seen.update(cfg=cfg, args=args))
    dryrun.lower_cell("smollm-135m", "decode_32k", True, with_probes=False)
    assert seen["cfg"] == configs.get_config("smollm-135m") and seen["args"] == ("decode_32k", True, "cpu", True)
    with pytest.raises(SystemExit):
        dryrun.main(["--help"])


def test_lowered_multi_job_step_gives_the_reference_bytes():
    p = P.make_params(1 << 9, 6, 2, check_security=False)
    ks = K.full_keyset(p, seed=0, device="cpu")
    mesh = E.affiliation_mesh(2, "cpu", fake=True)
    gm, counts = E.lower_multi_job_step(p, ks, mesh, jobs_per_aff=2)
    assert isinstance(gm, torch.fx.GraphModule) and sum(counts.values()) > 100
    ctx = FheContext(params=p, keys=ks, policy=ExecPolicy(backend="ref"), device="cpu")
    rpp = ref_params.make_params(1 << 9, 6, 2, check_security=False)
    rctx = RefContext(params=rpp, keys=ref_keys.full_keyset(rpp, seed=0), policy=RefPolicy(backend="ref"))
    rng = np.random.default_rng(5)
    jobs = []
    for j in range(4):  # 2 affiliations × 2 jobs: job j on affiliation j // 2
        x, y = rng.normal(size=p.slots) * 0.4, rng.normal(size=p.slots) * 0.4
        jobs.append(((ctx.encrypt(ctx.encode(x), seed=j), ctx.encrypt(ctx.encode(y), seed=10 + j)),
                     (rctx.encrypt(rctx.encode(x), seed=j), rctx.encrypt(rctx.encode(y), seed=10 + j))))
    outs = []
    for aff in range(2):
        mine = jobs[2 * aff:2 * aff + 2]
        a0, a1, b0, b1 = (torch.stack([getattr(pair[0][i], c) for pair in mine])
                          for i, c in ((0, "c0"), (0, "c1"), (1, "c0"), (1, "c1")))
        c0, c1 = gm(a0, a1, b0, b1)
        for j, (_, (ra, rb)) in enumerate(mine):
            ref = rctx.mul(ra, rb)
            assert np.array_equal(c0[j].numpy().astype(np.uint32), np.asarray(ref.c0))
            assert np.array_equal(c1[j].numpy().astype(np.uint32), np.asarray(ref.c1))
            outs.append((c0[j], c1[j]))
    # the context's caches hold no fake tensor after the trace: eager ctx.mul as the graph
    (a, b), _ = jobs[3]
    out = ctx.mul(a, b)
    assert torch.equal(out.c0, outs[3][0]) and torch.equal(out.c1, outs[3][1])
