"""The port's int8 gradient compression (``repro_torch.training.compress``)
against the reference's (``repro.training.compress``), on the CPU.

``quantize`` and ``dequantize`` equal the reference's bit for bit: both
round half to even and divide once in float32.  ``compressed_psum_mean``
runs over a ``torch.distributed`` gloo group of separate processes (a
``FileStore`` under the test's directory, a 60 s timeout): it equals the
reference's protocol emulated without a mesh, and the true mean within the
reference's bound, 0.51 of the largest shared quantisation step.  A train
step with ``compress_pods`` leaves every rank with the same weights, those
of one AdamW step on the emulated mean.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.training import compress as ref_compress
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.models import registry
from repro_torch.models.convert import reference_layout
from repro_torch.training import compress
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = {"w": (1000,), "m": (3, 700), "b": (5,)}

WORKER = r"""
import datetime, json, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.models import registry
from repro_torch.models.convert import reference_layout
from repro_torch.training import compress, optimizer as opt, train_step as ts

rank, world, io = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(io + "/store", world), rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
try:
    with np.load(f"{io}/in_{rank}.npz") as z:
        grads = {k: torch.from_numpy(z[k]) for k in z.files}
    out = {k: v.numpy() for k, v in compress.compressed_psum_mean(grads).items()}
    cfg = configs.get_config("smollm-135m", smoke=True)
    api = registry.build(cfg)
    params = api.init_params(0, device="cpu")
    tokens = torch.from_numpy(pipeline.synthetic_lm_batch(0, 0, 4 * world, 16, cfg.vocab, shard=rank, n_shards=world))
    step = ts.build_train_step(api, None, opt.AdamWConfig(**json.loads(sys.argv[4])), compress_pods=True,
                               group=dist.group.WORLD)
    new, _, metrics = step(params, opt.init_state(params), {"tokens": tokens})
    flat = {f"params/{i}": v for i, v in enumerate(opt.tree_leaves(reference_layout(new)))}
    np.savez(f"{io}/out_{rank}.npz", **out, **flat)
finally:
    dist.destroy_process_group()
"""

ACFG = dict(lr_peak=3e-3, warmup_steps=5, total_steps=40)


@pytest.fixture(autouse=True)
def _reference_in_float32():
    """The reference runs as it does alone, without JAX's x64 mode, which
    another test file in the same worker may have turned on."""
    with jax.enable_x64(False):
        yield


def _check_roundtrip(n, scale_mag):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(scale=scale_mag, size=(n,)).astype(np.float32))
    q, s = compress.quantize(x)
    back = compress.dequantize(q, s, x.shape, x.dtype)
    err = (back - x).abs().numpy()
    # per-block bound: half a quantisation step of that block's absmax, plus
    # the float32 roundings of x / scale and of q · scale, ≤ 2^-22·|x| (the
    # reference's own bound leaves them out: at (3734, 25.0) its quantize
    # exceeds it by 2.1e-7, and the port's, bit-equal, by as much)
    blocks = compress._blocked(x).numpy()
    bound = np.repeat(np.abs(blocks).max(1) / 127.0, compress.BLOCK)[:n] * 0.5 + 1e-12
    assert (err <= bound + 2**-22 * x.abs().numpy() + 1e-7).all()


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 4000), st.floats(0.01, 100.0))
def test_quantize_roundtrip_property(n, scale_mag):
    _check_roundtrip(n, scale_mag)


@pytest.mark.parametrize("n, scale_mag", [(3734, 25.0), (1, 0.01), (4000, 100.0)])
def test_quantize_roundtrip_at_known_edges(n, scale_mag):
    _check_roundtrip(n, scale_mag)


@pytest.mark.parametrize("n, mag", [(1, 1.0), (255, 1e-3), (256, 1.0), (257, 100.0), (4097, 3.0),
                                    (100_000, 0.02), (589_824, 1.0)])
def test_quantize_equals_reference_bit_for_bit(n, mag):
    x = (np.random.default_rng(n).standard_normal(n) * mag).astype(np.float32)
    x[::97] = 0.0  # whole-zero stretches and exact zeros
    rq, rs = ref_compress.quantize(jnp.asarray(x))
    q, s = compress.quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(np.asarray(rq), q.numpy())
    assert np.array_equal(np.asarray(rs).view(np.uint32), s.numpy().view(np.uint32))
    shared = np.asarray(rs) * np.float32(1.5)
    rq2, _ = ref_compress.quantize(jnp.asarray(x), jnp.asarray(shared))
    q2, _ = compress.quantize(torch.from_numpy(x), torch.from_numpy(shared))
    assert np.array_equal(np.asarray(rq2), q2.numpy())
    for shape in ((n,), (1, n)):
        rd = ref_compress.dequantize(rq, rs, shape, jnp.float32)
        d = compress.dequantize(q, s, shape, torch.float32)
        assert tuple(d.shape) == shape and np.array_equal(np.asarray(rd).view(np.uint32), d.numpy().view(np.uint32))


@pytest.mark.parametrize("shape", [(1000,), (7, 33), (1,), (256,), (257, 3)], ids=str)
def test_compression_ratio_equals_reference(shape):
    assert compress.compression_ratio(shape) == ref_compress.compression_ratio(shape)
    assert compress.compression_ratio(shape, 2) == ref_compress.compression_ratio(shape, 2)
    if np.prod(shape) >= 1000:
        assert compress.compression_ratio(shape) > 3.5


def _emulated_mean(gs: list) -> np.ndarray:
    """The reference's protocol without a mesh: shared scale, int8, exact sum."""
    blocks = [np.asarray(ref_compress._blocked(jnp.asarray(g))) for g in gs]
    shared = np.max([np.abs(b).max(1) for b in blocks], axis=0) / np.float32(127.0)
    qs = [np.asarray(ref_compress.quantize(jnp.asarray(g), jnp.asarray(shared))[0], np.int32) for g in gs]
    q_sum = np.sum(qs, axis=0, dtype=np.int64)
    out = ref_compress.dequantize(jnp.asarray(q_sum / len(gs), jnp.float32), jnp.asarray(shared),
                                  gs[0].shape, jnp.float32)
    return np.asarray(out), shared


@pytest.mark.parametrize("world", [1, 4])
def test_compressed_psum_mean_over_gloo_processes(tmp_path, world):
    rng = np.random.default_rng(3)
    grads = [{k: (rng.normal(size=s) * (r + 1)).astype(np.float32) for k, s in SHAPES.items()} for r in range(world)]
    for r, g in enumerate(grads):
        np.savez(tmp_path / f"in_{r}.npz", **g)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(tmp_path), json.dumps(ACFG)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=150)
        assert p.returncode == 0, err[-3000:]
    outs = [dict(np.load(tmp_path / f"out_{r}.npz")) for r in range(world)]
    for k in SHAPES:
        want, shared = _emulated_mean([g[k] for g in grads])
        true_mean = np.mean([g[k] for g in grads], axis=0)
        for o in outs:
            assert o[k].dtype == np.float32 and np.array_equal(o[k], want)
            assert np.abs(o[k] - true_mean).max() <= shared.max() * 0.51 + 1e-7
    # the compressed train step: every rank holds the weights of one AdamW
    # step on the emulated mean of the ranks' gradients
    cfg = configs.get_config("smollm-135m", smoke=True)
    api = registry.build(cfg)
    params = api.init_params(0, device="cpu")
    per_rank = []
    for r in range(world):
        tokens = pipeline.synthetic_lm_batch(0, 0, 4 * world, 16, cfg.vocab, shard=r, n_shards=world)
        per_rank.append([g.numpy() for g in opt.tree_leaves(ts.loss_and_grads(api, params, {
            "tokens": torch.from_numpy(tokens)})[1])])
    mean = [torch.from_numpy(np.array(_emulated_mean(list(gs))[0])) for gs in zip(*per_rank)]
    new, _, _ = opt.apply_updates(opt.AdamWConfig(**ACFG), params, opt.tree_unflatten(params, mean),
                                  opt.init_state(params))
    want = opt.tree_leaves(reference_layout(new))
    for o in outs:
        got = [o[f"params/{i}"] for i in range(len(want))]
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_compressed_step_needs_a_group():
    api = registry.build(configs.get_config("smollm-135m", smoke=True))
    with pytest.raises(ValueError):
        ts.build_train_step(api, None, opt.AdamWConfig(), compress_pods=True, group=None)
