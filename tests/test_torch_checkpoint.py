"""The port's checkpoints (``repro_torch.checkpoint``) and training launcher
(``repro_torch.launch.train``), on the CPU.

The manager keeps the reference's on-disk layout, so each package restores
the other's checkpoints: the port stacks its per-layer parameters as the
reference does.  Its MessagePack manifest comes from a small codec of its
own (the card's machine has no ``msgpack``), byte for byte
``msgpack.packb``'s.  A resumed launcher run repeats the uninterrupted
run's losses exactly.
"""

import os
import shutil

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint import manager as ref_manager
from repro.models import registry as ref_registry
from repro_torch import configs
from repro_torch.checkpoint import failures, manager
from repro_torch.launch import train
from repro_torch.models import registry
from repro_torch.models.convert import params_from_reference, params_to_reference
from repro_torch.training import optimizer as opt

torch.set_num_threads(1)


def _manifest(tmp, step):
    with open(os.path.join(tmp, f"step_{step:08d}", "manifest.msgpack"), "rb") as f:
        return f.read()


def test_checkpoint_roundtrip_atomic(tmp_path):
    tree = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "nested": {"b": np.ones((2,), np.int32)}}
    d = manager.save(str(tmp_path), 7, tree)
    assert os.path.exists(os.path.join(d, "COMMIT")) and not os.path.exists(d + ".tmp")
    step, got = manager.restore(str(tmp_path))
    assert step == 7
    np.testing.assert_array_equal(got["a"], tree["a"])
    np.testing.assert_array_equal(got["nested"]["b"], tree["nested"]["b"])
    assert got["nested"]["b"].dtype == np.int32


def test_checkpoint_retention_and_latest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        manager.save(str(tmp_path), s, {"x": np.array([s])}, keep=3)
    assert manager.latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004", "step_00000005"]
    assert manager.latest_step(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError):
        manager.restore(str(tmp_path / "absent"))


def test_checkpoint_ignores_uncommitted(tmp_path):
    manager.save(str(tmp_path), 1, {"x": np.array([1])})
    # a torn write: a step dir without COMMIT, and a staged one
    os.makedirs(tmp_path / "step_00000009")
    os.makedirs(tmp_path / "step_00000010.tmp")
    assert manager.latest_step(str(tmp_path)) == 1
    with pytest.raises(FileNotFoundError, match="COMMIT"):
        manager.restore(str(tmp_path), step=9)


def test_restore_onto_a_device(tmp_path, monkeypatch):
    """A tree of tensors, a ``ParamTree`` among them, comes back as numpy
    arrays in the reference's layout (per-layer lists stacked on a leading
    axis), or as tensors on the device asked for; "cuda" raises without a card."""
    cfg = configs.get_config("smollm-135m", smoke=True)
    params = registry.build(cfg).init_params(0, device="cpu")
    manager.save(str(tmp_path), 3, {"params": params, "opt": opt.init_state(params), "t": torch.arange(4)})
    step, arrays = manager.restore(str(tmp_path))
    assert step == 3 and arrays["params"]["blocks"]["attn"]["wqkv"].shape[0] == cfg.n_layers
    back = params_from_reference(cfg, arrays["params"], device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(opt.tree_leaves(back), opt.tree_leaves(params)))
    step, tensors = manager.restore(str(tmp_path), step=3, device="cpu")
    assert torch.equal(tensors["t"], torch.arange(4))
    assert tensors["opt"]["step"].dtype == torch.int32 and tensors["opt"]["step"].shape == ()
    assert torch.equal(tensors["params"]["blocks"]["attn"]["wqkv"][1], params["blocks"][1]["attn"]["wqkv"].detach())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        manager.restore(str(tmp_path), device="cuda")


def test_heartbeat_failure_and_straggler_flow():
    mon = failures.HeartbeatMonitor(4, deadline=10.0, strike_limit=2)
    for h in range(4):
        mon.beat(h, now=0.0, step_time=1.0)
    mon.set_median_step_time(1.0)
    # host 2 straggles twice → quarantine; host 3 goes silent → dead
    for now in (1.0, 2.0):
        for h in (0, 1):
            mon.beat(h, now, step_time=1.0)
        mon.beat(2, now, step_time=5.0)
    rep = mon.check(now=10.5)
    assert rep["dead"] == [3]
    assert rep["quarantine"] == [2]
    plan = failures.plan_restart(mon, latest_ckpt_step=42)
    assert plan.restore_step == 42
    assert 3 not in plan.mesh_hosts
    assert sorted(plan.new_shard_of_host.values()) == list(range(3))


MANIFEST_VALUES = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33, -128, -129,
    -32768, -32769, -2**31, -2**31 - 1, -2**63, "", "a", "x" * 31, "x" * 32, "x" * 255, "x" * 256, "x" * 65536,
    "blocks/attn/wqkv", "ünï", [], list(range(15)), list(range(16)), list(range(70000)),
    {}, {f"k{i}": i for i in range(15)}, {f"k{i}": [i, str(i)] for i in range(16)},
    {"step": 7, "keys": ["a"], "shapes": {"a": [3, 4]}, "dtypes": {"a": "float32"}},
]


@pytest.mark.parametrize("value", MANIFEST_VALUES, ids=lambda v: repr(v)[:24])
def test_manifest_codec_is_msgpacks(value):
    assert manager.packb(value) == msgpack.packb(value)
    assert manager.unpackb(msgpack.packb(value)) == msgpack.unpackb(msgpack.packb(value)) == value


def test_manifest_codec_refuses_other_types():
    for bad in (1.5, None, True, b"x", {1: 2}, 2**64, -2**63 - 1):
        with pytest.raises((TypeError, ValueError)):
            manager.packb(bad)
    with pytest.raises(ValueError):
        manager.unpackb(msgpack.packb(1.5))
    with pytest.raises(ValueError):
        manager.unpackb(msgpack.packb(1) + b"\x00")


def test_written_manifests_are_msgpacks(tmp_path):
    cfg = configs.get_config("whisper-medium", smoke=True)
    params = registry.build(cfg).init_params(0, device="cpu")
    tree = {"params": params, "opt": opt.init_state(params)}
    manager.save(str(tmp_path), 12, tree)
    data = _manifest(tmp_path, 12)
    manifest = manager.unpackb(data)
    assert data == msgpack.packb(manifest)
    assert manifest["step"] == 12 and manifest["keys"] == sorted(manifest["keys"])
    assert manifest["shapes"]["params/dec_blocks/ln1_w"] == [cfg.n_layers, cfg.d_model]
    assert manifest["dtypes"]["opt/step"] == "int32"


def test_checkpoints_restore_across_the_packages(tmp_path):
    """A port checkpoint restores in ``repro.checkpoint.manager`` and a
    reference checkpoint in the port's, with equal arrays and manifests."""
    rcfg, cfg = ref_configs.get_config("hymba-1.5b", smoke=True), configs.get_config("hymba-1.5b", smoke=True)
    rparams = jax.tree.map(np.asarray, ref_registry.build(rcfg).init_params(jax.random.PRNGKey(0)))
    params = params_from_reference(cfg, rparams, device="cpu")
    state = opt.init_state(params)
    state["step"] = torch.tensor(5, dtype=torch.int32)
    manager.save(str(tmp_path / "port"), 5, {"params": params, "opt": state})
    step, got = ref_manager.restore(str(tmp_path / "port"))
    assert step == 5 and int(got["opt"]["step"]) == 5
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(rparams)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    assert jax.tree.structure(got["params"]) == jax.tree.structure(rparams)
    ref_state = {"m": jax.tree.map(np.zeros_like, rparams), "v": jax.tree.map(np.ones_like, rparams),
                 "step": np.asarray(9, np.int32)}
    ref_manager.save(str(tmp_path / "ref"), 9, {"params": rparams, "opt": ref_state})
    step, back = manager.restore(str(tmp_path / "ref"))
    assert step == 9 and back["opt"]["step"].dtype == np.int32
    port = params_from_reference(cfg, back["params"], device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(params_to_reference(cfg, port)),
                                                     jax.tree.leaves(rparams)))
    assert _manifest(tmp_path / "ref", 9) == manager.packb(manager.unpackb(_manifest(tmp_path / "ref", 9)))


def test_launcher_resume_repeats_the_losses(tmp_path, capsys):
    """``launch.train.run`` on the CPU at SMOKE: a run resumed from its step-4
    checkpoint gives the uninterrupted run's losses and weights exactly."""
    kw = dict(smoke=True, steps=8, batch=4, seq=16, ckpt_every=4, log_every=4, device="cpu")
    full = train.run("smollm-135m", ckpt_dir=str(tmp_path / "a"), **kw)
    assert sorted(os.listdir(tmp_path / "a")) == ["step_00000004", "step_00000008"]
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "step_00000004", tmp_path / "b" / "step_00000004")
    resumed = train.run("smollm-135m", ckpt_dir=str(tmp_path / "b"), **kw)
    assert "resumed from step 4" in capsys.readouterr().out
    assert len(full["history"]) == 8 and resumed["history"] == full["history"][4:]
    assert all(torch.equal(a, b) for a, b in zip(opt.tree_leaves(full["params"]), opt.tree_leaves(resumed["params"])))
    assert full["final_loss"] == pytest.approx(np.mean(full["history"][-10:]))


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "whisper-medium", "mamba2-1.3b"])
def test_launcher_trains_the_multimodal_and_ssm_archs(arch):
    """The launcher's batches carry the VLM's patches and whisper's frames;
    three steps give finite, falling losses."""
    out = train.main(["--arch", arch, "--steps", "3", "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert all(np.isfinite(out["history"])) and len(out["history"]) == 3


def test_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        train.run("smollm-135m", True, 1, 2, 8, None)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        train.main(["--steps", "1"])
