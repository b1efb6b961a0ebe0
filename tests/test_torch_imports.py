"""The port imports neither JAX nor the reference package.

A fresh interpreter imports every module of ``repro_torch`` and
``chip_smoke.py`` (without running its ``main``), then reports which modules
it holds: none may be ``jax``, ``jaxlib`` or anything under them, nor
``repro`` or anything under it, nor ``msgpack`` (the card's machine has
none; the checkpoint manager writes its manifests itself)."""

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
print(json.dumps({"imported": names, "smoke_main": callable(getattr(smoke, "main", None)),
                  "modules": sorted(sys.modules)}))
"""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "repro" or top.startswith("jax")


def test_port_and_smoke_import_no_jax_and_no_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    imported = set(report["imported"])
    for name in ("core.hardware", "core.cache", "core.jobs", "core.planner", "core.simulator",
                 "core.scheduler", "core.executor", "serve.events", "serve.faults", "serve.policy",
                 "serve.traffic", "serve.cluster", "serve.metrics", "obs.trace", "obs.export",
                 "obs.metrics", "obs.spans", "fhe.context", "kernels.cuda", "models.config", "models.layers",
                 "models.lm", "models.vlm", "models.whisper", "models.registry", "models.convert", "serving.engine",
                 "launch.serve", "data.pipeline", "configs", "configs.smollm_135m", "configs.whisper_medium",
                 "training.optimizer", "training.compress", "training.train_step", "checkpoint.failures",
                 "checkpoint.manager", "roofline.memory_model", "roofline.analysis", "launch.train",
                 "distributed.sharding", "launch.mesh", "launch.dryrun"):
        assert f"repro_torch.{name}" in imported, name
    assert report["smoke_main"]
    assert [m for m in report["modules"] if _forbidden(m)] == []
    assert [m for m in report["modules"] if m.split(".")[0] == "msgpack"] == []
