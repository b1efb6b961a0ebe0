"""What the harness and the reference load: compared by whole top-level names,
since the port's name begins with the JAX package's."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]

HARNESS = """
import sys, importlib, pathlib
sys.path[:0] = [{root!r}, {src!r}]
from fhebench import harness, check, tracing, inputs
for folder in ("jobs", "cost", "reference"):
    for f in sorted(pathlib.Path({root!r}, "fhebench", folder).glob("*.py")):
        importlib.import_module(f"fhebench.{{folder}}.{{f.stem}}")
for folder in ("metrics", "end_to_end"):
    for f in sorted(pathlib.Path({root!r}, "fhebench", folder).glob("*.py")):
        harness.reader(folder, f.stem)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

REFERENCE = """
import sys, importlib, pathlib
sys.path[:0] = [{root!r}]
for m in ("fhebench.check", "fhebench.inputs", "fhebench.tracing", "fhebench.cost"):
    importlib.import_module(m)
for folder in ("reference", "cost"):
    for f in sorted(pathlib.Path({root!r}, "fhebench", folder).glob("*.py")):
        importlib.import_module(f"fhebench.{{folder}}.{{f.stem}}")
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level(script: str) -> set:
    out = subprocess.run([sys.executable, "-c", script.format(root=str(ROOT), src=str(ROOT / "src"))],
                         capture_output=True, text=True, check=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))


def test_harness_loads_the_port_and_nothing_of_jax():
    names = _top_level(HARNESS)
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch", "torch"}


def test_the_guard_compares_whole_names(monkeypatch):
    from fhebench import harness

    monkeypatch.setitem(sys.modules, "repro_torchx", object())
    monkeypatch.setitem(sys.modules, "reprox.sub", object())
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fhe", object())
    assert harness.forbidden_modules() == ["repro"]


@pytest.mark.parametrize("tree", ["checkout", "bare"])
def test_no_card_no_result(tmp_path, tree):
    """Without a card, and in a tree that holds only BENCHMARK.json and fhebench/,
    the run exits with another code than 0 and prints nothing on standard output."""
    root = ROOT
    if tree == "bare":
        import shutil

        root = tmp_path / "bare"
        shutil.copytree(ROOT / "fhebench", root / "fhebench", ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "fhebench/run.py", "--workload", "lola_mnist.infer", "--seed", "3",
                          "--seconds", "1", "--trace", "0"], cwd=root, capture_output=True, text=True,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("where", ["reference", "cost", "reader"])
def test_a_forbidden_module_loaded_after_the_window_leaves_no_result(monkeypatch, where):
    """A reference, a work count or a metric reader that loads JAX after the window
    has closed: the run ends without a result line (SystemExit, as run.py exits)."""
    import importlib
    import time
    import types

    from fhebench import check, harness
    import test_fhebench_control as small

    def plant(f):
        def wrapped(*args, **kwargs):
            sys.modules["jax"] = types.ModuleType("jax")
            return f(*args, **kwargs)
        return wrapped

    if where == "reference":
        monkeypatch.setattr(check, "reference", plant(check.reference))
    elif where == "cost":
        monkeypatch.setattr(harness, "least_s_per_job", plant(harness.least_s_per_job))
    else:
        real = harness.reader
        monkeypatch.setattr(harness, "reader", lambda folder, name: plant(real(folder, name)))
    name = "lola_mnist.infer"
    try:
        with pytest.raises(SystemExit, match="jax"):
            harness.run_cell(name, small.BENCH, small.SEED, 0.2, where == "cost", time.perf_counter(),
                             device="cpu", parts=small.parts(name))
    finally:
        sys.modules.pop("jax", None)
    importlib.invalidate_caches()
