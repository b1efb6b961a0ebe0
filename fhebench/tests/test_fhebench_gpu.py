"""A short run of each cell on the card through ``fhebench/run.py``; skips without one."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["lola_mnist.infer", "packed_bootstrap.evalmod"])
def test_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "fhebench/run.py", "--workload", workload, "--seed", "2147483659",
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
