"""The port's planner against the reference's: every workload stream.

``workload_stream`` of both packages, for every preset in
``available_workloads()``, in both modes, under the fused and staged
pipelines × hoisting never/always and under "auto" at ``device="cpu"`` (each
policy re-tagged for the preset's scheme), gives equal ``Instr`` lists,
``meta`` included.  "auto" at ``device="cuda"`` gives the reference's fused
stream.  The exec-mode streams of the deep presets hold half a million records
and more; the cyclic collector is paused while they are built, which changes
nothing but the time.  ``resnet20``'s exec streams (4.2 million records each)
are held in ``tests/test_torch_planner_resnet20.py``, so that each file stays
well under a minute."""

import gc
import operator

import pytest
import torch

from repro.core import planner as R_PL
from repro.fhe import params as R_P
from repro.fhe.context import ExecPolicy as R_Policy
from repro_torch.core import planner as T_PL
from repro_torch.fhe import params as T_P
from repro_torch.fhe.context import ExecPolicy as T_Policy

torch.set_num_threads(1)

WORKLOADS = R_PL.available_workloads()
DEEP = tuple(w for w in WORKLOADS if R_P.workload_kind(w) == "deep")
DEEP_HERE = tuple(w for w in DEEP if w != "resnet20")
# (backend, hoisting); "auto" is priced at device="cpu"
POLICIES = (("fused", "never"), ("fused", "always"), ("staged", "never"),
            ("staged", "always"), ("auto", "auto"))


@pytest.fixture
def no_gc():
    """Pause the cyclic collector while millions of ``Instr`` records are built."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()


def _same(ref, port) -> bool:
    """Full ``Instr`` equality (op, n, limbs, meta) across the two packages'
    ``Instr`` classes, in order."""
    return len(ref) == len(port) and all(map(operator.eq, map(vars, ref), map(vars, port)))


def _streams(name, mode, backend, hoisting, device="cpu"):
    rp, tp = R_P.workload_params(name), T_P.workload_params(name)
    ref = R_PL.workload_stream(name, rp, mode=mode,
                               policy=R_Policy(backend=backend, hoisting=hoisting).for_scheme(rp.scheme))
    port = T_PL.workload_stream(name, tp, mode=mode,
                                policy=T_Policy(backend=backend, hoisting=hoisting).for_scheme(tp.scheme),
                                device=device)
    return ref, port


def test_available_workloads_match():
    assert T_PL.available_workloads() == WORKLOADS
    assert len(WORKLOADS) == 11


@pytest.mark.parametrize("backend,hoisting", POLICIES)
@pytest.mark.parametrize("name", WORKLOADS)
def test_hw_streams_equal(name, backend, hoisting):
    ref, port = _streams(name, "hw", backend, hoisting)
    assert len(ref) > 10
    assert _same(ref, port)


@pytest.mark.parametrize("backend,hoisting", POLICIES)
@pytest.mark.parametrize("name", [w for w in WORKLOADS if w not in DEEP])
def test_exec_streams_equal_shallow(name, backend, hoisting):
    ref, port = _streams(name, "exec", backend, hoisting)
    assert _same(ref, port)


@pytest.mark.parametrize("backend,hoisting", POLICIES)
@pytest.mark.parametrize("name", DEEP_HERE)
def test_exec_streams_equal_deep(no_gc, name, backend, hoisting):
    ref, port = _streams(name, "exec", backend, hoisting)
    assert len(ref) > 400_000
    assert _same(ref, port)


@pytest.mark.parametrize("mode", ("hw", "exec"))
@pytest.mark.parametrize("name", [w for w in WORKLOADS if w not in DEEP])
def test_auto_on_cuda_is_the_reference_fused_stream(name, mode):
    """"auto" resolves on the device it is given: on "cuda" the planner emits
    the reference's ``backend="fused"`` stream, on "cpu" the staged one."""
    fused, _ = _streams(name, mode, "fused", "auto")
    staged, _ = _streams(name, mode, "staged", "auto")
    _, on_cuda = _streams(name, mode, "auto", "auto", device="cuda")
    _, on_cpu = _streams(name, mode, "auto", "auto", device="cpu")
    assert _same(fused, on_cuda) and _same(staged, on_cpu)
    if any(i.op == "LOAD_KSK" for i in fused):
        assert not _same(fused, staged)  # the resolution is visible in the stream


def test_plan_fused_resolution():
    assert T_PL.plan_fused(T_Policy(backend="auto"), "cuda")
    assert not T_PL.plan_fused(T_Policy(backend="auto"), "cpu")
    assert T_PL.plan_fused(T_Policy(backend="auto"))  # the port's default device is "cuda"
    for backend, fused in (("fused", True), ("kernel", True), ("staged", False), ("ref", False)):
        for device in ("cpu", "cuda", torch.device("cpu")):
            assert T_PL.plan_fused(T_Policy(backend=backend), device) is fused
            assert R_Policy(backend=backend).plan_fused is fused
    # the reference resolves "auto" on JAX's backend: staged on the CPU
    assert R_Policy(backend="auto").plan_fused is False
