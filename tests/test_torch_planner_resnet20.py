"""The port's planner against the reference's: ``resnet20`` in exec mode.

Nine bootstraps with dense CoeffToSlot/SlotToCoeff matvecs expand to 3.9 to
4.2 million records per stream, so this preset's exec-mode parity has a file of
its own (``tests/test_torch_planner.py`` holds the rest): full ``Instr``
equality, ``meta`` included, under every policy there."""

import pytest
import torch
from test_torch_planner import POLICIES, _same, _streams, no_gc  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("backend,hoisting", POLICIES)
def test_exec_streams_equal_resnet20(no_gc, backend, hoisting):  # noqa: F811
    ref, port = _streams("resnet20", "exec", backend, hoisting)
    assert len(ref) > 3_800_000
    assert _same(ref, port)
