"""Limb-wise modular multiply / add / subtract over (..., l, N) residues.

On a CPU tensor each op runs its plain version (``ref``); on a CUDA tensor it
launches the ``csrc/modops.cu`` kernel, or raises.  Every call records one
dispatch under the reference package's op name.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.fhe import modmath as mm
from repro_torch.kernels import dispatch
from repro_torch.kernels.cuda import I, P, CudaKernel, check_cuda, ptr, u32_tensor
from repro_torch.kernels.tables import table

from . import ref as _ref

KERNEL = CudaKernel("modops", "modops.cu", "modops_launch", [I, P, P, P, P, P, P, I, I, I, P])
_MUL, _ADD, _SUB = 0, 1, 2


@table("modops_constants")
def constants(qs: tuple[int, ...], device: torch.device):
    """(q, −q⁻¹ mod 2^32, R² mod q) of the moduli ``qs`` on ``device``, the kernel's operands."""
    c = mm.mont_constants_array(qs)
    return tuple(u32_tensor(c[k], device) for k in ("q", "qinv_neg", "r2"))


def _launch(op: int, a: torch.Tensor, b: torch.Tensor, qs) -> torch.Tensor:
    if a.shape != b.shape:
        raise ValueError(f"operand shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    # callers pass expand()-ed per-limb constants, whose stride is 0
    a, b = a.contiguous(), b.contiguous()
    dev = check_cuda(a, b)
    l, n = a.shape[-2:]
    rows = a.numel() // n
    if n % 4 or a.data_ptr() % 16 or b.data_ptr() % 16 or rows > 65535:
        raise ValueError(f"modops kernel needs N % 4 == 0, 16-byte aligned rows and ≤ 65535 rows, got {tuple(a.shape)}")
    q, qinv, r2 = constants(tuple(int(v) for v in np.asarray(qs).reshape(-1)), dev)
    if q.numel() != l:
        raise ValueError(f"{q.numel()} moduli for {l} limbs")
    out = torch.empty_like(a)
    KERNEL.launch(dev, op, ptr(a), ptr(b), ptr(out), ptr(q), ptr(qinv), ptr(r2), rows, l, n)
    return out


def pointwise_mulmod(a, b, qs):
    """(a ∘ b) mod q per limb.  a, b: (..., l, N) int32; qs: (l,)."""
    dispatch.record("mulmod")
    if a.device.type == "cpu":
        return _ref.mulmod_ref(a, b, qs)
    return _launch(_MUL, a, b, qs)


def pointwise_addmod(a, b, qs):
    dispatch.record("addmod")
    if a.device.type == "cpu":
        return _ref.addmod_ref(a, b, qs)
    return _launch(_ADD, a, b, qs)


def pointwise_submod(a, b, qs):
    dispatch.record("submod")
    if a.device.type == "cpu":
        return _ref.submod_ref(a, b, qs)
    return _launch(_SUB, a, b, qs)
