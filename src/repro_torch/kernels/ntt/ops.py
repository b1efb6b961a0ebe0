"""Forward / inverse negacyclic NTT over (..., l, N) residues.

On a CPU tensor the plain version (``ref``) runs; on a CUDA tensor the
``csrc/ntt.cu`` kernel launches once per call, one block per (batch, limb)
row, or the call raises.  Each call records one dispatch (``ntt``/``intt``).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.fhe.ntt import NttPlan
from repro_torch.kernels import dispatch
from repro_torch.kernels.cuda import I, P, CudaKernel, check_cuda, mont_form, ptr, u32_tensor

from . import ref as _ref

KERNEL = CudaKernel("ntt", "ntt.cu", "ntt_launch", [I, P, P, P, P, P, P, I, I, I, I, P])


@functools.lru_cache(maxsize=256)
def kernel_tables(plan: NttPlan, l: int, device: torch.device) -> dict[str, torch.Tensor]:
    """The plan's first ``l`` limbs on ``device``: moduli, Montgomery constants,
    and the twist and root powers in Montgomery form (int32 bit patterns)."""
    qs = plan.qs[:l]

    def mont(a):
        return u32_tensor(mont_form(a[:l], qs), device)

    return dict(
        q=u32_tensor(qs, device), qinv=u32_tensor(plan.qinv_neg[:l], device),
        psi=mont(plan.psi_pows), w=mont(plan.w_pows),
        winv=mont(plan.winv_pows), psiinv_ninv=mont(plan.psiinv_ninv),
    )


def _run_kernel(x: torch.Tensor, plan: NttPlan, inverse: bool) -> torch.Tensor:
    x = x.contiguous()
    dev = check_cuda(x)
    l, n = x.shape[-2:]
    if n != plan.n:
        raise ValueError(f"ring degree {n} does not match the plan's {plan.n}")
    t = kernel_tables(plan, l, dev)
    twist, roots = (t["psiinv_ninv"], t["winv"]) if inverse else (t["psi"], t["w"])
    out = torch.empty_like(x)
    KERNEL.launch(dev, int(inverse), ptr(x), ptr(out), ptr(t["q"]), ptr(t["qinv"]), ptr(twist), ptr(roots),
                  x.numel() // n, l, n, n.bit_length() - 1)
    return out


def ntt_fwd(x, plan: NttPlan):
    """Coefficients → NTT slots (natural order).  x: (..., l, N) int32."""
    dispatch.record("ntt")
    if x.device.type == "cpu":
        return _ref.ntt_fwd_ref(x, plan)
    return _run_kernel(x, plan, inverse=False)


def ntt_inv(x, plan: NttPlan):
    """NTT slots → coefficients.  x: (..., l, N) int32."""
    dispatch.record("intt")
    if x.device.type == "cpu":
        return _ref.ntt_inv_ref(x, plan)
    return _run_kernel(x, plan, inverse=True)
