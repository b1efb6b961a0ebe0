"""Forward / inverse negacyclic NTT over (..., l, N) residues.

On a CPU tensor the plain version (``ref``) runs; on a CUDA tensor the call
goes through one C entry of ``csrc/ntt.cu``, which starts two kernels (the
two passes of a four-step NTT, many thread blocks per limb), or the call
raises.  Each call records one dispatch (``ntt``/``intt``) and one launch.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.fhe.ntt import NttPlan
from repro_torch.kernels import dispatch
from repro_torch.kernels.cuda import I, P, CudaKernel, check_cuda, mont_form, pass_blocks, ptr, u32_tensor
from repro_torch.kernels.tables import table

from . import ref as _ref

KERNEL = CudaKernel("ntt", "ntt.cu", "ntt_launch", [I, P, P, P, P, P, P, P, P, I, I, I, I, P])
MIN_LOG_N, MAX_LOG_N = 8, 16  # the ring degrees the two-pass kernels take (csrc/ntt_passes.cuh)


def split(n: int) -> tuple[int, int]:
    """(N1, N2) of the two passes: N1 = 2^floor(log2(N)/2), N2 = N/N1."""
    log_n = n.bit_length() - 1
    return 1 << (log_n // 2), 1 << (log_n - log_n // 2)


def inter_pass_twiddles(pows: np.ndarray, n: int) -> np.ndarray:
    """tw[..., k1·N2 + n2] = w^(k1·n2) from the root powers pows[..., i] = w^i."""
    n1, n2 = split(n)
    return pows[..., (np.arange(n1)[:, None] * np.arange(n2)[None, :]).reshape(-1)]


@table("ntt_kernel_tables")
def kernel_tables(plan: NttPlan, l: int, device: torch.device) -> dict[str, torch.Tensor]:
    """The plan's first ``l`` limbs on ``device``: moduli, Montgomery constants,
    and the twist, root and inter-pass twiddle powers in Montgomery form
    (int32 bit patterns)."""
    qs = plan.qs[:l]

    def mont(a):
        return u32_tensor(mont_form(a[:l], qs), device)

    return dict(
        q=u32_tensor(qs, device), qinv=u32_tensor(plan.qinv_neg[:l], device),
        psi=mont(plan.psi_pows), w=mont(plan.w_pows),
        winv=mont(plan.winv_pows), psiinv_ninv=mont(plan.psiinv_ninv),
        tw=mont(inter_pass_twiddles(plan.w_pows, plan.n)), twinv=mont(inter_pass_twiddles(plan.winv_pows, plan.n)),
    )


def check_size(n: int) -> None:
    if not (1 << MIN_LOG_N) <= n <= (1 << MAX_LOG_N) or n & (n - 1):
        raise ValueError(f"the CUDA NTT takes N = 2^{MIN_LOG_N} .. 2^{MAX_LOG_N}, got {n}")


def blocks_per_pass(rows: int, n: int) -> tuple[int, int]:
    """The thread blocks of pass 1 and pass 2 that ``ntt_launch`` starts for
    ``rows`` limbs of ``n``, as its launcher computes them (needs ``nvcc``)."""
    return pass_blocks(KERNEL.source, "ntt_blocks", rows, n.bit_length() - 1)


def _run_kernel(x: torch.Tensor, plan: NttPlan, inverse: bool) -> torch.Tensor:
    x = x.contiguous()
    dev = check_cuda(x)
    l, n = x.shape[-2:]
    if n != plan.n:
        raise ValueError(f"ring degree {n} does not match the plan's {plan.n}")
    check_size(n)
    t = kernel_tables(plan, l, dev)
    twist, roots, tw = (t["psiinv_ninv"], t["winv"], t["twinv"]) if inverse else (t["psi"], t["w"], t["tw"])
    out = torch.empty_like(x)
    scratch = torch.empty_like(x)  # pass 1's output, pass 2's input
    KERNEL.launch(dev, int(inverse), ptr(x), ptr(out), ptr(scratch), ptr(t["q"]), ptr(t["qinv"]), ptr(twist),
                  ptr(roots), ptr(tw), x.numel() // n, l, n, n.bit_length() - 1)
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
