"""The CKKS rescale of both components of a ciphertext in one call.

``rescale`` divides a ciphertext by its last modulus q_ℓ and drops that limb:
on a CUDA tensor one call of ``fused_rescale_launch`` in ``csrc/rescale.cu``,
which starts four kernels (the inverse NTT's two passes over the two dropped
limbs, then a ModDown-shaped pass A and pass B over both components), or an
exception; on a CPU tensor the plain version in ``ref``.  Either way each call
records one ``rescale`` dispatch.

Tables are kept per (params, level, device) (``kernels.tables``).
"""

from __future__ import annotations

import torch

from repro_torch.fhe import modmath as mm
from repro_torch.fhe import poly
from repro_torch.fhe.params import CkksParams
from repro_torch.kernels import dispatch
from repro_torch.kernels.cuda import I, P, CudaKernel, check_cuda, mont_form, ptr, u32_tensor
from repro_torch.kernels.ntt import ops as ntt_ops
from repro_torch.kernels.tables import table

from . import ref as _ref

KERNEL = CudaKernel("fused_rescale", "rescale.cu", "fused_rescale_launch",
                    [P, P, I, P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, P])


@table("fused_rescale_tables")
def tables(params: CkksParams, level: int, device: torch.device) -> dict:
    """Constants of ``fused_rescale`` from ``level`` down: the q-basis NTT
    tables at level − 1, the dropped limb's inverse-NTT tables, q_ℓ with its
    Montgomery constant and half, q_e − (q_ℓ mod q_e) and [q_ℓ⁻¹]_{q_e}·R."""
    q_last = int(params.q_primes[level])
    qs = params.q_primes[:level]
    nt = ntt_ops.kernel_tables(poly.plan_for(params, poly.q_idx(params, level - 1)), level, device)
    lt = ntt_ops.kernel_tables(poly.plan_for(params, (level,)), 1, device)
    last_qinv = int(mm.mont_constants_array((q_last,))["qinv_neg"][0])
    return dict(q=nt["q"], qinv=nt["qinv"], psi=nt["psi"], roots=nt["w"], tw=nt["tw"],
                last=u32_tensor([q_last, last_qinv, q_last // 2], device),
                twinv_l=lt["twinv"], winv_l=lt["winv"], twist_l=lt["psiinv_ninv"],
                neg=u32_tensor([q - q_last % q for q in qs], device),
                qlinv=u32_tensor(mont_form([pow(q_last % q, -1, q) for q in qs], qs), device))


def rescale(c0, c1, params: CkksParams, level: int):
    """(c − NTT(centred(iNTT(c[ℓ])))) · q_ℓ⁻¹ over q_0..q_{ℓ−1}, both components.

    c0, c1: (level+1, N) int32 eval-domain.  Returns the two (level, N) int32
    components.
    """
    dispatch.record("rescale")
    if c0.device.type == "cpu":
        return _ref.rescale_ref(c0, c1, params, level)
    c0, c1 = c0.contiguous(), c1.contiguous()
    dev = check_cuda(c0, c1)
    n = params.n
    if level < 1 or c0.shape != (level + 1, n) or c1.shape != (level + 1, n):
        raise ValueError(f"fused_rescale wants two ({level + 1}, {n}) components at level {level} >= 1, "
                         f"got {tuple(c0.shape)} and {tuple(c1.shape)}")
    ntt_ops.check_size(n)
    t = tables(params, level, dev)
    out0 = torch.empty((level, n), dtype=torch.int32, device=dev)
    out1 = torch.empty_like(out0)
    work = torch.empty((2 * level + 4, n), dtype=torch.int32, device=dev)  # pass A's scratch, the iNTT's two
    KERNEL.launch(
        dev, ptr(c0), ptr(c1), level, ptr(t["last"]), ptr(t["twinv_l"]), ptr(t["winv_l"]), ptr(t["twist_l"]),
        ptr(t["q"]), ptr(t["qinv"]), ptr(t["neg"]), ptr(t["psi"]), ptr(t["roots"]), ptr(t["tw"]), ptr(t["qlinv"]),
        ptr(out0), ptr(out1), ptr(work), n, n.bit_length() - 1,
    )
    return out0, out1
