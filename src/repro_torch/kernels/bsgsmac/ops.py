"""The diagonal products and sums of a BSGS matvec, every giant group in one launch.

``bsgs_mac`` computes, for each giant group g, Σ_d diag_d ∘ baby_{b(d)} mod q
per limb over both components of the babies: on a CUDA tensor one launch of
``csrc/bsgsmac.cu`` (or an exception), on a CPU tensor the plain version in
``ref``.  Either way each call records one ``bsgsmac`` dispatch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.cuda import I, P, CudaKernel, check_cuda, ptr
from repro_torch.kernels.modops import ops as mo

from . import ref as _ref

KERNEL = CudaKernel("bsgs_mac", "bsgsmac.cu", "bsgs_mac_launch", [P, P, P, P, I, I, I, P, P, P, P])


def bsgs_mac(diags, babies, baby_idx, offsets, qs):
    """Σ over each giant group of its diagonals times their babies, mod q per limb.

    diags: (D, l, N) int32, the rows of giant group g being
    ``offsets[g]:offsets[g+1]``; babies: (B, 2, l, N) int32, c0 and c1 of each
    baby rotation; baby_idx: (D,) int32, the row of ``babies`` that diagonal d
    multiplies; offsets: (G+1,) int32 with offsets[0] = 0 and offsets[G] = D;
    qs: (l,) moduli.  Returns (G, 2, l, N) int32.
    """
    dispatch.record("bsgsmac")
    if diags.device.type == "cpu":
        return _ref.bsgs_mac_ref(diags, babies, baby_idx, offsets, qs)
    dev = check_cuda(diags, babies, baby_idx, offsets)
    d, l, n = diags.shape
    giants = offsets.numel() - 1
    if babies.dim() != 4 or tuple(babies.shape[1:]) != (2, l, n) or baby_idx.shape != (d,) or giants < 1:
        raise ValueError(f"bsgs_mac wants diags (D, l, N), babies (B, 2, l, N), baby_idx (D,) and offsets (G+1,), "
                         f"got {tuple(diags.shape)}, {tuple(babies.shape)}, {tuple(baby_idx.shape)}, "
                         f"{tuple(offsets.shape)}")
    if n % 4 or diags.data_ptr() % 16 or babies.data_ptr() % 16:
        raise ValueError(f"bsgs_mac needs N % 4 == 0 and 16-byte aligned operands, got N = {n}")
    q, qinv, r2 = mo.constants(tuple(int(v) for v in qs), dev)
    if q.numel() != l:
        raise ValueError(f"{q.numel()} moduli for {l} limbs")
    out = torch.empty((giants, 2, l, n), dtype=torch.int32, device=dev)
    KERNEL.launch(dev, ptr(diags), ptr(babies), ptr(baby_idx), ptr(offsets), giants, l, n, ptr(q), ptr(qinv),
                  ptr(r2), ptr(out))
    return out
