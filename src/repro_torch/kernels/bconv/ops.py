"""Fast basis conversion for the staged key-switch pipeline.

On a CPU tensor the plain version (``ref``) runs; on a CUDA tensor the
``csrc/bconv.cu`` kernel launches once per call, or the call raises.  Each
call records one ``bconv`` dispatch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.fhe import modmath as mm
from repro_torch.kernels import dispatch
from repro_torch.kernels.cuda import I, P, CudaKernel, check_cuda, mont_form, ptr, u32_tensor

from . import ref as _ref

KERNEL = CudaKernel("bconv", "bconv.cu", "bconv_launch", [P, I, P, I, P, P, P, I, P])


@functools.lru_cache(maxsize=1024)
def _tables(w_bytes: bytes, k: int, cs: tuple[int, ...], device: torch.device):
    """The weights in Montgomery form per target limb (W[i, j]·R mod c_j) and the targets' constants."""
    w = np.frombuffer(w_bytes, np.uint64).reshape(k, len(cs))
    c = mm.mont_constants_array(cs)
    return (u32_tensor(mont_form(w.T, cs).T, device), u32_tensor(c["q"], device),
            u32_tensor(c["qinv_neg"], device))


def bconv(xhat, w, cs):
    """xhat: (k, N) int32 input limbs already scaled by [B̂_i^{-1}]_{b_i};
    w: (k, m) — W[i, j] = B̂_i mod c_j; cs: (m,) target moduli.  Returns (m, N) int32.
    """
    dispatch.record("bconv")
    if xhat.device.type == "cpu":
        return _ref.bconv_ref(xhat, w, cs)
    xhat = xhat.contiguous()
    dev = check_cuda(xhat)
    cs = tuple(int(c) for c in np.asarray(cs).reshape(-1))
    w = np.ascontiguousarray(np.asarray(w, np.uint64))
    k, n = xhat.shape
    if w.shape != (k, len(cs)):
        raise ValueError(f"bconv wants w of shape ({k}, {len(cs)}), got {w.shape}")
    w_m, c, cinv = _tables(w.tobytes(), k, cs, dev)
    out = torch.empty((len(cs), n), dtype=torch.int32, device=dev)
    KERNEL.launch(dev, ptr(xhat), k, ptr(w_m), len(cs), ptr(c), ptr(cinv), ptr(out), n)
    return out
