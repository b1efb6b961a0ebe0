"""Fast basis conversion for the staged key-switch pipeline.

On a CPU tensor the plain version (``ref``) runs; on a CUDA tensor the
``csrc/bconv.cu`` kernel launches once per call, or the call raises.  Each
call records one ``bconv`` dispatch.

The kernel takes the k·m products on the int8 tensor cores as the byte
products P_ab = Σ_s byte_a(x̂[s])·byte_b(W[s, j]) and reduces each output once:
Σ_{a,b} P_ab·C_m[j, a + b]·R^{-1} mod c_j, with C_m[j, d] = 2^(8d)·R mod c_j.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.fhe import modmath as mm
from repro_torch.kernels import dispatch, tables
from repro_torch.kernels.cuda import I, P, CudaKernel, check_cuda, pass_blocks, ptr, u32_tensor

from . import ref as _ref

KERNEL = CudaKernel("bconv", "bconv.cu", "bconv_launch", [P, I, P, I, P, I])
MAX_K = 64  # source limbs: Σ_{a,b} P_ab·C_m[j, a + b] < 16·k·255²·c_j stays below c_j·2^32
COEFFS = 128  # coefficients of one thread block; N must be a multiple
KSTEP = 32  # source limbs of one tensor-core product
NDIAG = 7  # byte diagonals of a 32 × 32-bit product
ROW_TAIL = 16  # words after a target's B words: C_m (8), c, −c^{-1}, zeros


def b_words(w: np.ndarray) -> np.ndarray:
    """The kernel's B words of W (k, m): (m, ceil(k / 32), 4, 4, 2) uint32, where
    [j, ks, t, b, h] has byte e = byte b of W[32·ks + 16·h + 4·t + e, j] (0 past row k)."""
    k, m = w.shape
    ks = -(-k // KSTEP)
    wp = np.zeros((ks * KSTEP, m), np.uint64)
    wp[:k] = w
    v = wp.reshape(ks, 2, 4, 4, m)  # [ks, h, t, e, j]
    planes = (v[..., None] >> (8 * np.arange(4, dtype=np.uint64))) & np.uint64(0xFF)  # [ks, h, t, e, j, b]
    words = (planes << (8 * np.arange(4, dtype=np.uint64))[None, None, None, :, None, None]).sum(axis=3)
    return words.transpose(3, 0, 2, 4, 1).astype(np.uint32)  # [j, ks, t, b, h]


def diag_constants(cs) -> np.ndarray:
    """(m, 8) uint64: C_m[j, d] = 2^(8d)·R mod c_j for d < 7, and C_m[j, 7] = 0."""
    cm = np.zeros((len(cs), 8), np.uint64)
    for j, c in enumerate(cs):
        cm[j, :NDIAG] = [(1 << (8 * d + 32)) % int(c) for d in range(NDIAG)]
    return cm


def table(w: np.ndarray, cs) -> np.ndarray:
    """The kernel's table, one row per target j: its B words (``b_words``), then
    C_m[j] (8), c_j, −c_j^{-1} mod 2^32 and 6 zeros.  (m, 32·ceil(k / 32) + 16) uint32."""
    m = len(cs)
    c = mm.mont_constants_array(cs)
    tail = np.zeros((m, ROW_TAIL), np.uint64)
    tail[:, :8] = diag_constants(cs)
    tail[:, 8], tail[:, 9] = c["q"], c["qinv_neg"]
    return np.concatenate([b_words(w).reshape(m, -1).astype(np.uint64), tail], axis=1).astype(np.uint32)


@tables.table("bconv_table")
def device_table(w_bytes: bytes, k: int, cs: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``table`` of W (k, len(cs)) uint64, given as its bytes, on ``device``."""
    return u32_tensor(table(np.frombuffer(w_bytes, np.uint64).reshape(k, len(cs)), cs), device)


def bconv(xhat, w, cs):
    """xhat: (k, N) int32 input limbs already scaled by [B̂_i^{-1}]_{b_i};
    w: (k, m) — W[i, j] = B̂_i mod c_j; cs: (m,) target moduli.  Returns (m, N) int32.

    On the card k ≤ 64 and N a multiple of 128; anything else raises.
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
    if not 1 <= k <= MAX_K or n % COEFFS:
        raise ValueError(f"bconv kernel takes 1 ≤ k ≤ {MAX_K} source limbs and N a multiple of {COEFFS}, "
                         f"got k = {k}, N = {n}")
    tab = device_table(w.tobytes(), k, cs, dev)
    out = torch.empty((len(cs), n), dtype=torch.int32, device=dev)
    KERNEL.launch(dev, ptr(xhat), k, ptr(tab), len(cs), ptr(out), n)
    return out


def bconv_blocks(k: int, m: int, n: int) -> tuple[int, int]:
    """The grid ``bconv_launch`` starts for k → m limbs of ``n`` coefficients:
    (coefficient blocks, target chunks), as its launcher computes it (needs ``nvcc``)."""
    return pass_blocks(KERNEL.source, "bconv_blocks", k, m, n)
