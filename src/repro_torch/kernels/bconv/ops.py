"""Fast basis conversion for the staged key-switch pipeline.

Only the plain version exists so far: the Hopper kernel that replaces the TPU
kernel ``bconv_pallas`` is ROADMAP Queue 2 item 3.  A CUDA tensor raises
rather than running the plain version on the card.
"""

from __future__ import annotations

from repro_torch.kernels import dispatch

from . import ref as _ref


def bconv(xhat, w, cs):
    """xhat: (k, N) int32 input limbs already scaled by [B̂_i^{-1}]_{b_i};
    w: (k, m) — W[i, j] = B̂_i mod c_j; cs: (m,) target moduli.  Returns (m, N) int32.
    """
    if xhat.device.type != "cpu":
        raise NotImplementedError(
            "bconv has no CUDA kernel yet (ROADMAP Queue 2 item 3); "
            "the fused key-switch pipeline runs on the card"
        )
    dispatch.record("bconv")
    return _ref.bconv_ref(xhat, w, cs)
