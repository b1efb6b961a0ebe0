"""Plain PyTorch versions of the limb-wise modular ops (int64 arithmetic).

Residues are int32 tensors < 2^31, so a product of two fits int64 exactly.
``qs`` holds one modulus per limb (the second-to-last axis).
"""

from __future__ import annotations

import numpy as np
import torch


def limb_moduli(qs, like: torch.Tensor) -> torch.Tensor:
    """(l,) moduli → an (l, 1) int64 tensor on ``like``'s device."""
    return torch.as_tensor(np.asarray(qs, np.int64).reshape(-1, 1), device=like.device)


def mulmod_ref(a, b, qs):
    q = limb_moduli(qs, a)
    return (a.long() * b.long() % q).int()


def addmod_ref(a, b, qs):
    q = limb_moduli(qs, a)
    s = a.long() + b.long()
    return torch.where(s >= q, s - q, s).int()


def submod_ref(a, b, qs):
    q = limb_moduli(qs, a)
    a, b = a.long(), b.long()
    return torch.where(a >= b, a - b, a + q - b).int()
