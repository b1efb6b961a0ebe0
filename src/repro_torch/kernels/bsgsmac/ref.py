"""Plain PyTorch version of the BSGS diagonal products and sums (int64 arithmetic).

Each giant group's Σ diag[d] ∘ baby[baby_idx[d]] mod q per limb, for both
components of the babies: the residues the reference's ``mulmod``/``addmod``
chain gives, since modular sums are exact.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.modops.ref import limb_moduli


def bsgs_mac_ref(diags, babies, baby_idx, offsets, qs):
    """diags (D, l, N), babies (B, 2, l, N) int32; baby_idx (D,) and offsets
    (G+1,) int32; qs: (l,) moduli.  Returns (G, 2, l, N) int32."""
    q = limb_moduli(qs, diags)
    rows, off = baby_idx.tolist(), offsets.tolist()
    out = torch.empty((len(off) - 1,) + tuple(babies.shape[1:]), dtype=torch.int32, device=diags.device)
    for g, (a, b) in enumerate(zip(off, off[1:])):
        acc = torch.zeros(out.shape[1:], dtype=torch.int64, device=diags.device)
        for d in range(a, b):
            acc += diags[d].long() * babies[rows[d]].long() % q
        out[g] = (acc % q).int()
    return out
