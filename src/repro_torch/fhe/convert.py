"""Carry keys and ciphertexts in from host arrays (e.g. from the reference package).

Residues arrive as uint32 (or any integer) numpy arrays with values < 2^31 and
become int32 tensors on ``device``, bit for bit.
"""

from __future__ import annotations

import numpy as np

from . import poly
from .bgv import BgvCiphertext
from .keys import KeySet, PublicKey, SecretKey, SwitchingKey
from .ops import Ciphertext
from .params import CkksParams


def keyset_from_arrays(params: CkksParams, arrays: dict, device="cuda") -> KeySet:
    """Build a ``KeySet`` from {"s_coeff", "s_eval", "pk_b", "pk_a", "rlk"} host arrays,
    plus optionally "gks": {galois element t: key array of the rlk's shape}."""
    nall = len(params.all_primes)
    shapes = {
        "s_eval": (nall, params.n),
        "pk_b": (params.L + 1, params.n),
        "pk_a": (params.L + 1, params.n),
        "rlk": (params.num_digits, 2, nall, params.n),
    }
    for k, shape in shapes.items():
        if np.shape(arrays[k]) != shape:
            raise ValueError(f"{k} has shape {np.shape(arrays[k])}, expected {shape}")
    for t, k in arrays.get("gks", {}).items():
        if np.shape(k) != shapes["rlk"]:
            raise ValueError(f"galois key {t} has shape {np.shape(k)}, expected {shapes['rlk']}")
    t = {k: poly.residues(arrays[k], device) for k in shapes}
    return KeySet(
        sk=SecretKey(s_coeff=np.asarray(arrays["s_coeff"], np.int64), s_eval=t["s_eval"]),
        pk=PublicKey(b=t["pk_b"], a=t["pk_a"]),
        rlk=SwitchingKey(k=t["rlk"]),
        gks={int(g): SwitchingKey(k=poly.residues(k, device)) for g, k in arrays.get("gks", {}).items()},
    )


def _limbs(c0, c1, level: int, device):
    if np.shape(c0) != np.shape(c1) or np.shape(c0)[0] != level + 1:
        raise ValueError(f"c0 {np.shape(c0)} and c1 {np.shape(c1)} must both hold level+1 = {level + 1} limbs")
    return poly.residues(c0, device), poly.residues(c1, device)


def ciphertext_from_arrays(c0, c1, level: int, scale: float, device="cuda") -> Ciphertext:
    return Ciphertext(*_limbs(c0, c1, level, device), level=level, scale=scale)


def bgv_ciphertext_from_arrays(c0, c1, level: int, device="cuda") -> BgvCiphertext:
    """A reference ``BgvCiphertext``'s limbs (host arrays) as the port's."""
    return BgvCiphertext(*_limbs(c0, c1, level, device), level=level)
