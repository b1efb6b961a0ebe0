"""What every job of the program side shares: its parameters, the keys made from
the benchmark's secret, and the client's encryptions held in host memory."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.fhe import keys as K
from repro_torch.fhe import ops
from repro_torch.fhe import params as P
from repro_torch.fhe import poly


@dataclasses.dataclass
class HostCiphertext:
    """A ciphertext as the server receives or returns it: residues in host memory."""

    c0: torch.Tensor
    c1: torch.Tensor
    level: int
    scale: float


def params_of(cfg: dict) -> P.CkksParams:
    return P.make_params(cfg["n"], cfg["L"], cfg["dnum"], scale_bits=cfg["scale_bits"],
                         security_bits=cfg["security_bits"], check_security=cfg["check_security"])


def keyset(p: P.CkksParams, s: np.ndarray, key_seeds, rotations=(), device="cuda") -> K.KeySet:
    """The program's keys for the benchmark's secret s: its evaluation form, the
    public key, the relinearisation key and one Galois key a rotation's element."""
    s_rns = poly.residues(poly.to_rns_signed(s, p.all_primes), device)
    sk = K.SecretKey(s_coeff=s, s_eval=poly.to_eval(s_rns, p, tuple(range(len(p.all_primes)))))
    pk = K.pkgen(p, sk, key_seeds[0])
    rlk = K.relin_keygen(p, sk, key_seeds[1])
    gks = {t: K.galois_keygen(p, sk, t, key_seeds[2]) for t in K.galois_elements(p, tuple(rotations))}
    return K.KeySet(sk=sk, pk=pk, rlk=rlk, gks=gks)


def client_encrypt(ctx, z: np.ndarray, seed: int) -> HostCiphertext:
    """The client's encryption of the slots z at the top level, copied to host memory."""
    ct = ctx.encrypt(ctx.encode(z), seed=seed)
    return HostCiphertext(ct.c0.cpu(), ct.c1.cpu(), ct.level, ct.scale)


def upload(host: HostCiphertext, device) -> ops.Ciphertext:
    return ops.Ciphertext(c0=host.c0.to(device), c1=host.c1.to(device), level=host.level, scale=host.scale)


def download(ct: ops.Ciphertext) -> HostCiphertext:
    """Copy the answer to host memory; returns once the copy has finished."""
    return HostCiphertext(ct.c0.cpu(), ct.c1.cpu(), ct.level, ct.scale)
