"""Polynomial-domain helpers shared by the CKKS ops.

A polynomial is a (limbs, N) int32 tensor of RNS residues, either in
coefficient domain or evaluation (NTT) domain.  Which master-chain limbs a
tensor carries is tracked by the caller via index tuples from `q_idx`/`ext_idx`;
NTT plans restricted to those limbs come from `plan_for`.  The tables here
(`plan_for`, `eval_perm`, `limb_column`) are kept by `kernels.tables`.

Every domain crossing records an instruction into the ambient trace, as in
the reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ntt import ops as ntt_ops
from repro_torch.kernels.tables import table

from . import ntt as nttmod
from . import trace
from .params import CkksParams


def q_idx(params: CkksParams, level: int) -> tuple[int, ...]:
    """Master-chain indices of the ciphertext basis at ``level``."""
    return tuple(range(level + 1))


def p_idx(params: CkksParams) -> tuple[int, ...]:
    """Master-chain indices of the special (key) modulus block."""
    return tuple(range(params.L + 1, params.L + 1 + params.alpha))


def ext_idx(params: CkksParams, level: int) -> tuple[int, ...]:
    """Extended basis {q_0..q_level} ∪ {p_0..p_α-1}."""
    return q_idx(params, level) + p_idx(params)


@table("plan_for")
def plan_for(params: CkksParams, idx: tuple[int, ...]) -> nttmod.NttPlan:
    """The NTT plan of the master-chain limbs ``idx``."""
    return nttmod.subplan(params.n, params.all_primes, idx)


def primes_for(params: CkksParams, idx: tuple[int, ...]) -> tuple[int, ...]:
    allp = params.all_primes
    return tuple(allp[i] for i in idx)


@table("limb_column")
def limb_column(values: tuple[int, ...], dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """One integer per limb as a (k, 1) ``dtype`` column on ``device``: per-limb
    constants, or the moduli themselves."""
    return torch.tensor(values, dtype=dtype, device=device)[:, None]


def residues(a: np.ndarray, device) -> torch.Tensor:
    """Host residues (uint32 values < 2^31) → an int32 tensor on ``device``."""
    return torch.from_numpy(np.asarray(a).astype(np.int32)).to(device)


def to_eval(x: torch.Tensor, params: CkksParams, idx: tuple[int, ...]) -> torch.Tensor:
    """Coefficient → evaluation domain over the limb subset ``idx``."""
    trace.record("NTT", params.n, len(idx))
    return ntt_ops.ntt_fwd(x, plan_for(params, idx))


def to_coeff(x: torch.Tensor, params: CkksParams, idx: tuple[int, ...]) -> torch.Tensor:
    """Evaluation → coefficient domain over the limb subset ``idx``."""
    trace.record("INTT", params.n, len(idx))
    return ntt_ops.ntt_inv(x, plan_for(params, idx))


@table("eval_perm")
def _eval_perm(n: int, t: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(nttmod.galois_eval_perm(n, t).astype(np.int64)).to(device)


def eval_perm(n: int, t: int, device) -> torch.Tensor:
    """The slot permutation of σ_t (``fhe.ntt.galois_eval_perm``) as an index tensor on ``device``."""
    return _eval_perm(n, t, torch.device(device))


def automorphism_eval(x: torch.Tensor, n: int, t: int) -> torch.Tensor:
    """σ_t in the evaluation domain — a pure slot permutation (the paper's AUTO unit)."""
    trace.record("AUTO", n, x.shape[-2] if x.dim() >= 2 else 1)
    return torch.index_select(x, -1, eval_perm(n, t, x.device))


def sample_ternary(rng: np.random.Generator, n: int, h: int) -> np.ndarray:
    """Ternary secret with hamming weight h (int64 coefficients in {-1,0,1})."""
    s = np.zeros(n, np.int64)
    pos = rng.choice(n, size=h, replace=False)
    s[pos] = rng.choice(np.array([-1, 1]), size=h)
    return s


def sample_gaussian(rng: np.random.Generator, n: int, sigma: float = 3.2) -> np.ndarray:
    return np.rint(rng.normal(0.0, sigma, size=n)).astype(np.int64)


def to_rns_signed(v: np.ndarray, primes) -> np.ndarray:
    """Signed int64 coefficients → (limbs, N) uint32 residues."""
    out = np.empty((len(primes), v.shape[-1]), np.uint32)
    for i, p in enumerate(primes):
        out[i] = np.mod(v, np.int64(p)).astype(np.uint32)
    return out
