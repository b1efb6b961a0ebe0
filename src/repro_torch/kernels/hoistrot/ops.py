"""Hoisted-rotation ops: the shared ModUp and the batched Galois MAC.

``mod_up_digits`` raises all β digits of one polynomial to the extended basis
(one launch, the digits materialised for reuse); ``galois_mac`` applies every
Galois key of a rotation group against those digits in one launch.  On a CUDA
tensor each is ONE call of its C entry in ``csrc/hoistrot.cu`` —
``hoist_modup_launch`` starts two kernels (the two NTT passes, many blocks per
limb), ``hoist_mac_launch`` one — and counts one launch; on a CPU tensor the
plain version in ``ref`` runs.  Either way each call records one dispatch
(``hoistmodup``/``hoistmac``).  ``galois_mac(staged=True)`` is the staged
pipeline's per-op MAC instead: one ``mulmod``/``addmod`` dispatch per step.

The ModUp half of a hoisted rotation is the fused key-switch digit region
without the MAC epilogue, so its tables are ``fusedks.ops.ks_tables``.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.fhe.params import CkksParams
from repro_torch.kernels import dispatch
from repro_torch.kernels.cuda import I, P, CudaKernel, check_cuda, library, pass_blocks, ptr
from repro_torch.kernels.fusedks import ops as fused_ops
from repro_torch.kernels.modops import ops as mo
from repro_torch.kernels.ntt import ops as ntt_ops

from . import ref as _ref

HOIST_MODUP = CudaKernel("hoist_modup", "hoistrot.cu", "hoist_modup_launch",
                         [P, I, I, I, P, P, P, P, I, P, P, P, P, P, I, I, P])
HOIST_MAC = CudaKernel("hoist_mac", "hoistrot.cu", "hoist_mac_launch", [P, P, I, I, I, P, P, P, P, I, P])


@functools.cache
def max_beta() -> int:
    """The largest digit count ``hoist_mac_launch`` is instantiated for
    (``MAX_BETA`` of ``csrc/hoistrot.cu``, read from the built library)."""
    return int(library(HOIST_MAC.source).hoist_mac_max_beta())


def mod_up_digits(d_coeff, params: CkksParams, level: int):
    """prescale→BConv→NTT for all β digits of one polynomial, ONE launch.

    d_coeff: (level+1, N) coefficient-domain limbs.  Returns (β, m, N) int32
    eval-domain digits over the extended basis — the reusable ModUp half of a
    key-switch, shared by a whole hoisted group.
    """
    dispatch.record("hoistmodup")
    if d_coeff.device.type == "cpu":
        return _ref.mod_up_digits_ref(d_coeff, params, level)
    d_coeff = d_coeff.contiguous()
    dev = check_cuda(d_coeff)
    n, nq, beta = params.n, level + 1, params.beta(level)
    m = nq + params.alpha
    if d_coeff.shape != (nq, n):
        raise ValueError(f"hoist_modup wants d ({nq}, {n}), got {tuple(d_coeff.shape)}")
    ntt_ops.check_size(n)
    t = fused_ops.ks_tables(params, level, dev)
    out = torch.empty((beta, m, n), dtype=torch.int32, device=dev)
    scratch = torch.empty_like(out)  # pass A's output, pass B's input
    HOIST_MODUP.launch(dev, ptr(d_coeff), nq, params.alpha, beta, ptr(t["q"]), ptr(t["qinv"]), ptr(t["bh"]),
                       ptr(t["w"]), m, ptr(t["psi"]), ptr(t["roots"]), ptr(t["tw"]), ptr(out), ptr(scratch), n,
                       n.bit_length() - 1)
    return out


def modup_blocks_per_pass(beta: int, m: int, n: int) -> tuple[int, int]:
    """The thread blocks of pass A and pass B that ``hoist_modup_launch``
    starts for β digits over m extended limbs of ``n``, as its launcher
    computes them (needs ``nvcc``)."""
    return pass_blocks(HOIST_MODUP.source, "hoist_modup_blocks", beta, m, n.bit_length() - 1)


def galois_mac(dig, ksk, params: CkksParams, level: int, staged: bool = False):
    """KSK inner products of one hoisted group: all rotations, ONE launch.

    dig: (β, m, N) hoisted digits (eval, extended basis); ksk: (R, β, 2, m, N)
    σ_t^{-1}-pre-permuted key limbs.  Returns (R, 2, m, N) accumulator pairs.
    ``staged=True`` runs the per-op composition instead (the staged
    pipeline's semantics), one modops dispatch per step.
    """
    if staged:
        return _ref.galois_mac_ref(dig, ksk, params, level, mo.pointwise_mulmod, mo.pointwise_addmod)
    dispatch.record("hoistmac")
    if dig.device.type == "cpu":
        return _ref.galois_mac_ref(dig, ksk, params, level)
    dig, ksk = dig.contiguous(), ksk.contiguous()
    dev = check_cuda(dig, ksk)
    beta, m, n = dig.shape
    nrot = ksk.shape[0]
    if ksk.shape != (nrot, beta, 2, m, n) or beta != params.beta(level) or m != level + 1 + params.alpha:
        raise ValueError(f"hoist_mac wants dig ({params.beta(level)}, {level + 1 + params.alpha}, {params.n}) and "
                         f"ksk (R, β, 2, m, N), got {tuple(dig.shape)} and {tuple(ksk.shape)}")
    if not 1 <= beta <= max_beta():
        raise ValueError(f"hoist_mac is built for 1 to {max_beta()} digits, got {beta}")
    t = fused_ops.ks_tables(params, level, dev)
    out = torch.empty((nrot, 2, m, n), dtype=torch.int32, device=dev)
    HOIST_MAC.launch(dev, ptr(dig), ptr(ksk), beta, nrot, m, ptr(t["q"]), ptr(t["qinv"]), ptr(t["r2"]), ptr(out), n)
    return out
