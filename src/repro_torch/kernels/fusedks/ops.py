"""The fused key-switch ops: table building and kernel / plain dispatch.

``key_switch_digits`` covers the per-digit prescale→BConv→NTT→MAC region of a
hybrid key-switch (everything between the shared iNTT and ModDown);
``mod_down_digits`` covers the prescale→BConv→NTT→(sub, ×P⁻¹) region of
ModDown for a batch of accumulators.  On a CUDA tensor each is one call of
its C entry in ``csrc/fusedks.cu`` — ``fused_ks_launch`` and
``fused_moddown_launch`` each start two kernels (the two NTT passes, many
blocks per limb) — and counts one launch; on a CPU tensor the plain staged
composition in ``ref`` runs.  Either way each call records one dispatch.

Tables are kept per (params, level, device) (``kernels.tables``): the Montgomery
forms of ``fhe.rns.digit_tables``/``moddown_tables``, and the NTT tables of the
target basis.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.fhe import modmath as mm
from repro_torch.fhe import poly, rns
from repro_torch.fhe.params import CkksParams
from repro_torch.kernels import dispatch
from repro_torch.kernels.cuda import I, P, CudaKernel, check_cuda, mont_form, pass_blocks, ptr, u32_tensor
from repro_torch.kernels.ntt import ops as ntt_ops
from repro_torch.kernels.tables import table

from . import ref as _ref

FUSED_KS = CudaKernel("fused_ks", "fusedks.cu", "fused_ks_launch",
                      [P, I, I, I, P, P, P, P, P, I, P, P, P, P, P, P, I, I, P])
FUSED_MODDOWN = CudaKernel("fused_moddown", "fusedks.cu", "fused_moddown_launch",
                           [P, I, I, P, P, P, P, I, P, P, P, P, P, P, P, P, P, I, I, P])


@table("fused_ks_tables")
def ks_tables(params: CkksParams, level: int, device: torch.device) -> dict:
    """Constants of ``fused_ks`` at ``level``: source limb s (of the q basis)
    gets its digit's [B̂_s⁻¹]·R and the row (B̂_s mod c_e)·R over the extended basis."""
    ext = poly.ext_idx(params, level)
    ext_primes = poly.primes_for(params, ext)
    nq = level + 1
    bh = np.zeros(nq, np.uint64)
    w = np.zeros((nq, len(ext)), np.uint64)
    for j in range(params.beta(level)):
        limbs, src, _, bhat_inv, wj = rns.digit_tables(params, level, j)
        bh[limbs[0] : limbs[-1] + 1] = mont_form(bhat_inv, src)
        w[limbs[0] : limbs[-1] + 1] = mont_form(wj.T, ext_primes).T
    nt = ntt_ops.kernel_tables(poly.plan_for(params, ext), len(ext), device)
    return dict(q=nt["q"], qinv=nt["qinv"], psi=nt["psi"], roots=nt["w"], tw=nt["tw"],
                r2=u32_tensor(mm.mont_constants_array(ext_primes)["r2"], device),
                bh=u32_tensor(bh, device), w=u32_tensor(w, device))


@table("fused_moddown_tables")
def moddown_tables(params: CkksParams, level: int, device: torch.device) -> dict:
    """Constants of ``fused_moddown`` at ``level``: the special block's prescale,
    its BConv rows to the q basis, [P⁻¹]_{q_e} (all ·R) and the q-basis NTT tables,
    inter-pass twiddles included."""
    p_primes, q_primes, bhat_inv, w, pinv = rns.moddown_tables(params, level)
    pc = mm.mont_constants_array(p_primes)
    nt = ntt_ops.kernel_tables(poly.plan_for(params, poly.q_idx(params, level)), len(q_primes), device)
    return dict(q=nt["q"], qinv=nt["qinv"], psi=nt["psi"], roots=nt["w"], tw=nt["tw"],
                p_q=u32_tensor(pc["q"], device), p_qinv=u32_tensor(pc["qinv_neg"], device),
                bh=u32_tensor(mont_form(bhat_inv, p_primes), device),
                w=u32_tensor(mont_form(w.T, q_primes).T, device),
                pinv=u32_tensor(mont_form(pinv, q_primes), device))


def key_switch_digits(d_coeff, ksk_sel, params: CkksParams, level: int):
    """Σ_j NTT(BConv(d̂_j)) ∘ ksk_j over the extended basis, both components.

    d_coeff: (level+1, N) coefficient-domain limbs; ksk_sel: (β, 2, m, N)
    eval-domain key limbs restricted to the active extended basis.
    Returns (acc0, acc1), each (m, N) int32 eval-domain.
    """
    dispatch.record("fusedks")
    if d_coeff.device.type == "cpu":
        return _ref.key_switch_digits_ref(d_coeff, ksk_sel, params, level)
    d_coeff, ksk_sel = d_coeff.contiguous(), ksk_sel.contiguous()
    dev = check_cuda(d_coeff, ksk_sel)
    n, nq, beta = params.n, level + 1, params.beta(level)
    m = nq + params.alpha
    if d_coeff.shape != (nq, n) or ksk_sel.shape != (beta, 2, m, n):
        raise ValueError(f"fused_ks wants d (nq={nq}, {n}) and ksk ({beta}, 2, {m}, {n}), "
                         f"got {tuple(d_coeff.shape)} and {tuple(ksk_sel.shape)}")
    ntt_ops.check_size(n)
    t = ks_tables(params, level, dev)
    out = torch.empty((m, 2, n), dtype=torch.int32, device=dev)
    scratch = torch.empty((beta, m, n), dtype=torch.int32, device=dev)  # pass A's output, pass B's input
    FUSED_KS.launch(
        dev, ptr(d_coeff), nq, params.alpha, beta, ptr(t["q"]), ptr(t["qinv"]), ptr(t["r2"]),
        ptr(t["bh"]), ptr(t["w"]), m, ptr(t["psi"]), ptr(t["roots"]), ptr(t["tw"]), ptr(ksk_sel), ptr(out),
        ptr(scratch), n, n.bit_length() - 1,
    )
    return out[:, 0], out[:, 1]


def ks_blocks_per_pass(beta: int, m: int, n: int) -> tuple[int, int]:
    """The thread blocks of pass A and pass B that ``fused_ks_launch`` starts
    for β digits over m extended limbs of ``n``, as its launcher computes them
    (needs ``nvcc``)."""
    return pass_blocks(FUSED_KS.source, "fused_ks_blocks", beta, m, n.bit_length() - 1)


def mod_down_digits(p_coeff, q_part, params: CkksParams, level: int):
    """Fused ModDown tail for a batch of accumulators.

    p_coeff: (C, α, N) coefficient-domain P-block limbs (post-iNTT);
    q_part: (C, level+1, N) eval-domain q limbs.  Returns (C, level+1, N).
    """
    dispatch.record("fused_moddown")
    if p_coeff.device.type == "cpu":
        return _ref.mod_down_digits_ref(p_coeff, q_part, params, level)
    p_coeff, q_part = p_coeff.contiguous(), q_part.contiguous()
    dev = check_cuda(p_coeff, q_part)
    n, nq, alpha = params.n, level + 1, params.alpha
    n_acc = p_coeff.shape[0]
    if p_coeff.shape != (n_acc, alpha, n) or q_part.shape != (n_acc, nq, n):
        raise ValueError(f"fused_moddown wants ({n_acc}, {alpha}, {n}) and ({n_acc}, {nq}, {n}), "
                         f"got {tuple(p_coeff.shape)} and {tuple(q_part.shape)}")
    ntt_ops.check_size(n)
    t = moddown_tables(params, level, dev)
    out = torch.empty_like(q_part)
    scratch = torch.empty_like(q_part)  # pass A's output, pass B's input
    FUSED_MODDOWN.launch(
        dev, ptr(p_coeff), n_acc, alpha, ptr(t["p_q"]), ptr(t["p_qinv"]), ptr(t["bh"]), ptr(t["w"]), nq,
        ptr(t["q"]), ptr(t["qinv"]), ptr(t["psi"]), ptr(t["roots"]), ptr(t["tw"]), ptr(q_part), ptr(t["pinv"]),
        ptr(out), ptr(scratch), n, n.bit_length() - 1,
    )
    return out


def moddown_blocks_per_pass(n_acc: int, nq: int, n: int) -> tuple[int, int]:
    """The thread blocks of pass A and pass B that ``fused_moddown_launch``
    starts for ``n_acc`` accumulators of nq q limbs of ``n``, as its launcher
    computes them (needs ``nvcc``)."""
    return pass_blocks(FUSED_MODDOWN.source, "fused_moddown_blocks", n_acc, nq, n.bit_length() - 1)
