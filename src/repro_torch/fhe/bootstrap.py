"""CKKS bootstrapping: ModRaise → CoeffToSlot → EvalMod → SlotToCoeff.

Full-slot ("packed") bootstrapping per the paper's Packed Bootstrapping
workload: all N/2 slots are used, so CoeffToSlot produces two ciphertexts
(first/second half of the coefficient vector) and EvalMod runs on both.

The homomorphic pipeline here is exactly the instruction mix the paper's
bootstrappable clusters are provisioned for: BSGS rotations (key-switch =
iNTT→BConv→NTT) dominate CtS/StC, and EvalMod is a Chebyshev ladder of
ct×ct multiplications (each with a relinearisation key-switch).

Math summary: with E0[j,i] = ζ^{g_j·i} (i < n), E1 the second half, and
z = slots of the ModRaise'd ciphertext, the coefficient halves are
a0 = Re(A0·z), a1 = Re(A1·z) with A{0,1} = (2/N)·E{0,1}^H.  EvalMod applies
(q0/2πΔ)·sin(2π·a/q0) via Chebyshev on [-(K+½)θ, (K+½)θ], θ = q0/Δ.

``BootstrapContext`` holds the precomputes (params, keys, BSGS plans, sine
coefficients); *how* to execute comes from an ``FheContext``:
``fhe_ctx.bootstrap(bctx, ct)`` is the primary API, with the policy choosing
the key-switch pipeline and whether CtS/StC baby groups hoist.  The keys, and
so every tensor of a bootstrap, live on the device ``build_context`` was
given ("cuda" unless the caller asks for the CPU).

``build_context`` builds four dense slots × slots complex matrices, so it
serves small rings only (16 GiB each at 2^15 slots).  ModRaise and EvalMod
need none of them: a ``BootstrapContext`` with empty plan tuples runs those
two at any ring.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import encoder, linear, ops, poly, polyeval, trace
from .keys import KeySet, full_keyset
from .params import CkksParams


@functools.lru_cache(maxsize=8)
def _cts_matrices(n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(A0, A1) coeff-extraction and (E0, E1) slot-restoration matrices."""
    slots = n // 2
    zeta, s2n, _ = encoder.slot_tables(n)
    g = 2 * s2n + 1  # generator exponents
    i0 = np.arange(slots)
    E0 = np.exp(1j * np.pi * np.outer(g, i0) / n)  # (slots, slots): ζ^{g_j·i}
    E1 = np.exp(1j * np.pi * np.outer(g, i0 + slots) / n)
    A0 = (2.0 / n) * E0.conj().T
    A1 = (2.0 / n) * E1.conj().T
    return A0, A1, E0, E1


@dataclasses.dataclass
class BootstrapContext:
    params: CkksParams  # the (large-L) bootstrapping parameter set
    keys: KeySet
    cts_plans: tuple[linear.BsgsPlan, linear.BsgsPlan]
    stc_plans: tuple[linear.BsgsPlan, linear.BsgsPlan]
    sine_coeffs: np.ndarray
    K: int
    eval_mod_degree: int
    galois_rotations: tuple[int, ...] = ()  # precomputed per-plan rotation union

    @property
    def depth(self) -> int:
        """Levels consumed: CtS(1) + normalise(1) + Chebyshev + StC(1)."""
        d = self.eval_mod_degree
        k = 1
        while k * k < d + 1:
            k *= 2
        cheb_depth = int(np.ceil(np.log2(k))) + max(0, int(np.ceil(np.log2((d + 1) / k)))) + 2
        return 3 + cheb_depth


def build_context(
    params: CkksParams,
    seed: int = 0,
    K: int | None = None,
    degree: int | None = None,
    h: int | None = None,
    device="cuda",
) -> BootstrapContext:
    """Precompute matrices, sine approximation and every needed Galois key (on ``device``)."""
    n = params.n
    if h is None:
        h = min(192, n // 4)
    if K is None:
        K = max(8, int(np.ceil(1.3 * np.sqrt(h))))
    if degree is None:
        degree = _default_degree(K)

    A0, A1, E0, E1 = _cts_matrices(n)
    cts_plans = (linear.plan_matrix(A0), linear.plan_matrix(A1))
    stc_plans = (linear.plan_matrix(E0), linear.plan_matrix(E1))

    # EvalMod target: h(x) = (q0/Δ)·sin(2π·(K+½)·x)/(2π) fitted on [-1, 1];
    # input is a/q0 normalised by (K+½)·θ with θ = q0/Δ.
    coeffs = polyeval.chebyshev_fit(eval_mod_target(params, K), degree)

    # the union of Galois rotations across every BSGS plan, computed once, so
    # keygen generates exactly one switching key per needed Galois element
    rots = set()
    for p in (*cts_plans, *stc_plans):
        rots |= p.rotations()
    rotations = tuple(sorted(rots))
    keys = full_keyset(params, seed=seed, rotations=rotations, conjugate=True, h=h, device=device)
    return BootstrapContext(
        params=params, keys=keys, cts_plans=cts_plans, stc_plans=stc_plans,
        sine_coeffs=coeffs, K=K, eval_mod_degree=degree, galois_rotations=rotations,
    )


def eval_mod_target(params: CkksParams, K: int):
    """The function EvalMod's Chebyshev series fits on [-1, 1] for range K."""
    q0 = float(params.q_primes[0])
    c = 2.0 * np.pi * (K + 0.5)
    return lambda x: (q0 / params.scale) * np.sin(c * x) / (2.0 * np.pi)


def _default_degree(K: int) -> int:
    """Chebyshev degree for sin(2π(K+½)x): Bessel decay sets ~1.3·c + margin."""
    c = 2.0 * np.pi * (K + 0.5)
    return int(np.ceil(1.25 * c + 12))


# ---------------------------------------------------------------------------
# context implementations (fc: FheContext over bctx.params/bctx.keys)
# ---------------------------------------------------------------------------


def _mod_raise(fc, bctx: BootstrapContext, ct: ops.Ciphertext) -> ops.Ciphertext:
    """Level-0 ciphertext → top level; plaintext becomes m + q0·I.

    The centred lift runs on the ciphertext's device: the residues mod q0
    become signed integers in (−q0/2, q0/2] and are reduced mod every prime of
    the chain in one broadcast.
    """
    params = bctx.params
    assert ct.level == 0, "mod_raise expects an exhausted (level-0) ciphertext"
    q0 = int(params.q_primes[0])
    L = params.L
    trace.record("MODRAISE", params.n, L + 1)
    chain = poly.limb_column(params.q_primes, torch.int32, ct.c0.device)  # (L+1, 1), a table

    def raise_poly(c_eval):
        v = poly.to_coeff(c_eval, params, (0,))[0].long()  # (N,) residues mod q0
        centered = torch.where(v > q0 // 2, v - q0, v)  # int64: the remainder below is non-negative
        return poly.to_eval((centered % chain).int(), params, poly.q_idx(params, L))

    return ops.Ciphertext(
        c0=raise_poly(ct.c0), c1=raise_poly(ct.c1), level=L, scale=ct.scale
    )


def _coeff_to_slot(fc, bctx: BootstrapContext,
                   ct: ops.Ciphertext) -> tuple[ops.Ciphertext, ops.Ciphertext]:
    """Slots become the coefficient halves a0, a1 (each real).

    Both BSGS transforms hoist their baby-step rotations per group when the
    policy's hoisting mode allows (see ``linear._apply_bsgs``)."""
    u0 = linear._apply_bsgs(fc, ct, bctx.cts_plans[0])
    u1 = linear._apply_bsgs(fc, ct, bctx.cts_plans[1])
    return linear._real_part(fc, u0), linear._real_part(fc, u1)


def _eval_mod(fc, bctx: BootstrapContext, ct: ops.Ciphertext,
              coeff_scale: float) -> ops.Ciphertext:
    """Remove the q0·I component: slot values v = a/coeff_scale → (q0/Δ)·sin(2π·a/q0)/(2π) ≈ m/Δ.

    ``coeff_scale`` is the ModRaise'd ciphertext's scale — the factor relating
    the CtS slot *values* to the underlying integer coefficients a (homomorphic
    ops preserve values, so the CtS output's own bookkeeping scale is NOT it).
    """
    p = bctx.params
    q0 = float(p.q_primes[0])
    norm = coeff_scale / ((bctx.K + 0.5) * q0)  # v·norm = a/((K+½)·q0) ∈ [-1, 1]
    # exact-scale normalisation: seeds the Chebyshev tree at scale Δ so the
    # multiplicative scale-doubling dynamics stay bounded
    x = ops._mul_const_exact(fc, ct, norm, p.scale)
    basis = polyeval.ChebyshevBasis(fc, x, bctx.eval_mod_degree)
    return polyeval._eval_chebyshev(fc, basis, bctx.sine_coeffs)


def _slot_to_coeff(fc, bctx: BootstrapContext, a0: ops.Ciphertext,
                   a1: ops.Ciphertext) -> ops.Ciphertext:
    v0 = linear._apply_bsgs(fc, a0, bctx.stc_plans[0])
    v1 = linear._apply_bsgs(fc, a1, bctx.stc_plans[1])
    return polyeval._add_any(fc, v0, v1)


def _bootstrap(fc, bctx: BootstrapContext, ct: ops.Ciphertext,
               post_scale: float | None = None) -> ops.Ciphertext:
    """Refresh an exhausted ciphertext to level L − depth.

    ``post_scale``: uniform-prime adaptation — with 30-bit q0 ≈ Δ the message
    must enter bootstrapping attenuated (|m| ≪ q0); the caller divides before
    exhaustion and passes the same factor here to restore it.  The policy on
    ``fc`` selects the key-switch pipeline for every rotation/relin inside and
    whether CtS/StC baby-step groups share one ModUp per group (bit-exact
    either way).
    """
    trace.record("BOOTSTRAP_BEGIN", bctx.params.n, bctx.params.L + 1)
    in_scale = ct.scale
    raised = _mod_raise(fc, bctx, ct)
    a0, a1 = _coeff_to_slot(fc, bctx, raised)
    m0 = _eval_mod(fc, bctx, a0, raised.scale)
    m1 = _eval_mod(fc, bctx, a1, raised.scale)
    out = _slot_to_coeff(fc, bctx, m0, m1)
    # amplitude bookkeeping: the sine was fitted for input scale = params.scale
    out = ops.Ciphertext(out.c0, out.c1, out.level, out.scale * in_scale / bctx.params.scale)
    if post_scale is not None:
        out = ops._mul_const(fc, out, float(post_scale), rescale_after=True)
    trace.record("BOOTSTRAP_END", bctx.params.n, out.level + 1)
    return out
