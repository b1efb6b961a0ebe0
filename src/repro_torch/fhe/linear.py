"""Homomorphic linear transforms via the BSGS diagonal method.

M·v = Σ_g rot_{g·n1}( Σ_b  rot_{-g·n1}(diag_{g·n1+b}(M)) ∘ rot_b(v) )

Baby rotations rot_b(v) are shared across giants, so an n×n dense transform
costs ≈ 2√n key-switched rotations + n plaintext multiplies — the dominant
workload of CoeffToSlot/SlotToCoeff in bootstrapping (paper §3.3: rotation-
heavy deep pipelines).

Execution policy comes from ``repro_torch.fhe.context.FheContext`` —
``ctx.apply_bsgs``/``ctx.plan_matrix`` are the primary API, and
``plan_matrix`` picks the baby-step count n1 from a hoisting-aware cost model
(under hoisting, baby steps are nearly free — see ``choose_n1``).  Planning is
numpy on the host; each diagonal is encoded on the context's device the first
time the transform is applied at a level and scale, into one stack the plan
keeps for every later application, and every giant group's products and sums
run as one ``bsgs_mac`` launch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from repro_torch.kernels.bsgsmac import ops as bsgsmac
from repro_torch.obs.spans import span

from . import ops, trace
from .params import CkksParams


@dataclasses.dataclass(eq=False)
class DiagonalStack:
    """A plan's diagonals encoded at one (level, scale) on one device, in the
    operands ``bsgs_mac`` takes.

    ``data`` is (D, level+1, N), one row per diagonal, pre-rotated by its giant
    step, in ``BsgsPlan.mac_layout``'s order; ``plaintexts`` maps each diagonal
    to a ``Plaintext`` over its row; ``babies``, ``baby_idx`` and ``offsets``
    are the layout's, the last two int32 tensors on the device.
    """

    data: torch.Tensor
    plaintexts: dict
    babies: tuple[int, ...]
    baby_idx: torch.Tensor
    offsets: torch.Tensor


@dataclasses.dataclass
class BsgsPlan:
    """The diagonals of M and the baby-step count n1 of its BSGS split.

    The plan keeps its diagonals' encoded plaintexts on the device it was
    applied on, one ``DiagonalStack`` per (level, scale, device, params): the
    matvec encodes each diagonal once, and every later application at the same
    level and scale reads the stack back.  That holds #diagonals × (ℓ+1) × N ×
    4 B on the device for each level and scale the plan is applied at (3.76 GB
    for an LSTM step's eight plans at N = 2^16 and ℓ = 13; 28.3 MB for
    LoLa-MNIST's three at N = 2^13), and is freed with the plan.  Equality
    ignores it.
    """

    n1: int  # baby-step count
    diags: dict[int, np.ndarray]  # d → diag_d(M) (length n complex)
    _rot_cache: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )
    _stacks: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    def baby_steps(self) -> tuple[int, ...]:
        """Sorted non-zero baby rotations {d mod n1} — one hoisting group."""
        hit = self._rot_cache.get("babies")
        if hit is None:
            hit = tuple(sorted({d % self.n1 for d in self.diags} - {0}))
            self._rot_cache["babies"] = hit
        return hit

    def giant_steps(self) -> tuple[int, ...]:
        """Sorted non-zero giant rotations {(d // n1) · n1}."""
        hit = self._rot_cache.get("giants")
        if hit is None:
            hit = tuple(sorted({(d // self.n1) * self.n1 for d in self.diags} - {0}))
            self._rot_cache["giants"] = hit
        return hit

    def rotations(self) -> frozenset[int]:
        """Slot rotations whose Galois keys the transform needs (cached —
        keygen and every apply call share one computation)."""
        hit = self._rot_cache.get("all")
        if hit is None:
            hit = frozenset(self.baby_steps()) | frozenset(self.giant_steps())
            self._rot_cache["all"] = hit
        return hit

    def giant_groups(self) -> tuple[tuple[int, tuple[int, ...]], ...]:
        """(g, diagonals with d // n1 = g) for each giant index g, in order of g,
        the diagonals of a group in the plan's order: the reference's order of
        the products and sums."""
        hit = self._rot_cache.get("groups")
        if hit is None:
            by_giant: dict[int, list[int]] = {}
            for d in self.diags:
                by_giant.setdefault(d // self.n1, []).append(d)
            hit = tuple((g, tuple(ds)) for g, ds in sorted(by_giant.items()))
            self._rot_cache["groups"] = hit
        return hit

    def mac_layout(self) -> tuple[tuple[int, ...], tuple[int, ...], tuple[int, ...], tuple[int, ...]]:
        """(rows, babies, baby_idx, offsets) of ``bsgs_mac``'s operands: the
        diagonals in stack order (``giant_groups``'s, groups together), the
        baby steps they use, the position in ``babies`` of each row's, and
        where each group's rows start (G+1 entries, the last D)."""
        hit = self._rot_cache.get("mac")
        if hit is None:
            groups = self.giant_groups()
            rows = tuple(d for _, ds in groups for d in ds)
            babies = tuple(sorted({d % self.n1 for d in rows}))
            idx = tuple(babies.index(d % self.n1) for d in rows)
            offsets = tuple(int(o) for o in np.cumsum([0] + [len(ds) for _, ds in groups]))
            hit = self._rot_cache["mac"] = (rows, babies, idx, offsets)
        return hit

    def stack(self, ctx, level: int, scale: float) -> tuple[DiagonalStack, dict]:
        """The plan's ``DiagonalStack`` at (level, scale) on the context's
        device, and {d: the ``fhe.trace`` instructions of d's encode}.

        On the first call every diagonal is encoded into its row (with the
        trace active, each encode's instructions are captured instead of
        recorded, for the caller to record where the reference encodes that
        diagonal); later calls read the stack back (an ``fhe.bsgs.diag_hit``
        span) and encode nothing."""
        key = (level, scale, ctx.device, ctx.params)
        st = self._stacks.get(key)
        if st is not None:
            with span("fhe.bsgs.diag_hit"):
                return st, {}
        rows, babies, idx, offsets = self.mac_layout()
        data = torch.empty((len(rows), level + 1, ctx.params.n), dtype=torch.int32, device=ctx.device)
        encoded, tracing = {}, trace.tracing()
        for row, d in enumerate(rows):
            u = np.roll(self.diags[d], (d // self.n1) * self.n1)
            with trace.capture_trace() if tracing else contextlib.nullcontext([]) as encoded[d]:
                data[row].copy_(ops._encode(ctx, u, level=level, scale=scale).data)
        st = self._stacks[key] = DiagonalStack(
            data=data,
            plaintexts={d: ops.Plaintext(data=data[row], level=level, scale=scale) for row, d in enumerate(rows)},
            babies=babies,
            baby_idx=torch.tensor(idx, dtype=torch.int32, device=ctx.device),
            offsets=torch.tensor(offsets, dtype=torch.int32, device=ctx.device),
        )
        return st, encoded

    def plaintext(self, ctx, d: int, level: int, scale: float) -> ops.Plaintext:
        """diag_d pre-rotated by its giant step (d // n1)·n1 and encoded at
        (level, scale) on the context's device: the row of d in the plan's
        stack, encoded on the first call."""
        st, encoded = self.stack(ctx, level, scale)
        for instrs in encoded.values():
            _replay(instrs)
        return st.plaintexts[d]


def _replay(instrs) -> None:
    """Record captured ``fhe.trace`` instructions into the active trace."""
    for i in instrs:
        trace.record(i.op, i.n, i.limbs, **i.meta)


# ---------------------------------------------------------------------------
# BSGS planning: the hoisting-aware n1 cost model
# ---------------------------------------------------------------------------


def bsgs_rotation_cost(diag_indices, n1: int, params: CkksParams, level: int,
                       hoisted: bool) -> float:
    """Key-switch cost of a BSGS split, in limb-NTT-equivalents.

    The model counts the (i)NTT limb-transforms each rotation path issues —
    the planner's own instruction shapes, collapsed to the dominant unit:

      * a full key-switched rotation (unhoisted baby, or any giant — giants
        act on *different* partial sums, so they can never share a ModUp):
        ModUp (1 iNTT over nq limbs + β forward NTTs over m = nq+α limbs)
        plus two ModDown tails (each α iNTT + nq NTT limbs);
      * a hoisted baby: only the two ModDown tails — the group's single ModUp
        is charged once.

    Plaintext multiplies are diagonal-count work, identical for every n1, so
    they cancel out of the argmin and are omitted.
    """
    nq = level + 1
    alpha = params.alpha
    beta = params.beta(level)
    m = nq + alpha
    full = nq + beta * m + 2 * (alpha + nq)  # ModUp + 2× ModDown
    baby_hoisted = 2 * (alpha + nq)  # MAC rides the exit; ModDown dominates
    babies = len({d % n1 for d in diag_indices} - {0})
    giants = len({(d // n1) * n1 for d in diag_indices} - {0})
    if not hoisted:
        return (babies + giants) * full
    modup_once = nq + beta * m if babies else 0.0
    return modup_once + babies * baby_hoisted + giants * full


def choose_n1(diag_indices, params: CkksParams, level: int, hoisted: bool) -> int:
    """Baby-step count minimising the rotation cost model over powers of two.

    Without hoisting the optimum sits at the classic ≈ √(#diags) balance
    point.  With hoisting, baby steps cost only a ModDown each (the ModUp is
    shared), so the optimum shifts toward more babies / fewer giants — e.g.
    the radix-32 CtS stage (63 diagonals) moves from n1 = 8 to n1 = 16.
    """
    diag_indices = tuple(diag_indices)
    if not diag_indices:
        return 1
    top = 1 << max(0, (max(diag_indices)).bit_length())
    candidates = []
    n1 = 1
    while n1 <= max(2, top):
        candidates.append(n1)
        n1 <<= 1
    return min(
        candidates,
        key=lambda c: (bsgs_rotation_cost(diag_indices, c, params, level, hoisted), c),
    )


def pack(v: np.ndarray, slots: int) -> np.ndarray:
    """A width-p vector replicated with period p over the slots: the layout that a
    matvec over period-p diagonals (``plan_diags``) reads and writes."""
    v = np.asarray(v, np.float64)
    return np.tile(v, slots // v.shape[0])


def plan_matrix(m: np.ndarray, n1: int | None = None, tol: float = 0.0,
                params: CkksParams | None = None, level: int | None = None,
                hoisting: bool = False) -> BsgsPlan:
    """Extract (optionally sparse) diagonals of an n×n matrix for BSGS.

    n1 selection, in priority order: an explicit ``n1``; the hoisting-aware
    cost model when ``params`` is given (``choose_n1`` — pass
    ``hoisting=True`` when the transform will run under a hoisting policy);
    otherwise the classic ≈ √n power of two.
    """
    n = m.shape[0]
    assert m.shape == (n, n)
    idx = np.arange(n)
    diags = {}
    mx = np.abs(m).max() or 1.0
    for d in range(n):
        u = m[idx, (idx + d) % n]
        if tol == 0.0 or np.abs(u).max() > tol * mx:
            diags[int(d)] = u.astype(np.complex128)
    if n1 is None:
        if params is not None:
            n1 = choose_n1(diags, params, params.L if level is None else level, hoisting)
        else:
            n1 = max(1, 1 << int(round(math.log2(math.sqrt(n)))))  # ≈ √n, power of two
    return BsgsPlan(n1=n1, diags=diags)


def plan_diags(diags: dict[int, np.ndarray], params: CkksParams, level: int | None = None,
               hoisting: bool = False, n1: int | None = None) -> BsgsPlan:
    """BSGS plan straight from a diagonal dict (for banded transforms whose
    dense matrix is too large to materialise), n1 from the cost model."""
    if n1 is None:
        n1 = choose_n1(diags, params, params.L if level is None else level, hoisting)
    return BsgsPlan(n1=n1, diags=dict(diags))


# ---------------------------------------------------------------------------
# context implementations
# ---------------------------------------------------------------------------


def _apply_bsgs(ctx, ct: ops.Ciphertext, plan: BsgsPlan,
                scale: float | None = None) -> ops.Ciphertext:
    """Homomorphic M·v.  Consumes one level (single rescale at the end).

    The policy's hoisting mode controls the baby-step rotations (the dominant
    key-switch cost): "auto"/"always" share ONE ModUp across the whole baby
    group (Halevi–Shoup; "auto" falls back to per-rotation key-switching when
    the group has fewer than two rotations), "never" key-switches each baby
    separately.  All modes are bit-exact against each other.  Giant-step
    rotations apply to *different* ciphertexts (the per-group partial sums),
    so they cannot share a ModUp and always run the standard path.

    The diagonals come from the plan's stack (``BsgsPlan.stack``), encoded on
    the first application at this level and scale only, and every group's
    Σ_d pt_d ∘ baby_{d mod n1} is one ``bsgs_mac`` launch (an ``fhe.bsgs.mac``
    span): the reference's residues, with its ``PMULT``/``PADD`` instructions
    recorded for each diagonal in its order, in place of its ``mulmod`` and
    ``addmod`` dispatches.
    """
    with span("fhe.bsgs"):
        params = ctx.params
        keys = ctx.require_keys()
        hoisting = ctx.policy.hoisting
        scale = params.scale if scale is None else scale
        lv = ct.level

        babies: dict[int, ops.Ciphertext] = {0: ct}
        needed_b = plan.baby_steps()
        if hoisting == "always" or (hoisting == "auto" and len(needed_b) >= 2):
            babies.update(ops._rotate_hoisted_group(ctx, ct, needed_b, keys))
        else:
            for b in needed_b:
                babies[b] = ops._rotate_standard(ctx, ct, b, keys)

        st, encoded = plan.stack(ctx, lv, scale)
        with span("fhe.bsgs.mac"):
            rows = torch.stack([c for b in st.babies for c in (babies[b].c0, babies[b].c1)])
            parts = bsgsmac.bsgs_mac(st.data, rows.view(len(st.babies), 2, lv + 1, params.n), st.baby_idx,
                                     st.offsets, ops._qs(params, lv))

        tracing = trace.tracing()
        total: ops.Ciphertext | None = None
        for i, (g, ds) in enumerate(plan.giant_groups()):
            if tracing:
                for k, d in enumerate(ds):
                    _replay(encoded.get(d, ()))
                    trace.record("PMULT", params.n, 2 * (lv + 1))
                    if k:
                        trace.record("PADD", params.n, 2 * (lv + 1))
            acc = ops.Ciphertext(parts[i, 0], parts[i, 1], lv, ct.scale * scale)
            if g:
                acc = ops._rotate_standard(ctx, acc, g * plan.n1, keys)
            total = acc if total is None else ops._add(ctx, total, acc)

        return ops._rescale(ctx, total)


def _real_part(ctx, ct: ops.Ciphertext) -> ops.Ciphertext:
    """(ct + conj(ct)) / 2 — scale the ½ into the bookkeeping (free)."""
    s = ops._add(ctx, ct, ops._conjugate(ctx, ct, ctx.require_keys()))
    return ops.Ciphertext(s.c0, s.c1, s.level, s.scale * 2.0)


def _imag_part(ctx, ct: ops.Ciphertext) -> ops.Ciphertext:
    """(ct − conj(ct)) / 2i — fold 1/(2i) into a plaintext mul."""
    d = ops._sub(ctx, ct, ops._conjugate(ctx, ct, ctx.require_keys()))
    return ops._mul_const(ctx, d, -0.5j, rescale_after=True)

