"""Static instruction-stream planner — the paper's "software driver".

FHE programs are data-oblivious, so every workload expands to a fixed stream of
hardware instructions (NTT/INTT/BCONV/PMULT/PADD/PSUB/AUTO/LOAD_*).  This
module generates those streams *analytically* from the cryptographic
parameters; `tests/test_torch_core.py` validates the expansions against traces
captured from the real executable FHE library (multiset equality) — the same
instruction stream drives both the numerics and the cycle simulator.

Two modes:
  * mode="exec" mirrors repro_torch.fhe exactly (incl. on-the-fly plaintext encodes
    and the full Chebyshev basis) — used for validation;
  * mode="hw" is what the accelerator would run: plaintexts are precomputed
    (LOAD_PT), EvalMod uses the Paterson–Stockmeyer mult count (~2√d), and
    CtS/StC matvec pairs share baby rotations (the paper's cache-hit-ratio
    scheduling optimisation).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.fhe.keyswitch import resolve_pipeline
from repro_torch.fhe.trace import Instr


@dataclasses.dataclass(frozen=True)
class PlanParams:
    """The crypto-parameter subset the planner needs."""

    n: int
    L: int
    alpha: int

    def beta(self, level: int) -> int:
        return -(-(level + 1) // self.alpha)

    def digit_size(self, j: int, level: int) -> int:
        lo = j * self.alpha
        hi = min((j + 1) * self.alpha, level + 1)
        return max(0, hi - lo)

    @classmethod
    def of(cls, params) -> "PlanParams":
        return cls(n=params.n, L=params.L, alpha=params.alpha)


def I(op: str, n: int, limbs: int, **meta) -> Instr:
    return Instr(op, n, limbs, meta)


# ---------------------------------------------------------------------------
# compound-op expansions (mirror repro_torch.fhe exactly in mode="exec")
# ---------------------------------------------------------------------------


def _ws(n: int, limbs: int, fused: bool) -> list[Instr]:
    """Stage-boundary working-set round-trip: only the staged pipeline pays it.

    Mirrors ``repro_torch.fhe.keyswitch``: a fused key-switch keeps every per-digit
    intermediate on chip, while the staged dispatch train stores + reloads it
    through HBM-equivalent buffers between kernel launches.
    """
    if fused:
        return []
    return [I("STORE_WS", n, limbs), I("LOAD_WS", n, limbs)]


def key_switch_accumulate(pp: PlanParams, level: int, fused: bool = True) -> list[Instr]:
    """Stages 1–4 of a key switch (digit decompose + KSK MAC), before ModDown.

    Mirrors ``repro_torch.fhe.keyswitch.key_switch_accumulate`` — the seam BGV's
    t-wrapped relinearisation shares with the CKKS pipeline."""
    n = pp.n
    beta = pp.beta(level)
    nq = level + 1
    ext = nq + pp.alpha
    out = [I("LOAD_KSK", n, beta * 2 * ext, ext=ext, nq=nq, beta=beta)]
    out.append(I("INTT", n, nq))
    for j in range(beta):
        k = pp.digit_size(j, level)
        out += [I("PMULT", n, k, fused=fused)]  # B̂⁻¹ prescale
        out += _ws(n, k, fused)
        out += [I("BCONV", n, k, dst=ext, fused=fused)]
        out += _ws(n, ext, fused)
        out += [I("NTT", n, ext, fused=fused)]
        out += _ws(n, ext, fused)
        out += [I("PMULT", n, 2 * ext, mac=True, fused=fused)]  # ksk MAC rides the NTT exit
        out += _ws(n, 2 * ext, fused)
        out += [I("PADD", n, 2 * ext, mac=True, fused=fused)]   # when the chip fuses it
    return out


def key_switch(pp: PlanParams, level: int, fused: bool = True) -> list[Instr]:
    return key_switch_accumulate(pp, level, fused) + mod_down(pp, level, fused) * 2


def mod_up(pp: PlanParams, level: int, fused: bool = True) -> list[Instr]:
    """Digit decomposition + raise to the extended basis — the shared
    (rotation-independent) half of a key-switch.  Mirrors
    ``repro_torch.fhe.keyswitch.hoisted_mod_up``: the materialised digits round-trip
    to the later MAC launches (one STORE/LOAD pair of β·ext limbs), in both
    pipelines — that boundary is the price of reusing them."""
    n, nq = pp.n, level + 1
    ext = nq + pp.alpha
    beta = pp.beta(level)
    out = [I("INTT", n, nq)]
    for j in range(beta):
        k = pp.digit_size(j, level)
        out += [I("PMULT", n, k, fused=fused)]
        out += _ws(n, k, fused)
        out += [I("BCONV", n, k, dst=ext, fused=fused)]
        out += _ws(n, ext, fused)
        out += [I("NTT", n, ext, fused=fused)]
    out += [I("STORE_WS", n, beta * ext), I("LOAD_WS", n, beta * ext)]
    return out


def hoisted_rotations(pp: PlanParams, level: int, n_rots: int,
                      fused: bool = True) -> list[Instr]:
    """Halevi–Shoup hoisting: one ModUp shared by ``n_rots`` rotations of the
    same ciphertext; each rotation then costs only ksk-MAC + ModDown + the
    folded automorphism (no per-rotation BConv/NTT through the extended
    basis: β + O(1) forward ext-NTTs per group instead of n_rots·β).

    Mirrors ``ctx.rotate_hoisted_group`` exactly: per rotation one
    KSK stream + β MAC pairs + a ModDown pair + the c0 add + one AUTO per
    output component (keys are σ_t^{-1}-pre-permuted, so the automorphism
    lands once, after ModDown)."""
    n, nq = pp.n, level + 1
    ext = nq + pp.alpha
    beta = pp.beta(level)
    out = mod_up(pp, level, fused)
    for _ in range(n_rots):
        out += [I("LOAD_KSK", n, beta * 2 * ext, ext=ext, nq=nq, beta=beta)]
        for _j in range(beta):
            out += [I("PMULT", n, 2 * ext, mac=True, fused=fused)]
            out += _ws(n, 2 * ext, fused)
            out += [I("PADD", n, 2 * ext, mac=True, fused=fused)]
        out += mod_down(pp, level, fused) * 2
        out += [I("PADD", n, nq), I("AUTO", n, nq), I("AUTO", n, nq)]
    return out


def mod_down(pp: PlanParams, level: int, fused: bool = True) -> list[Instr]:
    n, nq, a = pp.n, level + 1, pp.alpha
    out = [I("INTT", n, a)]
    out += [I("PMULT", n, a, fused=fused)]  # P̂⁻¹ prescale
    out += _ws(n, a, fused)
    out += [I("BCONV", n, a, dst=nq, fused=fused)]
    out += _ws(n, nq, fused)
    out += [I("NTT", n, nq, fused=fused)]
    out += _ws(n, nq, fused)
    out += [I("PSUB", n, nq, mac=True, fused=fused)]   # post-NTT elementwise stage — rides the
    out += _ws(n, nq, fused)
    out += [I("PMULT", n, nq, mac=True, fused=fused)]  # exit MACs on fused_exit_mac chips
    return out


def rescale(pp: PlanParams, level: int) -> list[Instr]:
    n, lv = pp.n, level
    one = [I("INTT", n, 1), I("NTT", n, lv),
           I("PSUB", n, lv, mac=True), I("PMULT", n, lv, mac=True)]
    return one * 2  # c0 and c1


def hmul(pp: PlanParams, level: int, rescale_after: bool = True, fused: bool = True) -> list[Instr]:
    n, nq = pp.n, level + 1
    out = [I("PMULT", n, 4 * nq), I("PADD", n, nq)]
    out += key_switch(pp, level, fused)
    out += [I("PADD", n, 2 * nq)]
    if rescale_after:
        out += rescale(pp, level)
    return out


# ---------------------------------------------------------------------------
# BGV expansions (mirror repro_torch.fhe.bgv exactly)
# ---------------------------------------------------------------------------


def bgv_relin(pp: PlanParams, level: int, fused: bool = True) -> list[Instr]:
    """BGV relinearisation: the shared key-switch accumulate with the ModDown
    wrapped in the t-scaling sandwich (``repro_torch.fhe.bgv._relin``): one t^{-1}
    pre-twist PMULT per accumulator over the extended basis, the unchanged
    ModDown pair, one t post-twist PMULT per component over the active basis."""
    n, nq = pp.n, level + 1
    ext = nq + pp.alpha
    out = key_switch_accumulate(pp, level, fused)
    out += [I("PMULT", n, ext)] * 2          # t^{-1} pre-twist, both accumulators
    out += mod_down(pp, level, fused) * 2
    out += [I("PMULT", n, nq)] * 2           # t post-twist, both components
    return out


def bgv_mod_switch(pp: PlanParams, level: int) -> list[Instr]:
    """BGV modulus switch (``repro_torch.fhe.bgv._mod_switch``): the CKKS rescale
    dataflow plus one single-limb PMULT per component for the t^{-1} twist of
    the dropped limb."""
    n, lv = pp.n, level
    one = [I("INTT", n, 1), I("PMULT", n, 1), I("NTT", n, lv),
           I("PSUB", n, lv, mac=True), I("PMULT", n, lv, mac=True)]
    return one * 2  # c0 and c1


def bgv_hmul(pp: PlanParams, level: int, mod_switch_after: bool = True,
             fused: bool = True) -> list[Instr]:
    n, nq = pp.n, level + 1
    out = [I("PMULT", n, 4 * nq), I("PADD", n, nq)]
    out += bgv_relin(pp, level, fused)
    out += [I("PADD", n, 2 * nq)]
    if mod_switch_after:
        out += bgv_mod_switch(pp, level)
    return out


def mul_plain(pp: PlanParams, level: int, rescale_after: bool = True,
              mode: str = "exec") -> list[Instr]:
    n, nq = pp.n, level + 1
    out = []
    out += [I("NTT", n, nq)] if mode == "exec" else [I("LOAD_PT", n, nq)]
    out += [I("PMULT", n, 2 * nq)]
    if rescale_after:
        out += rescale(pp, level)
    return out


def add_ct(pp: PlanParams, level: int) -> list[Instr]:
    return [I("PADD", pp.n, 2 * (level + 1))]


def rotate(pp: PlanParams, level: int, fused: bool = True) -> list[Instr]:
    n, nq = pp.n, level + 1
    return (
        [I("AUTO", n, nq), I("AUTO", n, nq)]
        + key_switch(pp, level, fused)
        + [I("PADD", n, nq)]
    )


def encrypt(pp: PlanParams, level: int) -> list[Instr]:
    n, nq = pp.n, level + 1
    return [I("NTT", n, nq)] * 3 + [I("PMULT", n, 2 * nq), I("PADD", n, nq)] * 2


# ---------------------------------------------------------------------------
# BSGS linear transform (CtS / StC / encrypted matmul building block)
# ---------------------------------------------------------------------------


def bsgs_matvec(
    pp: PlanParams, level: int, n_diags: int, n1: int,
    mode: str = "exec", share_babies: bool = False, hoist: bool = False,
    fused: bool = True,
) -> list[Instr]:
    n, nq = pp.n, level + 1
    babies = sorted({d % n1 for d in range(n_diags)} - {0})
    giants = sorted({d // n1 for d in range(n_diags)} - {0})
    out: list[Instr] = []
    if hoist and not share_babies and babies:
        # Halevi–Shoup: the whole baby group shares one ModUp
        out += hoisted_rotations(pp, level, len(babies), fused=fused)
    elif not share_babies:
        for _ in babies:
            out += rotate(pp, level, fused)
    for d in range(n_diags):
        out += [I("NTT", n, nq)] if mode == "exec" else [I("LOAD_PT", n, nq)]
        out += [I("PMULT", n, 2 * nq)]
    # adds inside giant groups: one per diagonal beyond the first of its group
    n_groups = len(giants) + 1
    out += [I("PADD", n, 2 * nq)] * (n_diags - n_groups)
    for _ in giants:
        out += rotate(pp, level, fused)
    out += [I("PADD", n, 2 * nq)] * (n_groups - 1)
    out += rescale(pp, level)
    return out


def conjugate(pp: PlanParams, level: int, fused: bool = True) -> list[Instr]:
    return rotate(pp, level, fused)


# ---------------------------------------------------------------------------
# bootstrapping
# ---------------------------------------------------------------------------


def chebyshev_basis_full(pp: PlanParams, level: int, degree: int,
                         fused: bool = True) -> list[Instr]:
    """mode="exec": T_2..T_degree each one hmul (+ alignment ops, counted coarsely)."""
    out: list[Instr] = []
    lv = level
    depth_of = lambda j: math.ceil(math.log2(j)) if j > 1 else 0
    for j in range(2, degree + 1):
        lj = level - depth_of(j)
        out += hmul(pp, lj + 1 - 1, fused=fused)  # product at the operand level
    return out


def eval_mod(pp: PlanParams, level: int, degree: int, mode: str = "exec",
             fused: bool = True) -> list[Instr]:
    """Normalise + Chebyshev basis + linear combination.

    mode="hw" uses the Paterson–Stockmeyer count: k = ⌈√(d+1)⌉ babies +
    log-many giants + ~d/k block combinations, each one ct-ct mult.
    """
    n = pp.n
    out = mul_plain(pp, level, mode=mode)  # exact-scale normalisation
    lv = level - 1
    if mode == "exec":
        out += chebyshev_basis_full(pp, lv, degree, fused=fused)
        n_terms = (degree + 1) // 2  # odd sine coefficients
        for _ in range(n_terms):
            out += mul_plain(pp, lv, mode=mode)
        out += [I("PADD", n, 2 * lv)] * (n_terms - 1)
    else:
        k = 1 << math.ceil(math.log2(degree + 1) / 2)
        giants = math.ceil(math.log2((degree + 1) / k)) if (degree + 1) > k else 0
        n_mults = (k - 1) + giants + math.ceil((degree + 1) / k)
        for i in range(n_mults):
            out += hmul(pp, max(1, lv - depth_estimate(i, k)), fused=fused)
        out += [I("LOAD_PT", n, lv), I("PMULT", n, 2 * lv)] * (degree // 2)
        out += [I("PADD", n, 2 * lv)] * (degree // 2)
    return out


def depth_estimate(i: int, k: int) -> int:
    return min(6, int(math.log2(i + 2)))


def mod_raise(pp: PlanParams) -> list[Instr]:
    n, L = pp.n, pp.L
    return [I("MODRAISE", n, L + 1)] + [I("INTT", n, 1), I("NTT", n, L + 1)] * 2


def _dft_transform(pp: PlanParams, level: int, mode: str, radix: int = 32,
                   hoist: bool = False, fused: bool = True) -> tuple[list[Instr], int]:
    """CoeffToSlot/SlotToCoeff as homomorphic DFT.

    mode="exec" mirrors the executable library: one dense matvec (all `slots`
    diagonals).  mode="hw" uses the level-collapsed FFT factorisation real
    deployments use (Lattigo/CraterLake): ⌈log_radix(slots)⌉ stages of sparse
    matvecs with 2·radix−1 diagonals each — ~100× fewer rotations at N=2^16.
    Returns (stream, levels_consumed_per_matvec_chain).
    """
    slots = pp.n // 2
    out: list[Instr] = []
    if mode == "exec":
        n1 = max(1, 1 << int(round(math.log2(math.sqrt(slots)))))
        out += bsgs_matvec(pp, level, slots, n1, mode=mode, hoist=hoist, fused=fused)
        return out, 1
    stages = max(1, math.ceil(math.log(slots, radix)))
    diags = 2 * radix - 1
    n1 = max(1, 1 << int(round(math.log2(math.sqrt(diags)))))
    lv = level
    for _ in range(stages):
        out += bsgs_matvec(pp, lv, diags, n1, mode=mode, hoist=hoist, fused=fused)
        lv -= 1
    return out, stages


def bootstrap(
    pp: PlanParams, degree: int, mode: str = "exec", n1: int | None = None,
    hoist: bool = False, fused: bool = True,
) -> list[Instr]:
    """Full packed bootstrapping instruction stream."""
    n = pp.n
    out = mod_raise(pp)
    L = pp.L
    # CoeffToSlot: two transform chains (+2 conjugations for the real parts)
    s0, used = _dft_transform(pp, L, mode, hoist=hoist, fused=fused)
    s1, _ = _dft_transform(pp, L, mode, hoist=hoist, fused=fused)
    out += s0 + s1
    lv = L - used
    out += conjugate(pp, lv, fused) + [I("PADD", n, 2 * (lv + 1))]
    out += conjugate(pp, lv, fused) + [I("PADD", n, 2 * (lv + 1))]
    # EvalMod on both halves
    out += eval_mod(pp, lv, degree, mode=mode, fused=fused) * 2
    # SlotToCoeff
    cheb_depth = math.ceil(math.log2(max(2, degree))) + 1
    lv2 = max(1, lv - 1 - cheb_depth)
    s2, _ = _dft_transform(pp, lv2, mode, hoist=hoist, fused=fused)
    s3, _ = _dft_transform(pp, lv2, mode, hoist=hoist, fused=fused)
    out += s2 + s3
    out += [I("PADD", n, 2 * max(1, lv2 - used))]
    return out


# ---------------------------------------------------------------------------
# workload programs (paper §6.1) — op-level graphs expanded to instructions
# ---------------------------------------------------------------------------


import contextvars

# (hoist, fused) plan flags for the workload expansion below — set per
# workload_stream call so the _WORKLOADS bodies stay signature-stable.
_PLAN: contextvars.ContextVar[tuple[bool, bool]] = contextvars.ContextVar(
    "plan_flags", default=(False, True)
)


def _plan_hoist() -> bool:
    return _PLAN.get()[0]


def _plan_fused() -> bool:
    return _PLAN.get()[1]


def plan_fused(policy, device="cuda") -> bool:
    """Does ``policy`` run the fused key-switch pipeline on ``device``?

    Explicit backends never depend on the device; "auto" resolves on it, as
    ``FheContext.plan_fused`` does: fused on "cuda", staged on "cpu"."""
    return resolve_pipeline(policy.backend, device)[0] == "fused"


def workload_stream(name: str, params, mode: str = "hw", hoist: bool = False,
                    policy=None, device="cuda") -> list[Instr]:
    """Expand one workload to its instruction stream.

    ``policy`` (an ``repro_torch.fhe.context.ExecPolicy``) is the context-first way
    to choose the mirrored trace shape: ``policy.plan_hoist`` selects hoisted
    BSGS baby groups and ``plan_fused(policy, device)`` selects the fused
    key-switch pipeline (no working-set boundary records).  ``device`` is
    where the job would run; it only matters for ``backend="auto"``.  The
    legacy ``hoist=`` bool is honoured when no policy is given (with the
    fused pipeline, as before).
    """
    pp = PlanParams.of(params)
    fn = _WORKLOADS[name]
    if policy is not None:
        flags = (policy.plan_hoist, plan_fused(policy, device))
    else:
        flags = (hoist, True)
    tok = _PLAN.set(flags)
    try:
        stream = fn(pp, mode)
    finally:
        _PLAN.reset(tok)
    if mode == "hw":
        stream = add_hw_annotations(stream, pp)
    return stream


# Working-set factor: digit-raised polys, two accumulators, ModDown temporaries
# and double-buffering across the fused pipeline ≈ WS_FACTOR·ext limb-polys.
# Calibrated so the dnum=1, N=2^16, L=57 key-switch saturates at ~320 MB —
# the paper's own Fig-8 design point for choosing the cache volume.
WS_FACTOR = 9


def add_hw_annotations(stream: list[Instr], pp: PlanParams) -> list[Instr]:
    """Insert key-switch working-set touches (drives the Fig-8 cache sweep)."""
    out: list[Instr] = []
    for ins in stream:
        out.append(ins)
        if ins.op == "LOAD_KSK" and "ext" in ins.meta:
            ws_limbs = WS_FACTOR * ins.meta["ext"]
            out.append(I("TOUCH_WS", ins.n, ws_limbs, ksk_limbs=ins.limbs))
    return out


def _w_matmul(pp: PlanParams, mode: str) -> list[Instr]:
    """100×1000 @ 1000×10 encrypted matmul (§3.2): diagonal method.

    Rows packed across slots; 1000-dim contraction via log-rotations & pt-muls.
    """
    lv = pp.L
    out: list[Instr] = []
    cols = 10
    for _ in range(cols):
        out += mul_plain(pp, lv, mode=mode)
    for _ in range(int(math.log2(1024)) * cols):  # rotate-and-add reduction
        out += rotate(pp, lv - 1, _plan_fused()) + add_ct(pp, lv - 1)
    return out


def _w_dblookup(pp: PlanParams, mode: str) -> list[Instr]:
    """BGV country-lookup with binary-encoded keys (§3.2): depth-log2(|key|)
    equality circuit + masked aggregation."""
    lv = pp.L
    out: list[Instr] = []
    key_bits = 8
    lvl = lv
    for _ in range(key_bits):  # bitwise XNOR via (1-a-b+2ab): 1 hmul each
        out += hmul(pp, lvl, fused=_plan_fused())
        lvl -= 1
    for _ in range(int(math.log2(key_bits))):  # AND-tree
        out += hmul(pp, lvl, fused=_plan_fused())
        lvl -= 1
    for _ in range(64):  # table mask-and-aggregate
        out += mul_plain(pp, lvl, mode=mode) + add_ct(pp, max(1, lvl - 1))
    return out


def _w_lola_mnist(pp: PlanParams, mode: str, encrypted_weights: bool = False) -> list[Instr]:
    """LoLa-MNIST (§6.1): dense 785→1000 (as BSGS matvec), square, dense
    1000→10, square — the low-latency packed pipeline."""
    lv = pp.L
    out = bsgs_matvec(pp, lv, 64, 8, mode=mode, hoist=_plan_hoist(), fused=_plan_fused())
    lvl = lv - 1
    if encrypted_weights:
        out += hmul(pp, lvl, fused=_plan_fused())  # ct×ct matvec core surrogate
        lvl -= 1
    out += hmul(pp, lvl, fused=_plan_fused())  # square activation
    lvl -= 1
    out += bsgs_matvec(pp, lvl, 32, 4, mode=mode, hoist=_plan_hoist(), fused=_plan_fused())
    lvl -= 1
    out += hmul(pp, lvl, fused=_plan_fused())  # square activation
    return out


def _w_lola_cifar(pp: PlanParams, mode: str) -> list[Instr]:
    """LoLa-CIFAR (§6.1): conv 8×8×83 → pool → dense, squares between."""
    lv = pp.L
    out: list[Instr] = []
    lvl = lv
    for _ in range(16):  # conv as shifted pt-muls
        out += mul_plain(pp, lvl, mode=mode) + rotate(pp, lvl - 1, _plan_fused()) + add_ct(pp, lvl - 1)
    lvl -= 1
    out += hmul(pp, lvl, fused=_plan_fused())  # square
    lvl -= 1
    out += bsgs_matvec(pp, lvl, 128, 8, mode=mode, hoist=_plan_hoist(), fused=_plan_fused())
    lvl -= 1
    out += hmul(pp, lvl, fused=_plan_fused())  # square
    lvl -= 1
    out += bsgs_matvec(pp, lvl, 32, 4, mode=mode, hoist=_plan_hoist(), fused=_plan_fused())
    return out


def _w_logreg(pp: PlanParams, mode: str) -> list[Instr]:
    """HE logistic regression (Han et al.): one mini-batch iteration, batch 256,
    256 features; sigmoid ≈ degree-7 poly; bootstrap when the level budget
    nears exhaustion."""
    out: list[Instr] = []
    lvl = pp.L
    # X·w: BSGS matvec over packed features
    out += bsgs_matvec(pp, lvl, 256, 16, mode=mode, hoist=_plan_hoist(), fused=_plan_fused())
    lvl -= 1
    # sigmoid degree-7 (3 mult levels, 4 mults)
    for _ in range(4):
        out += hmul(pp, lvl, fused=_plan_fused())
        lvl -= 1 if _ % 2 else 0
    lvl -= 2
    # gradient: Xᵀ·err matvec + weight update
    out += bsgs_matvec(pp, lvl, 256, 16, mode=mode, hoist=_plan_hoist(), fused=_plan_fused())
    lvl -= 1
    out += mul_plain(pp, lvl, mode=mode) + add_ct(pp, lvl - 1)
    # bootstrap once per iteration (level budget exhausted)
    out += bootstrap(pp, degree=63, mode=mode, hoist=_plan_hoist(), fused=_plan_fused())
    return out


def _w_lstm(pp: PlanParams, mode: str) -> list[Instr]:
    """One LSTM unit (Podschwadt-Takabi): 4 gates = 8 matvecs + 3 ct×ct
    (element gates) + tanh/sigmoid poly approx; bootstrap per unit."""
    out: list[Instr] = []
    lvl = pp.L
    for _ in range(8):  # W_g·x and U_g·h for 4 gates
        out += bsgs_matvec(pp, lvl, 128, 8, mode=mode, hoist=_plan_hoist(), fused=_plan_fused())
    lvl -= 1
    for _ in range(4 * 2):  # activation polys (deg-3: 2 mults each)
        out += hmul(pp, max(1, lvl), fused=_plan_fused())
        lvl -= 1 if _ % 4 == 3 else 0
    for _ in range(3):  # gate element-products
        out += hmul(pp, max(1, lvl), fused=_plan_fused())
    out += bootstrap(pp, degree=63, mode=mode, hoist=_plan_hoist(), fused=_plan_fused())
    return out


def _w_resnet20(pp: PlanParams, mode: str) -> list[Instr]:
    """ResNet-20 CIFAR inference (Lee et al.): 19 conv + FC layers, ReLU ≈
    high-degree poly; ~2 bootstraps per residual block (paper runs N=2^16,
    L=41)."""
    out: list[Instr] = []
    lvl = pp.L
    for block in range(9):  # 9 residual blocks
        for _ in range(2):  # two convs per block (as BSGS matvecs over channels)
            out += bsgs_matvec(pp, max(4, lvl), 64, 8, mode=mode, hoist=_plan_hoist(), fused=_plan_fused())
            lvl = max(4, lvl - 1)
            for _ in range(6):  # poly-ReLU mults
                out += hmul(pp, max(2, lvl), fused=_plan_fused())
            lvl = max(4, lvl - 3)
        out += add_ct(pp, max(1, lvl))  # residual add
        out += bootstrap(pp, degree=63, mode=mode, hoist=_plan_hoist(), fused=_plan_fused())
        lvl = pp.L - 14  # post-bootstrap budget
    out += bsgs_matvec(pp, max(4, lvl), 64, 8, mode=mode, hoist=_plan_hoist(), fused=_plan_fused())  # final FC
    return out


def _w_psi(pp: PlanParams, mode: str) -> list[Instr]:
    """Private set intersection (BGV, t=2): 32-bit identifiers bit-packed into
    slots.  XNOR bit-equality is additive over GF(2) (1 + a + b — PADDs only);
    the log-depth AND-tree is the multiplicative core; per-bin plaintext masks
    aggregate the matches."""
    out: list[Instr] = []
    lvl = pp.L
    key_bits = 32
    for _ in range(key_bits):  # XNOR layer: one ct add per bit position
        out += add_ct(pp, lvl)
    for _ in range(int(math.log2(key_bits))):  # AND-tree: depth log2(bits)
        out += bgv_hmul(pp, lvl, fused=_plan_fused())
        lvl -= 1
    for _ in range(16):  # per-bin mask-and-aggregate (no level cost)
        out += mul_plain(pp, lvl, rescale_after=False, mode=mode) + add_ct(pp, lvl)
    return out


def _w_exact_count(pp: PlanParams, mode: str) -> list[Instr]:
    """Exact-count aggregation (BGV, t=2^16): two predicate products (range /
    one-hot filters), then 64 groups of plaintext mask-and-accumulate — exact
    16-bit counters, no approximation error to budget for."""
    out: list[Instr] = []
    lvl = pp.L
    for _ in range(2):
        out += bgv_hmul(pp, lvl, fused=_plan_fused())
        lvl -= 1
    for _ in range(64):
        out += mul_plain(pp, lvl, rescale_after=False, mode=mode) + add_ct(pp, lvl)
    return out


def _w_packed_bootstrap(pp: PlanParams, mode: str) -> list[Instr]:
    """Paper §6.1: exhaust L then refresh — the bootstrap stream itself."""
    out: list[Instr] = []
    lvl = 3
    for _ in range(3):
        out += hmul(pp, lvl, fused=_plan_fused())
        lvl -= 1
    out += bootstrap(pp, degree=63, mode=mode, hoist=_plan_hoist(), fused=_plan_fused())
    return out


_WORKLOADS = {
    "matmul": _w_matmul,
    "dblookup": _w_dblookup,
    "lola_mnist_plain": lambda pp, m: _w_lola_mnist(pp, m, encrypted_weights=False),
    "lola_mnist_enc": lambda pp, m: _w_lola_mnist(pp, m, encrypted_weights=True),
    "lola_cifar_plain": _w_lola_cifar,
    "psi": _w_psi,
    "exact_count": _w_exact_count,
    "logreg": _w_logreg,
    "lstm": _w_lstm,
    "resnet20": _w_resnet20,
    "packed_bootstrap": _w_packed_bootstrap,
}


def available_workloads() -> tuple[str, ...]:
    return tuple(_WORKLOADS)
