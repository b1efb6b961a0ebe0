"""One basic block of ResNet-20 (FLASH-FHE's deep ``resnet20`` workload, §6.1).

He, Zhang, Ren and Sun (CVPR 2016) §4.2: a stage-1 block of the CIFAR-10
network, C = 16 channels in and out of an H × W = 32 × 32 map, two 3 × 3
convolutions of stride 1 with zero padding 1, batch norm folded into each
convolution's weights and a per-channel bias, and an identity shortcut:

    y = ReLU(x + conv₂(ReLU(conv₁(x) + b₁)) + b₂).

Its homomorphic form after Lee et al. (IEEE Access 2022): the weights are
unencrypted, x is encrypted channel-major (slot c·H·W + h·W + w) and
replicated with period C·H·W over the slots (``linear.pack``), so each
convolution is one BSGS matvec over C·9 period-(C·H·W) diagonals, diagonal
d = (Δc·H·W + Δh·W + Δw) mod C·H·W holding the weight of input channel
c + Δc at tap (Δh, Δw), zero where the tap falls in the padding
(``conv_diagonals``).  The ReLU is ReLU(t) = t·(1 + s(t))/2 with s = f₃ ∘ f₃
∘ g₃ ∘ g₃ (the g's first) approximating sgn on [−1, 1]: Cheon, Kim, Kim and
Lee's degree-7 f₃ and g₃ (ASIACRYPT 2020), each a Chebyshev series on
[−1, 1] (``polyeval``), the last with the ½ and the 1 folded in, then one
product.

Every value is carried divided by B = ``BOUND``, which bounds every
pre-activation: conv₁'s weights and both biases are divided by it, and the
shortcut's x by a constant product; conv₂ reads ReLU(·)/B and so keeps its
weights.  The answer is y/B.

At dnum = 1 a rotation at scale Δ errs by 3.7e-2 of a slot at N = 2^12, and
more than N-fold as N grows (the ModUp's fast basis conversion hands the
single digit of ℓ + 1 limbs to the key's error uncentred;
``tests/test_torch_resnet_block.py`` measures it), so each convolution first
lifts its input to ≈ Δ² with a constant product left unrescaled: its baby
rotations run at ≈ Δ², its giants at ≈ Δ³.  The lift's constant is encoded so
that the convolution lands at exactly Δ.

Levels from the top L: conv₁ (the lift, the matvec and its rescale, a second
rescale) L − 2; the ReLU's four stages, 4 levels each, L − 18; its product
(t dropped to that level) L − 19; conv₂ L − 21, joined there by x/B (x dropped
to L − 20, the constant product rescaled); the second ReLU L − 38, at scale
Δ²/q_{L−37}: level 3 of L = 41.  Two convolutions and two ReLUs are 38 levels.
The bootstraps a whole network needs between blocks are left out.  Run a block
through a context: ``ctx.resnet_block(plan, x)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.obs.spans import span

from . import linear, ops, polyeval
from .params import CkksParams

BOUND = 10.0  # B: every pre-activation lies in [−B, B]
G3 = (0.0, 4589 / 1024, 0.0, -16577 / 1024, 0.0, 25614 / 1024, 0.0, -12860 / 1024)
F3 = (0.0, 35 / 16, 0.0, -35 / 16, 0.0, 21 / 16, 0.0, -5 / 16)
SIGN = (G3, G3, F3, F3)  # s = f₃ ∘ f₃ ∘ g₃ ∘ g₃, in the order applied


def conv_diagonals(w: np.ndarray, height: int, width: int, slots: int) -> dict[int, np.ndarray]:
    """The C·9 period-(C·H·W) diagonals of a 3 × 3 convolution of stride 1 and
    zero padding 1 from C channels to C (w is (C, C, 3, 3), output channel
    first): slot i = c·H·W + h·W + w of diagonal d = (Δc·H·W + Δh·W + Δw) mod
    C·H·W holds w[c, (c + Δc) mod C, Δh + 1, Δw + 1], or 0 where (h + Δh,
    w + Δw) lies in the padding."""
    w = np.asarray(w, np.float64)
    c = w.shape[0]
    period = c * height * width
    if w.shape != (c, c, 3, 3) or min(height, width) < 3 or slots % period:
        raise ValueError(f"weights {w.shape} on a {height} x {width} map are no 3 x 3 convolution "
                         f"of period dividing {slots}")
    co, h, x = np.meshgrid(np.arange(c), np.arange(height), np.arange(width), indexing="ij")
    out = {}
    for dc in range(c):
        for dh in (-1, 0, 1):
            for dw in (-1, 0, 1):
                inside = (0 <= h + dh) & (h + dh < height) & (0 <= x + dw) & (x + dw < width)
                diag = np.where(inside, w[co, (co + dc) % c, dh + 1, dw + 1], 0.0)
                out[(dc * height * width + dh * width + dw) % period] = linear.pack(diag.reshape(-1), slots)
    return out


@dataclasses.dataclass
class ResnetBlockPlan:
    """The block's two BSGS plans (conv₁'s weights over B, conv₂'s as they
    are), the biases over B (one a channel), the map's shape (C, H, W) and
    the ReLU's four Chebyshev series on [−1, 1]: g₃, g₃, f₃ and (1 + f₃)/2."""

    convs: tuple[linear.BsgsPlan, linear.BsgsPlan]
    bias: tuple[np.ndarray, np.ndarray]
    shape: tuple[int, int, int]
    relu_coeffs: tuple[np.ndarray, ...]
    _biases: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    def rotations(self) -> frozenset[int]:
        """Slot rotations whose Galois keys the block needs."""
        return self.convs[0].rotations() | self.convs[1].rotations()

    def bias_plaintext(self, ctx, k: int, level: int, scale: float) -> ops.Plaintext:
        """conv_k's bias, each channel's over its H·W slots, encoded once at the
        level and scale where the first block meets it."""
        key = (k, level, scale, ctx.device)
        if key not in self._biases:
            per_slot = np.repeat(self.bias[k], self.shape[1] * self.shape[2])
            self._biases[key] = ops._encode(ctx, linear.pack(per_slot, ctx.params.slots), level, scale)
        return self._biases[key]


def build_plan(conv1: np.ndarray, b1: np.ndarray, conv2: np.ndarray, b2: np.ndarray, params: CkksParams,
               height: int, width: int, n1: tuple[int, int] | None = None) -> ResnetBlockPlan:
    """The plan of a block from the convolutions' weights (C, C, 3, 3) and
    biases (C,), batch norm folded in, on an H × W map; n1 gives each
    convolution's baby-step count, else the cost model chooses it at the
    level where the convolution runs."""
    conv1, b1, conv2, b2 = (np.asarray(a, np.float64) for a in (conv1, b1, conv2, b2))
    c = conv1.shape[0]
    if not (conv1.shape == conv2.shape == (c, c, 3, 3) and b1.shape == b2.shape == (c,)):
        raise ValueError(f"convolutions {conv1.shape}, {conv2.shape} and biases {b1.shape}, {b2.shape} "
                         "are no basic block")
    levels = (params.L, params.L - 19)  # conv₂ runs after conv₁'s 2 levels and a ReLU's 17
    n1 = n1 or (None, None)
    plan = lambda w, k: linear.plan_diags(conv_diagonals(w, height, width, params.slots), params, levels[k],
                                          hoisting=True, n1=n1[k])
    last = np.polynomial.chebyshev.poly2cheb(F3) / 2
    last[0] += 0.5
    return ResnetBlockPlan(
        convs=(plan(conv1 / BOUND, 0), plan(conv2, 1)),
        bias=(b1 / BOUND, b2 / BOUND),
        shape=(c, height, width),
        relu_coeffs=tuple(polyeval.chebyshev_on_unit(p, 1.0) for p in SIGN[:-1]) + (last,),
    )


def _conv(ctx, plan: ResnetBlockPlan, k: int, ct: ops.Ciphertext) -> ops.Ciphertext:
    """conv_k(ct) + b_k: two levels down, at scale Δ."""
    with span("fhe.resnet.conv"):
        params = ctx.params
        lv = ct.level
        # the lift lands at q_ℓ·q_{ℓ−1} ≈ Δ², so the matvec's diagonals at Δ and two rescales give Δ
        q = float(params.q_primes[lv]) * float(params.q_primes[lv - 1])
        lift = ops._encode_const(ctx, 1.0, lv, q / ct.scale)
        y = ops._rescale(ctx, linear._apply_bsgs(ctx, ops._mul_plain(ctx, ct, lift, rescale_after=False),
                                                 plan.convs[k]))
        y = ops.Ciphertext(y.c0, y.c1, y.level, params.scale)  # Δ within the lift's rounding, 2^-31
        return ops._add_plain(ctx, y, plan.bias_plaintext(ctx, k, y.level, y.scale))


def _relu(ctx, plan: ResnetBlockPlan, t: ops.Ciphertext) -> ops.Ciphertext:
    """t·(1 + s(t))/2: the four series, 16 levels, then the product."""
    with span("fhe.resnet.relu"):
        h = t
        for coeffs in plan.relu_coeffs:
            h = polyeval._eval_chebyshev(ctx, polyeval.ChebyshevBasis(ctx, h, len(coeffs) - 1), coeffs)
        return ops._mul(ctx, t, h, ctx.require_keys().rlk)


def _resnet_block(ctx, plan: ResnetBlockPlan, x: ops.Ciphertext) -> ops.Ciphertext:
    """y/B of one block from x, packed by ``linear.pack`` channel-major, at scale Δ."""
    r = _relu(ctx, plan, _conv(ctx, plan, 0, x))
    a = _conv(ctx, plan, 1, r)
    with span("fhe.resnet.shortcut"):
        short = ops._mul_const_exact(ctx, ops.level_drop(x, a.level + 1), 1.0 / BOUND, a.scale)
        a = polyeval._add_any(ctx, a, short)
    return _relu(ctx, plan, a)
