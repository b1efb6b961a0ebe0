"""Evaluation contexts: the public API of ``repro_torch.fhe``.

``FheContext`` bundles what an evaluation needs:

  * ``CkksParams``  — the cryptographic parameter set,
  * ``KeySet``      — public/secret/relinearisation keys,
  * ``ExecPolicy``  — *how* to execute (the key-switch pipeline and the other
                      knobs of the reference package's policy, with the same
                      ``policy_key()``),
  * ``device``      — where every tensor of the evaluation lives.  The default
                      is "cuda"; without a card that raises, and nothing moves
                      to the CPU unless the caller passes ``device="cpu"``.

Quick use::

    from repro_torch.fhe import FheContext, ExecPolicy, bootstrap, logreg, lstm, resnet, keys as K, params as P

    p = P.workload_params("matmul")
    ctx = FheContext(params=p, keys=K.full_keyset(p, seed=0, rotations=(1, 2)))
    ct = ctx.encrypt(ctx.encode(x))
    y = ctx.decrypt_decode(ctx.mul(ct, ct))
    g = ctx.rotate_hoisted_group(ct, (1, 2))      # {1: rot_1(x), 2: rot_2(x)}, one ModUp
    plan = ctx.plan_matrix(m, tol=1e-12)          # BSGS diagonals of an slots×slots matrix
    mv = ctx.apply_bsgs(ct, plan)                 # needs keys for plan.rotations()
    y = ctx.eval_poly(ct, coeffs)                 # Σ c_i·T_i(x), Chebyshev basis
    h1, c1 = ctx.lstm_step(lstm.build_plan(W, U, b, p), x, h0, c0)   # one LSTM step
    w4, v4 = ctx.logreg_step(logreg.build_plan(p, 256, 256, rates, momenta), zs, w0, v0)  # HELR training
    y = ctx.resnet_block(resnet.build_plan(w1, b1, w2, b2, p, 32, 32), x)  # one ResNet-20 basic block

    sp = P.workload_params("psi")                 # plain_modulus set: a BGV context
    bgv = FheContext(params=sp, keys=K.full_keyset(sp, seed=0))
    w = bgv.decrypt_decode(bgv.mul(bgv.encrypt(bgv.encode(u)), bgv.encrypt(bgv.encode(v))))  # u ⊛ v mod t

    bp = P.make_params(1 << 8, 18, 1, check_security=False)  # a chain deep enough to bootstrap
    bctx = bootstrap.build_context(bp, seed=0, h=32)          # BSGS plans, sine fit, Galois keys
    fresh = FheContext(params=bp, keys=bctx.keys).bootstrap(bctx, exhausted, post_scale=64)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import dispatch

from . import bgv as _bgv
from . import bootstrap as _bootstrap
from . import keyswitch, linear, logreg, lstm, ops, polyeval, resnet
from .keys import KeySet, SwitchingKey
from .params import CkksParams

BACKENDS = ("fused", "kernel", "staged", "ref", "auto")
HOISTING_MODES = ("never", "auto", "always")
NUMERICS_MODES = ("standard",)
SCHEMES = ("ckks", "bgv")


@dataclasses.dataclass(frozen=True)
class ExecPolicy:
    """How to execute: every evaluation-shaping knob, in one immutable value.

    The fields and ``policy_key()`` are the reference package's, so a policy
    names the same configuration in both.  ``dispatch_hook`` is not part of
    the key (or of equality): observing kernel launches cannot change them.
    """

    backend: str = "auto"  # kernel pipeline: fused | kernel | staged | ref | auto
    hoisting: str = "auto"  # rotation key-switch shape: never | auto | always
    numerics: str = "standard"
    scheme: str = "ckks"
    dispatch_hook: Callable[[str], None] | None = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown key-switch backend {self.backend!r}")
        if self.hoisting not in HOISTING_MODES:
            raise ValueError(f"unknown hoisting mode {self.hoisting!r}")
        if self.numerics not in NUMERICS_MODES:
            raise ValueError(f"unknown numerics mode {self.numerics!r}; available: {NUMERICS_MODES}")
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {self.scheme!r}; available: {SCHEMES}")

    def policy_key(self) -> tuple[str, str, str, str]:
        """Hashable identity (scheme, backend, hoisting, numerics); excludes the hook."""
        return (self.scheme, self.backend, self.hoisting, self.numerics)

    def replace(self, **changes) -> "ExecPolicy":
        return dataclasses.replace(self, **changes)

    def for_scheme(self, scheme: str) -> "ExecPolicy":
        """This policy re-tagged for ``scheme`` (itself when it already matches)."""
        return self if scheme == self.scheme else dataclasses.replace(self, scheme=scheme)

    def traced(self, tracer) -> "ExecPolicy":
        """This policy with its kernel launches recorded into ``tracer`` (a
        ``repro_torch.obs.Tracer``): each dispatch becomes a unit-width slice at
        its dispatch index (kernels have no sim-time of their own).  Composes
        with an existing hook — both observe every launch.  A disabled tracer
        (or None) returns ``self`` unchanged, preserving the zero-overhead rule.
        ``policy_key`` ignores hooks, so the traced policy prices identically.
        """
        if tracer is None or not tracer:
            return self
        traced_hook = tracer.dispatch_hook()
        prior = self.dispatch_hook
        if prior is None:
            hook = traced_hook
        else:
            def hook(op: str) -> None:
                prior(op)
                traced_hook(op)
        return dataclasses.replace(self, dispatch_hook=hook)

    # -- resolved views -----------------------------------------------------
    # The reference also resolves ``stage`` and ``plan_fused`` here, on JAX's
    # default backend.  This package resolves "auto" on a device, which a
    # policy does not hold, so those two views live on ``FheContext``.

    @property
    def plan_hoist(self) -> bool:
        """Does this policy hoist BSGS baby-step groups?  ``auto`` counts as
        hoisted: every multi-rotation group shares its ModUp."""
        return self.hoisting != "never"


def _hooked(fn):
    """Run a context method under the policy's dispatch-counter hook."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        hook = self.policy.dispatch_hook
        if hook is None:
            return fn(self, *args, **kwargs)
        with dispatch.hook_dispatches(hook):
            return fn(self, *args, **kwargs)

    return wrapper


@dataclasses.dataclass(frozen=True)
class FheContext:
    """Immutable (params, keys, policy, device) bundle — the context every op runs in."""

    params: CkksParams
    keys: KeySet | None = None
    policy: ExecPolicy = ExecPolicy()
    device: torch.device | str = "cuda"

    def __post_init__(self):
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FheContext on device 'cuda' needs a CUDA card; pass device='cpu' for the CPU")
        if self.keys is not None and self.keys.device.type != dev.type:
            raise ValueError(f"keys live on {self.keys.device}, the context on {dev}")
        object.__setattr__(self, "device", dev)
        # the scheme is ground truth on the params (plain_modulus set ⇔ BGV)
        object.__setattr__(self, "policy", self.policy.for_scheme(self.params.scheme))

    def with_policy(self, policy: ExecPolicy | None = None, **changes) -> "FheContext":
        """A context with an overridden policy (same params/keys/device)."""
        if policy is not None and changes:
            raise TypeError("pass either a policy or field overrides, not both")
        new = policy if policy is not None else self.policy.replace(**changes)
        return dataclasses.replace(self, policy=new)

    def with_keys(self, keys: KeySet) -> "FheContext":
        return dataclasses.replace(self, keys=keys)

    def policy_key(self) -> tuple[str, str, str, str]:
        return self.policy.policy_key()

    @property
    def scheme(self) -> str:
        return self.policy.scheme

    @property
    def backend(self) -> str:
        """Key-switch pipeline choice, passed to the ``keyswitch`` layer."""
        return self.policy.backend

    @property
    def pipeline(self) -> str:
        """The key-switch pipeline this context runs: "fused" or "staged"."""
        return keyswitch.resolve_pipeline(self.backend, self.device)[0]

    @property
    def stage(self) -> str:
        """Pointwise-stage backend the policy resolves to on this context's device."""
        return keyswitch.resolve_pipeline(self.backend, self.device)[1]

    @property
    def plan_fused(self) -> bool:
        """Does this context run the fused key-switch pipeline?"""
        return self.pipeline == "fused"

    def require_keys(self) -> KeySet:
        if self.keys is None:
            raise ValueError("this operation needs a KeySet; build the context with keys= or use ctx.with_keys(...)")
        return self.keys

    # -- encode / encrypt / decrypt -----------------------------------------

    @_hooked
    def encode(self, z, level: int | None = None, scale: float | None = None):
        if self.scheme == "bgv":
            return _bgv._encode(self, z, level)
        return ops._encode(self, z, level, scale)

    @_hooked
    def encode_const(self, c, level: int, scale: float):
        return ops._encode_const(self, c, level, scale)

    @_hooked
    def decode(self, pt):
        if self.scheme == "bgv":
            return _bgv._decode(self, pt)
        return ops._decode(self, pt)

    @_hooked
    def encrypt(self, pt, seed: int = 17):
        if self.scheme == "bgv":
            return _bgv._encrypt(self, self.require_keys().pk, pt, seed)
        return ops._encrypt(self, self.require_keys().pk, pt, seed)

    @_hooked
    def decrypt(self, ct):
        if self.scheme == "bgv":
            return _bgv._decrypt(self, self.require_keys().sk, ct)
        return ops._decrypt(self, self.require_keys().sk, ct)

    @_hooked
    def decrypt_decode(self, ct):
        sk = self.require_keys().sk
        if self.scheme == "bgv":
            return _bgv._decode(self, _bgv._decrypt(self, sk, ct))
        return ops._decode(self, ops._decrypt(self, sk, ct))

    # -- additive ops -------------------------------------------------------

    @_hooked
    def add(self, a, b):
        if self.scheme == "bgv":
            return _bgv._add(self, a, b)
        return ops._add(self, a, b)

    @_hooked
    def sub(self, a, b):
        if self.scheme == "bgv":
            return _bgv._sub(self, a, b)
        return ops._sub(self, a, b)

    @_hooked
    def negate(self, a):
        if self.scheme == "bgv":
            return _bgv._negate(self, a)
        return ops._negate(self, a)

    @_hooked
    def add_plain(self, a, pt):
        return ops._add_plain(self, a, pt)

    @_hooked
    def add_const(self, a, c):
        return ops._add_const(self, a, c)

    def level_drop(self, ct, level: int):
        return ops.level_drop(ct, level)

    # -- multiplicative ops -------------------------------------------------

    @_hooked
    def mul_plain(self, a, pt, rescale_after: bool = True):
        return ops._mul_plain(self, a, pt, rescale_after)

    @_hooked
    def mul_const(self, a, c, rescale_after: bool = True):
        return ops._mul_const(self, a, c, rescale_after)

    @_hooked
    def mul_const_exact(self, a, c, target_scale: float):
        return ops._mul_const_exact(self, a, c, target_scale)

    @_hooked
    def mul(self, a, b, rlk: SwitchingKey | None = None, rescale_after: bool = True):
        """Ciphertext-ciphertext multiplication with relinearisation.  Under a
        BGV context, ``rescale_after`` means "modulus-switch one level down
        after the product" (the BGV analogue of the CKKS rescale)."""
        rlk = rlk if rlk is not None else self.require_keys().rlk
        if self.scheme == "bgv":
            return _bgv._mul(self, a, b, rlk, mod_switch_after=rescale_after)
        return ops._mul(self, a, b, rlk, rescale_after)

    @_hooked
    def square(self, a, rlk: SwitchingKey | None = None, rescale_after: bool = True):
        rlk = rlk if rlk is not None else self.require_keys().rlk
        if self.scheme == "bgv":
            return _bgv._mul(self, a, a, rlk, mod_switch_after=rescale_after)
        return ops._mul(self, a, a, rlk, rescale_after)

    @_hooked
    def rescale(self, ct):
        if self.scheme == "bgv":
            raise ValueError("BGV has no rescale; use ctx.mod_switch(ct) instead")
        return ops._rescale(self, ct)

    @_hooked
    def mod_switch(self, ct):
        """BGV modulus switch: drop the last chain prime, preserving the
        message mod t exactly (q_ℓ ≡ 1 mod t on the shared chain)."""
        if self.scheme != "bgv":
            raise ValueError("mod_switch is a BGV op; use ctx.rescale for CKKS")
        return _bgv._mod_switch(self, ct)

    # -- rotations / conjugation --------------------------------------------

    @_hooked
    def rotate(self, ct, r: int):
        """Cyclic slot rotation by r; the policy's hoisting mode picks the
        key-switch shape ("always" routes a single rotation through the
        hoisted path — bit-exact either way)."""
        return ops._rotate(self, ct, r, self.require_keys())

    @_hooked
    def rotate_hoisted(self, ct, r: int, hoisted=None):
        return ops._rotate_hoisted(self, ct, r, self.require_keys(), hoisted)

    @_hooked
    def rotate_hoisted_group(self, ct, rots) -> dict:
        return ops._rotate_hoisted_group(self, ct, rots, self.require_keys())

    @_hooked
    def conjugate(self, ct):
        return ops._conjugate(self, ct, self.require_keys())

    # -- linear transforms ---------------------------------------------------

    def plan_matrix(self, m, n1: int | None = None, tol: float = 0.0,
                    level: int | None = None) -> linear.BsgsPlan:
        """BSGS plan for a dense matrix; when ``n1`` is not forced, the baby
        count comes from the hoisting-aware cost model (under a hoisting
        policy, baby steps are nearly free, so the optimum shifts upward)."""
        return linear.plan_matrix(
            m, n1=n1, tol=tol, params=self.params,
            level=self.params.L if level is None else level,
            hoisting=self.policy.plan_hoist,
        )

    @_hooked
    def apply_bsgs(self, ct, plan: linear.BsgsPlan, scale: float | None = None):
        return linear._apply_bsgs(self, ct, plan, scale)

    @_hooked
    def apply_bsgs_pair(self, ct, plans, scale: float | None = None):
        return (
            linear._apply_bsgs(self, ct, plans[0], scale),
            linear._apply_bsgs(self, ct, plans[1], scale),
        )

    @_hooked
    def real_part(self, ct):
        return linear._real_part(self, ct)

    @_hooked
    def imag_part(self, ct):
        return linear._imag_part(self, ct)

    # -- polynomial evaluation ----------------------------------------------

    @_hooked
    def force_to(self, ct, level: int, scale: float):
        return polyeval._force_to(self, ct, level, scale)

    @_hooked
    def add_any(self, a, b):
        return polyeval._add_any(self, a, b)

    @_hooked
    def chebyshev_basis(self, x, degree: int) -> polyeval.ChebyshevBasis:
        return polyeval.ChebyshevBasis(self, x, degree)

    @_hooked
    def eval_poly(self, ct, coeffs, degree: int | None = None):
        """Σ c_i·T_i(ct) in the Chebyshev basis (exact scale discipline)."""
        degree = len(np.asarray(coeffs)) - 1 if degree is None else degree
        basis = polyeval.ChebyshevBasis(self, ct, degree)
        return polyeval._eval_chebyshev(self, basis, coeffs)

    @_hooked
    def eval_chebyshev(self, basis: polyeval.ChebyshevBasis, coeffs):
        return polyeval._eval_chebyshev(self, basis, coeffs)

    # -- models --------------------------------------------------------------

    @_hooked
    def lstm_step(self, plan: lstm.LstmPlan, x, h, c):
        """(h_t, c_t) of one LSTM step: the gates' BSGS matvecs, the polynomial
        activations and the cell's products (``repro_torch.fhe.lstm``)."""
        return lstm._lstm_step(self, plan, x, h, c)

    @_hooked
    def logreg_step(self, plan: logreg.LogregPlan, zs, w, v):
        """(w_k, v_k) after one period of encrypted logistic-regression training:
        k Nesterov iterations on the batch's ciphertexts zs (``repro_torch.fhe.logreg``)."""
        return logreg._logreg_step(self, plan, zs, w, v)

    @_hooked
    def resnet_block(self, plan: resnet.ResnetBlockPlan, x):
        """y/B of one ResNet-20 basic block: two convolutions as BSGS matvecs
        and two composite-polynomial ReLUs around an identity shortcut
        (``repro_torch.fhe.resnet``)."""
        return resnet._resnet_block(self, plan, x)

    # -- bootstrapping -------------------------------------------------------

    @_hooked
    def bootstrap(self, bctx: _bootstrap.BootstrapContext, ct, post_scale: float | None = None):
        """Refresh an exhausted ciphertext through ``bctx``'s precomputed
        plans/keys under THIS context's execution policy."""
        return _bootstrap._bootstrap(self._bootstrap_ctx(bctx), bctx, ct, post_scale)

    @_hooked
    def mod_raise(self, bctx, ct):
        return _bootstrap._mod_raise(self._bootstrap_ctx(bctx), bctx, ct)

    @_hooked
    def coeff_to_slot(self, bctx, ct):
        return _bootstrap._coeff_to_slot(self._bootstrap_ctx(bctx), bctx, ct)

    @_hooked
    def eval_mod(self, bctx, ct, coeff_scale: float):
        return _bootstrap._eval_mod(self._bootstrap_ctx(bctx), bctx, ct, coeff_scale)

    @_hooked
    def slot_to_coeff(self, bctx, a0, a1):
        return _bootstrap._slot_to_coeff(self._bootstrap_ctx(bctx), bctx, a0, a1)

    def _bootstrap_ctx(self, bctx) -> "FheContext":
        """This policy over the bootstrap context's params/keys (the plans are
        precomputed against those — a mismatched KeySet would be unsound)."""
        assert bctx.params == self.params, "BootstrapContext params differ from this FheContext's params"
        assert bctx.keys.device.type == self.device.type, (
            f"BootstrapContext keys live on {bctx.keys.device}, the context on {self.device}"
        )
        if self.keys is bctx.keys:
            return self
        return dataclasses.replace(self, keys=bctx.keys)
