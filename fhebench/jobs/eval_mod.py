"""One EvalMod of packed bootstrapping: ``FheContext.eval_mod`` on a top-level
ciphertext whose slots are what CoeffToSlot would hand it.

Set-up builds the keys (no Galois key: EvalMod rotates nothing) and the
``BootstrapContext`` field by field at the configuration's K and degree, with
no BSGS plans, since CoeffToSlot and SlotToCoeff are not run.
"""

from __future__ import annotations

from repro_torch.fhe import bootstrap, polyeval
from repro_torch.fhe.context import ExecPolicy, FheContext

from . import common


class Job:
    def __init__(self, cfg: dict, mix: dict, inputs: dict, device):
        p = common.params_of(cfg)
        self.device = device
        keys = common.keyset(p, inputs["s"], inputs["key_seeds"], (), device)
        k, degree = cfg["eval_mod"]["K"], cfg["eval_mod"]["degree"]
        self.bctx = bootstrap.BootstrapContext(
            params=p, keys=keys, cts_plans=(), stc_plans=(),
            sine_coeffs=polyeval.chebyshev_fit(bootstrap.eval_mod_target(p, k), degree),
            K=k, eval_mod_degree=degree)
        self.ctx = FheContext(params=p, keys=keys, policy=ExecPolicy(), device=device)
        self.coeff_scale = mix["input_norm"] * (k + 0.5) * float(p.q_primes[0])
        self.pool = [common.client_encrypt(self.ctx, z, seed) for z, seed in zip(inputs["pool"], inputs["enc_seeds"])]

    def run(self, host: common.HostCiphertext, span) -> common.HostCiphertext:
        with span("upload"):
            ct = common.upload(host, self.device)
        with span("eval_mod"):
            ct = self.ctx.eval_mod(self.bctx, ct, self.coeff_scale)
        with span("download"):
            return common.download(ct)
