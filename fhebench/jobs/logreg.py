"""One period of logistic-regression training: ``FheContext.logreg_step`` on the
client's mini-batch (two ciphertexts of 128 rows × 256 features, row-major) and
model w_0 = v_0 (each encrypted at the top level and replicated with period 256).

Set-up builds the plan from the configuration's batch, features and Nesterov
schedule, the Galois keys of its 23 rotations and the context under the
default policy.  A job uploads the four ciphertexts, runs the iterations and
copies w_k back to host memory; v_k is computed and stays on the card.  The
masks are encoded once, at the levels and scales where the first job meets
them.
"""

from __future__ import annotations

from repro_torch.fhe import linear, logreg
from repro_torch.fhe.context import ExecPolicy, FheContext

from . import common


class Job:
    def __init__(self, cfg: dict, mix: dict, inputs: dict, device):
        p = common.params_of(cfg)
        self.device = device
        net, sched = cfg["network"], cfg["schedule"]
        self.plan = logreg.build_plan(p, net["features"], net["batch"], sched["learning_rate"], sched["momentum"])
        keys = common.keyset(p, inputs["s"], inputs["key_seeds"], sorted(self.plan.rotations()), device)
        self.ctx = FheContext(params=p, keys=keys, policy=ExecPolicy(), device=device)
        w0 = linear.pack(inputs["weights"]["w0"], p.slots)
        self.pool = [tuple(common.client_encrypt(self.ctx, x, seed + k)
                           for k, x in enumerate(logreg.pack_batch(z, p.slots) + [w0, w0]))
                     for z, seed in zip(inputs["pool"], inputs["enc_seeds"])]

    def run(self, host: tuple, span) -> common.HostCiphertext:
        with span("upload"):
            *zs, w, v = (common.upload(t, self.device) for t in host)
        with span("logreg_step"):
            w_k, _ = self.ctx.logreg_step(self.plan, zs, w, v)
        with span("download"):
            return common.download(w_k)
