"""One LSTM step: ``FheContext.lstm_step`` on the client's x_t, h_{t−1} and c_{t−1},
each encrypted at the top level and replicated with period ``hidden`` over the
slots.

Set-up builds the step's plan from the seeded weights (eight BSGS transforms of
period-``hidden`` diagonals), the Galois keys of their rotations and the context
under the default policy.  A job uploads the three ciphertexts, runs the step
and copies h_t back to host memory; c_t is computed and stays on the card.  The
biases are encoded once, at the level and scale where the first job meets them.
"""

from __future__ import annotations

from repro_torch.fhe import lstm
from repro_torch.fhe.context import ExecPolicy, FheContext

from . import common


class Job:
    def __init__(self, cfg: dict, mix: dict, inputs: dict, device):
        p = common.params_of(cfg)
        self.device = device
        w = inputs["weights"]
        self.plan = lstm.build_plan(w["W"], w["U"], w["b"], p, n1=cfg["packing"]["n1"])
        keys = common.keyset(p, inputs["s"], inputs["key_seeds"], sorted(self.plan.rotations()), device)
        self.ctx = FheContext(params=p, keys=keys, policy=ExecPolicy(), device=device)
        self.pool = [tuple(common.client_encrypt(self.ctx, lstm.pack(v, p.slots), seed + k) for k, v in enumerate(msg))
                     for msg, seed in zip(inputs["pool"], inputs["enc_seeds"])]

    def run(self, host: tuple, span) -> common.HostCiphertext:
        with span("upload"):
            x, h, c = (common.upload(t, self.device) for t in host)
        with span("lstm_step"):
            h_t, _ = self.ctx.lstm_step(self.plan, x, h, c)
        with span("download"):
            return common.download(h_t)
