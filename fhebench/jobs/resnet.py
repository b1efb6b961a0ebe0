"""One ResNet-20 basic block: ``FheContext.resnet_block`` on the client's
activation map (C × H × W, channel-major, encrypted at the top level and
replicated with period C·H·W over the slots).

Set-up builds the block's plan from the seeded weights (two BSGS transforms of
C·9 period-C·H·W diagonals each, with the configuration's baby-step counts),
the Galois keys of their rotations and the context under the default policy.
A job uploads the ciphertext, runs the block and copies y/B back to host
memory.  The diagonals and the biases are encoded once, at the levels and
scales where the first job meets them.
"""

from __future__ import annotations

from repro_torch.fhe import linear, resnet
from repro_torch.fhe.context import ExecPolicy, FheContext

from . import common


class Job:
    def __init__(self, cfg: dict, mix: dict, inputs: dict, device):
        p = common.params_of(cfg)
        self.device = device
        w, net = inputs["weights"], cfg["network"]
        self.plan = resnet.build_plan(w["conv1"], w["b1"], w["conv2"], w["b2"], p, net["height"], net["width"],
                                      n1=tuple(cfg["packing"]["n1"]))
        keys = common.keyset(p, inputs["s"], inputs["key_seeds"], sorted(self.plan.rotations()), device)
        self.ctx = FheContext(params=p, keys=keys, policy=ExecPolicy(), device=device)
        self.pool = [common.client_encrypt(self.ctx, linear.pack(x.reshape(-1), p.slots), seed)
                     for x, seed in zip(inputs["pool"], inputs["enc_seeds"])]

    def run(self, host: common.HostCiphertext, span) -> common.HostCiphertext:
        with span("upload"):
            x = common.upload(host, self.device)
        with span("resnet_block"):
            y = self.ctx.resnet_block(self.plan, x)
        with span("download"):
            return common.download(y)
