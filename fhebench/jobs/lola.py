"""One LoLa-MNIST inference (the CryptoNets network): convolution, square, dense,
square, dense, each linear layer a BSGS matvec over the diagonals of
``lola_packing`` with its bias added.

Set-up builds the BSGS plans from the seeded weights (no dense matrix), the
Galois keys of their rotations and folds, and the context under the default
policy; the client's pool holds each image in the packed layout.  A job uploads
the client's ciphertext, runs every layer and copies the answer back to host
memory.  Each bias is encoded once, at the level and scale where the first job
meets it.
"""

from __future__ import annotations

from repro_torch.fhe import linear
from repro_torch.fhe.context import ExecPolicy, FheContext

from . import common, lola_packing


class Job:
    def __init__(self, cfg: dict, mix: dict, inputs: dict, device):
        p = common.params_of(cfg)
        self.device = device
        self.layers = lola_packing.layers(cfg, inputs["weights"])
        self.plans, level = [], p.L
        for layer in self.layers:
            self.plans.append(linear.plan_diags(layer.diags, p, level, hoisting=True, n1=layer.n1))
            level -= 2
        rotations = set().union(*(plan.rotations() for plan in self.plans), *(layer.folds for layer in self.layers))
        keys = common.keyset(p, inputs["s"], inputs["key_seeds"], sorted(rotations), device)
        self.ctx = FheContext(params=p, keys=keys, policy=ExecPolicy(), device=device)
        self.biases: dict = {}
        self.pool = [common.client_encrypt(self.ctx, lola_packing.image_slots(cfg, img), seed)
                     for img, seed in zip(inputs["pool"], inputs["enc_seeds"])]

    def bias(self, i: int, ct):
        key = (i, ct.level, ct.scale)
        if key not in self.biases:
            self.biases[key] = self.ctx.encode(self.layers[i].bias, level=ct.level, scale=ct.scale)
        return self.biases[key]

    def run(self, host: common.HostCiphertext, span) -> common.HostCiphertext:
        with span("upload"):
            ct = common.upload(host, self.device)
        for i, (layer, plan) in enumerate(zip(self.layers, self.plans)):
            with span(layer.name):
                ct = self.ctx.apply_bsgs(ct, plan)
            with span(f"{layer.name}.fold"):
                for r in layer.folds:
                    ct = self.ctx.add(ct, self.ctx.rotate(ct, r))
                ct = self.ctx.add_plain(ct, self.bias(i, ct))
            if i + 1 < len(self.layers):
                with span(f"square.{i + 1}"):
                    ct = self.ctx.square(ct)
        with span("download"):
            return common.download(ct)
