"""The benchmark's inputs, all drawn from ``--seed``: one generator for every cell.

A run's inputs are the secret key the client holds, the seeds of the public
key material and of the client's encryptions, the configuration's weights
(``weights``: each a name, a shape and a sigma) and the pool of messages the
client sends (the mix's ``message``: a shape, where "slots" stands for N/2
and another name for that entry of the configuration's ``network``, and the
bounds of its uniform values).  Each comes from one NumPy stream in a
fixed order, so every seed gives the same sizes and only other values.  The
program receives the secret key, the weights and the messages; the reference
receives the same arrays.
"""

from __future__ import annotations

import numpy as np

from fhebench.reference import ckks


def make(cfg: dict, mix: dict, seed: int) -> dict:
    """{"s", "key_seeds", "enc_seeds", "weights", "pool"} for one run."""
    rng = np.random.default_rng(seed)
    n = cfg["n"]
    s = ckks.sample_ternary(rng, n, cfg["h"])
    key_seeds = [int(v) for v in rng.integers(0, 1 << 62, size=3)]
    weights = {w["name"]: rng.normal(0.0, w["sigma"], size=tuple(w["shape"])) for w in cfg.get("weights", [])}
    msg = mix["message"]
    size = lambda d: d if isinstance(d, int) else n // 2 if d == "slots" else cfg["network"][d]
    shape = tuple(size(d) for d in msg["shape"])
    pool = rng.uniform(msg["low"], msg["high"], size=(mix["pool"], *shape))
    enc_seeds = [int(v) for v in rng.integers(0, 1 << 62, size=mix["pool"])]
    return dict(s=s, key_seeds=key_seeds, enc_seeds=enc_seeds, weights=weights, pool=pool)
