"""How ``correct`` is decided: the answers the timed window returned, decrypted
with the benchmark's secret key by the plain reference, against the
reference's own answer.

Every distinct answer is judged (repeats of one message give the same
ciphertext, so each distinct one is decrypted once).  Two numbers are compared:

  * ``max_err``: the largest |slot − expected| over every judged answer,
    each decoded at the level and scale it carries, as a client decodes it;
    an answer whose residues are no small integer in some limb reads ±inf and
    is reported as 1e300;
  * ``meta_mismatch``: answers whose level or scale differ from the
    reference's bookkeeping (an exact comparison, limit 0).

Imports nothing of the program.
"""

from __future__ import annotations

import hashlib
import importlib

import numpy as np

from fhebench.reference import ckks

HUGE = 1e300


def reference(job: str):
    return importlib.import_module(f"fhebench.reference.{job}")


def digest(c0: np.ndarray, c1: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(c0).tobytes() + np.ascontiguousarray(c1).tobytes()).hexdigest()


def judge(cfg: dict, mix: dict, inputs: dict, answers: dict, limit: float) -> dict:
    """answers: {digest: (pool index, c0, c1, level, scale)} → {"max_err", "meta_mismatch", "judged", "bad"};
    an answer is bad when its error passes ``limit`` or its level or scale differ."""
    level, scale, want = reference(mix["job"]).expected(cfg, mix, inputs)
    q, _ = ckks.moduli(cfg["L"], cfg["dnum"])
    worst, meta, bad = 0.0, 0, set()
    for key, (i, c0, c1, lv, sc) in answers.items():
        if lv != level or sc != scale or c0.shape[0] != level + 1:
            meta += 1
            bad.add(key)
            if c0.shape[0] != lv + 1 or lv > cfg["L"]:
                continue
        got = ckks.decrypt_decode(c0, c1, inputs["s"], q[: lv + 1], sc)
        err = float(np.max(np.abs(got - want[i])))
        err = err if np.isfinite(err) else HUGE
        worst = max(worst, min(err, HUGE))
        if not err <= limit:
            bad.add(key)
    return dict(max_err=worst, meta_mismatch=meta, judged=len(answers), bad=bad)


CONTROLS = ("residue", "scale24", "scale24_claimed")


def control_answers(cfg: dict, mix: dict, inputs: dict, rng: np.random.Generator, kind: str = "residue") -> dict:
    """A control: the reference's own answer in the program's place, each a fresh
    encryption of the expected slots at the expected level.

    ``residue``: at the expected scale, with its residue products taken in
    float64 instead of exactly (breaks the exact residue arithmetic).
    ``scale24``: exact, at the precision below the configuration's: Δ = 2^24 (a
    float32 mantissa's width) for the stated 2^30, and labelled so.
    ``scale24_claimed``: the same ciphertext labelled with the expected scale."""
    level, scale, want = reference(mix["job"]).expected(cfg, mix, inputs)
    q, _ = ckks.moduli(cfg["L"], cfg["dnum"])
    low = scale * 2.0 ** (24 - cfg["scale_bits"])
    enc_scale, label = {"residue": (scale, scale), "scale24": (low, low), "scale24_claimed": (low, scale)}[kind]
    out = {}
    for i, z in enumerate(want):
        c0, c1 = ckks.encrypt_sk(z, inputs["s"], q[: level + 1], enc_scale, rng, float_products=kind == "residue")
        out[digest(c0, c1)] = (i, c0, c1, level, label)
    return out
