#!/usr/bin/env python3
"""Drive the ``repro_torch`` port on one CUDA card and check it end to end.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. print the card's name and power limit, then build every CUDA kernel of
     ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at once);
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the paths below give it — the CKKS multiply at the ``lstm``
     (N = 2^16) and ``matmul`` (N = 2^13) presets, with the rescale's 1-limb
     NTT and a ragged-digit key-switch at ``lstm``, the MLP's widest NTT,
     BConv on the staged pipeline, ModDown over a group's 8 accumulators at
     ``lstm`` and at ``lola_mnist_plain``, the hoisted ModUp (at ``lstm``'s
     top level and ragged level 9) and Galois MAC at ``lstm`` and
     ``lola_mnist_plain``, and BConv where it is large (the dnum = 1 preset
     ``packed_bootstrap``'s 58 → 116 and 58 → 58 limbs, ``logreg``'s 17 → 51),
     the key-switch kernels with one digit (β = 1) at ``packed_bootstrap``'s
     top level (58 → 116 limbs) with its 58-limb products, sums, differences
     and NTTs, the bootstrap ring's BConv and NTT, and the BGV presets' shapes
     that no other case has (``exact_count``'s products, its t-scaling product
     by a per-limb column over the extended basis, its NTT, key-switch kernels
     and BConvs; ``psi``'s ``fused_ks``), ``bsgs_mac`` at one of the
     ``lstm`` step's BSGS plans and LoLa-MNIST's three (``BSGS_MAC_CASES``),
     and ``fused_rescale`` from the top level of ``lola_mnist_plain``,
     ``lstm``, ``logreg`` and ``packed_bootstrap`` (57 → 56, by pass)
     — bit-exact, launched, timed with CUDA events; the two-pass kernels (NTT,
     ``fused_ks``, ``fused_moddown``, ``hoist_modup``) print the thread blocks
     their launcher starts per pass, and BConv its grid;
  3. run the paths through the public API, each with the launch counters set
     to 0 just before it and read just after, and check each against the
     reference package's SHA-256 digests, dispatch counts and decode errors,
     and that every dispatch launched a kernel:
       3.  keygen, encode, encrypt, ``ctx.mul`` (fused key-switch), decrypt,
           decode, for both presets;
       3a. ``ctx.mul`` again under ``ExecPolicy(backend="staged")`` (BConv);
       3b. the encrypted MLP of ``examples/fhe_inference.py`` at
           ``lola_mnist_plain`` (two hoisted BSGS matvecs and a square);
       3c. a hoisted group of rotations by 1, 2, 3, 4 at ``lstm``, and one
           standard rotation;
       3d. a whole CKKS bootstrap (ModRaise, CoeffToSlot, EvalMod,
           SlotToCoeff) at the ring of ``tests/test_bootstrap.py``
           (n = 2^8, L = 18, dnum = 1), under the default policy (fused,
           hoisted) and under ``ExecPolicy(backend="staged")``: every one of
           the nine kernels launches;
       3e. ModRaise (1 → 58 limbs) and EvalMod (a degree-32 Chebyshev tree,
           31 relinearisations with one key-switch digit) at the
           ``packed_bootstrap`` preset's full width (N = 2^16, L = 57);
       3f. BGV at the ``psi`` (N = 2^13, L = 6, t = 2) and ``exact_count``
           (N = 2^13, L = 4, t = 2^16) presets' full width, under the default
           (fused) policy and ``ExecPolicy(backend="staged")``: encode,
           encrypt, add, sub, negate, a depth-2 product chain with a mod-switch
           after each product, one more product with an explicit
           ``ctx.mod_switch``, decrypt and decode, each output against the
           reference's digest and every decoded integer against the
           negacyclic oracle mod t;
       3g. the multi-job executor: 8 jobs of ``ctx.mul`` at ``matmul`` over 8
           affiliations, one CUDA stream each, from cold tables (the side
           streams build them), no table built by a later fan-out; each
           job against its lone ``ctx.mul`` and the reference's digest, the
           kernels of the profiler's trace on ≥ 8 distinct streams, and the
           host time of the 8 jobs on 8 streams against 1 stream;
       3h. the planner (``repro_torch.core.planner``) against the instruction
           traces of ops whose kernels run on the card, under the fused,
           staged and "auto" pipelines: ``ctx.mul`` at ``lstm``'s top level and
           at level 9 (the ragged second digit), ``ctx.rotate``, the hoisted
           group of 4, the MLP's first ``apply_bsgs`` hoisted and not, BGV
           ``ctx.mul`` at ``psi`` and ``ctx.mod_switch`` at ``exact_count``;
           a ``ctx.mul`` at ``lstm`` under ``ExecPolicy.traced``, its 19
           slices against the dispatches, the launches and the reference's
           slice names; and the scheduling layer on the card's host (every
           preset planned and priced, the obs smoke fleet traced and not, five
           serving scenarios), each against the reference's SHA-256 in
           ``SCHEDULING``, with its host time; the trace goes to
           ``build/obs_trace.json``;
       3i. the LLM serving path (``repro_torch.models``, ``serving``,
           ``launch``), which launches none of the kernels above:
           ``smollm-135m`` at full width (weights from a numpy seed in the
           reference's layout, ``LLM``), prefill and 8 teacher-forced decode
           steps on the card against the port's CPU path (``LLM_TOL``), once
           more with cuBLAS's reduced-precision reductions allowed, for the
           record; prefill and decode times (CUDA events), tokens/s and the
           profiler's busy share of one decode step; ``Engine.generate`` of
           32 greedy tokens twice, which must agree; the nine other archs at
           SMOKE width, prefill and one decode step against the CPU path
           (``SMOKE_TOL``); and ``launch.serve --arch smollm-135m --full``;
       3j. the training path (``repro_torch.training``, ``checkpoint``,
           ``roofline``, ``launch.train``), which launches none of the kernels
           above either: one AdamW train step of each of the ten archs at
           SMOKE width against the CPU path (``SMOKE_TRAIN_TOL``);
           ``smollm-135m`` at full width, one step at 2 × 128 against the
           CPU path (loss, gradient norm and correlation, the params after
           the step: ``TRAIN_TOL``), the int8 gradient compression against
           the CPU's bits and over a one-rank NCCL group, then 16 × 512 with
           remat (ms a step by CUDA events, tokens/s, MFU, the roofline's
           terms, peak memory, the profiler's busy share, microbatch 4);
           ``launch.train.run`` at SMOKE for 300 steps with a checkpoint every
           100, a restore, a resume from step 200 against the uninterrupted
           losses, and 48 greedy tokens from the trained params;
       3k. sharding (``repro_torch.distributed``, ``launch.mesh``,
           ``launch.dryrun``), which launches none of the kernels above:
           ``smollm-135m`` at full width, two train steps at 16 × 512 by
           ``jit_train_step`` on a 1×1 NCCL mesh (params, moments and batch as
           DTensors) against ``build_train_step(mesh=None)``, bit for bit, and
           ms a step of both; the multi-job step lowered on an 8-affiliation
           fake ("aff",) mesh, its graph run on each job's inputs on the card
           against ``EXECUTOR``'s digests; and, after every timed phase, the
           dry-run cells of ``DRYRUN`` in processes of their own, each on the
           fake mesh with device type "cuda" against "cpu";
  4. print one JSON line of per-kernel numbers, then the result line.

It needs one CUDA card, ``nvcc`` and the repository's ``src/`` beside it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
DEVICE = "cuda"

# Reference digests: SHA-256 of c0‖c1 (little-endian u32) of ctx.mul(a, a) from
# the reference package on the CPU, computed as
#   p = P.workload_params(name); ks = K.full_keyset(p, seed=0)
#   z = np.random.default_rng(0).normal(size=p.slots) * 0.4
#   ctx = FheContext(params=p, keys=ks, policy=ExecPolicy(backend="ref"))
#   a = ctx.encrypt(ctx.encode(z)); out = ctx.mul(a, a)
#   hashlib.sha256(np.asarray(out.c0).astype("<u4").tobytes()
#                  + np.asarray(out.c1).astype("<u4").tobytes()).hexdigest()
REFERENCE = {
    "matmul": dict(digest="916a0ff591277d18ac29e136e1a9bc6dda301eb8483c05e2011a172e04b70c0d", max_err=5e-4),
    "lstm": dict(digest="1f5706f0f21cb1e874f733f4ab80b2798de9405a2475214edb25587d55c5cc54", max_err=5e-3),
}
# Dispatches of one fused ctx.mul (rescale included) in the reference package.
FUSED_MUL_DISPATCHES = {"mulmod": 6, "addmod": 3, "submod": 2, "ntt": 2, "intt": 4, "fusedks": 1, "fused_moddown": 1}
# The reference's dispatches of one component of a rescale, in order.  Under the
# fused pipeline the port rescales both components in one ``rescale`` dispatch
# (one fused_rescale launch); the staged pipeline keeps the reference's.
RESCALE_OPS = ("intt", "ntt", "submod", "mulmod")


def fused_rescale_counts(ref_counts: dict, rescales: int) -> dict:
    """The reference's dispatch counts of a block that ran ``rescales``
    rescales, as the port's under the fused pipeline: 2 of each of
    ``RESCALE_OPS`` fewer, one ``rescale`` more, a rescale (ROADMAP Queue 3)."""
    out = dict(ref_counts)
    for op in RESCALE_OPS:
        out[op] = out.get(op, 0) - 2 * rescales
    out["rescale"] = out.get("rescale", 0) + rescales
    assert all(v >= 0 for v in out.values()), out
    return {k: v for k, v in out.items() if v}


# ... and of one staged ctx.mul, per preset (β = 3 at matmul, 2 at lstm).
STAGED_MUL_DISPATCHES = {
    "matmul": {"mulmod": 19, "addmod": 9, "submod": 4, "ntt": 7, "intt": 5, "bconv": 5},
    "lstm": {"mulmod": 16, "addmod": 7, "submod": 4, "ntt": 6, "intt": 5, "bconv": 4},
}

# The encrypted MLP of examples/fhe_inference.py at the lola_mnist_plain preset
# (see mlp_model): digests of ct1 = apply_bsgs(x, plan1) and of
# ct3 = apply_bsgs(square(ct1), plan2), from the reference package on the CPU
# with the same keys (full_keyset(p, seed=0, rotations=plan1 ∪ plan2)), the
# same encryption seed and ExecPolicy(backend="ref").  The reference's decode
# error against the cleartext MLP is 1.289e-3.
MLP = dict(
    preset="lola_mnist_plain", plans=(8, 8, 31, 19), galois_keys=10, max_err=5e-3,
    ct1="43c34f4048a690d8c129d407a8b381b11983f1a714d389ca4285757faf29209c",
    ct3="c9de09c31e931e130df5ce2054c2a57b4e91c384993ba7456c2eebb6e261db12",
)
# A hoisted group at the lstm preset: full_keyset(p, seed=0, rotations=(1, 2, 3, 4)),
# z = default_rng(0).normal(size=slots)·0.4, g = ctx.rotate_hoisted_group(ctx.encrypt(ctx.encode(z)), rotations);
# the digest runs over g[1], g[2], g[3], g[4], and decode_errors are the reference's
# max |decode(g[r]) − roll(z, −r)|.  They are key-switch noise at a 2^30 scale and
# N = 2^16, and the port must give the same values, not smaller ones.
LSTM_GROUP = dict(
    preset="lstm", rotations=(1, 2, 3, 4),
    digest="0afacbe461cfb47d9fae23220f7061d55273193220e09722cddd83b5dc7e35d5",
    decode_errors=(0.11318043501489981, 0.09604106998682596, 0.16380365372399094, 0.06704722754331537),
)
# The bootstrap of tests/test_bootstrap.py, from the reference package on the CPU:
#   p = P.make_params(1 << 8, 18, 1, check_security=False); bctx = B.build_context(p, seed=0, h=32)
#   fc = FheContext(params=p, keys=bctx.keys, policy=ExecPolicy(backend="ref"))
#   rng = np.random.default_rng(7); z = rng.normal(size=p.slots) * 0.4 + 1j * rng.normal(size=p.slots) * 0.4
#   ct = ops.level_drop(fc.mul_const(fc.encrypt(fc.encode(z)), 1 / 64), 0)
#   out = fc.bootstrap(bctx, ct, post_scale=64)
# digest(out), out.level, the reference's max |decode(out) − z| and the
# dispatches of that bootstrap (the staged pipeline, baby steps hoisted), less
# the ntt of each of its 303 real constants, which the port builds with none,
# and with the products and sums of each of its 4 BSGS matvecs (128 diagonals
# in 8 giant groups) as one bsgsmac: 4 × 256 mulmod and 4 × 240 addmod fewer.
# max_err is tests/test_bootstrap.py's bound.
BOOTSTRAP = dict(
    n=1 << 8, L=18, dnum=1, h=32, level=6, max_err=5e-2,
    digest="b1e6b0bbdf170beb7348a98ccbd92ee79dc4d513ea172400ab8c7face8a10d42",
    decode_error=0.0036717060197168348,
    staged_dispatches={"intt": 1454, "ntt": 1966, "mulmod": 3510, "bconv": 682, "addmod": 1814, "submod": 1418,
                       "bsgsmac": 4},
)
# ModRaise and EvalMod at packed_bootstrap (N = 2^16, L = 57, dnum = 1), from the
# reference package on the CPU with ks = K.full_keyset(p, seed=0) (no Galois keys),
# the BootstrapContext of packed_bootstrap_context (K = 2, degree 32, no BSGS plans)
# and ExecPolicy(backend="ref"):
#   z = np.random.default_rng(0).normal(size=p.slots) * 0.4
#   raised = fc.mod_raise(bctx, ops.level_drop(fc.mul_const(fc.encrypt(fc.encode(z)), 1 / 64), 0))
#   x = np.random.default_rng(3).uniform(-0.95, 0.95, p.slots)
#   em = fc.eval_mod(bctx, fc.encrypt(fc.encode(x)), coeff_scale=0.5 * (K + 0.5) * q0)
# digest(raised) at level 57, digest(em) at level 50, and the reference's
# max |decode(em).real − Chebyshev(sine_coeffs)(0.5·x)|.
PACKED = dict(
    preset="packed_bootstrap", K=2, degree=32, eval_mod_level=50,
    mod_raise="08c5f260c344af30f969bbced73bc735e1a32c307f25297b684362148c63d6ed",
    eval_mod="65bf9a4466424abd02fda176972ba06ff8be6d33bf4ac70104eee9fdd296bf2a",
    decode_error=0.0008170160934633103,
)
# BGV at the psi and exact_count presets, from the reference package on the CPU:
#   p = P.workload_params(name); ks = K.full_keyset(p, seed=0)
#   ctx = FheContext(params=p, keys=ks, policy=ExecPolicy(backend="ref"))
#   outs, decoded = bgv_path(ctx, bgv_messages(p))
# the level and digest(outs[k]) of each output; its decoded integers equal
# bgv_oracle(...) in both packages.  The reference's fused pipeline gives the same
# digests.  Dispatches of one bgv_path (encode to decode) in the reference, under
# backend="ref" (staged) and "fused": both presets have dnum = 3, so three
# key-switch digits at the top level and two below at both.
BGV = {
    "psi": dict(levels=dict(add=6, sub=6, neg=6, ab=5, abc=4, switched=3),
                digests=dict(add="fcf3ebe8fbd7493c13292740b04ff84df2a0b8170c149fbe706258b7897fa635",
                             sub="47ca919395392d7b515fd44f6066c172b9ae23aa23311abcd3725c65d63503c6",
                             neg="7b047998b7a58994a5edc6e15d46bff2c3d162ac1361a40f73bcaf37683dd131",
                             ab="b7be7dd494a19c187ed5897191c0989b06f63a5b7e0c6ab09e4836b526d9f0d4",
                             abc="ab7ce5f15db75e16079752b774cf8520f76f16d02b1b4869ebfbf77962ae1437",
                             switched="b666b7cd80f0244b4237196aa746c50454b5ecfa1206b4267993a5176134946e")),
    "exact_count": dict(levels=dict(add=4, sub=4, neg=4, ab=3, abc=2, switched=1),
                        digests=dict(add="f3b3e08f77a253e83da0283ea8e2e31fe8393a56a040413d09a6999aa6e27260",
                                     sub="52863a1525eb03225a53e1bc464683c94eaa1e63e30f921fb79632dd228fc559",
                                     neg="af429c24344abe26797f1ba78c50e29cfe3bf3b1da5659cfd850cdda01a6a650",
                                     ab="02a76735864062363a80dee09cd04d6c8c8869dbcddbcf0f7155c072afbf72a3",
                                     abc="1e82365bebac58bff0cd88f503e0ba57b4f8764d53b11843f555ad0f60036392",
                                     switched="1e11133342e9b9143edc677dbbbe14d90bc43911457153a0c348f4f15d4f4488")),
}
BGV_STAGED_DISPATCHES = {"ntt": 31, "mulmod": 75, "addmod": 40, "submod": 16, "intt": 21, "bconv": 13}
BGV_FUSED_DISPATCHES = {"ntt": 18, "mulmod": 42, "addmod": 26, "submod": 10, "intt": 18, "fusedks": 3,
                        "fused_moddown": 3}
# The executor at matmul: executor_pairs(ctx) of a context over full_keyset(p, seed=0)
# (job 0 is REFERENCE["matmul"]'s (a, a)), then, in the reference package on the CPU,
#   E.parallel_shallow_mul(p, ks, pairs, E.affiliation_mesh(1))
# after one ctx.mul(*pairs[0]), which fills its table caches outside the jit trace
# (a first call inside the trace would cache tracers).  digest(out) of each job,
# equal to that job's lone ctx.mul in the reference.
EXECUTOR = dict(
    preset="matmul", jobs=8, affiliations=8,
    digests=(
        "916a0ff591277d18ac29e136e1a9bc6dda301eb8483c05e2011a172e04b70c0d",
        "9b1a9198971b1922435a3f2bb2edcab8bc1a04d7965143eb57ccf90c473b9758",
        "4001214a69a5c962883241bd7fc46b34b58ce1ac8c6065faa704863321b05d40",
        "89b3a73323ab551665ee69d03922ef5e05e146f12a6426b5b392551bf8c03787",
        "5cb6a1206c54a5c00ced2b0a00768d6276c08e70eff075e3474227e4446c090b",
        "9becf58f8ac6ce2bf56104e5b46d2389f17deb9ef4bb2addf666dee654eff0b8",
        "ce80ae4189ec0bace51b7e80186e7a5d4d7cc544466046bef080d64f5433f55c",
        "fefee7bf62e223d47223a2a00b65047bde09869e563bd620c39a0c0c4a46d22f",
    ),
)
# Phase 3h, the traced multiply: ctx.with_policy(ctx.policy.traced(Tracer())).mul(a, a)
# at lstm under backend="fused" in the reference package on the CPU (the keys and
# a of REFERENCE["lstm"]); names_sha256 is the SHA-256 of its slice names joined
# by "\n", one slice per kernel dispatch, in dispatch order.
TRACED_MUL = dict(preset="lstm", backend="fused", slices=19,
                  names_sha256="f00c2a8610c354dc8b5057c5616e48ab190c4ff9b4fe4fae11cba1a60f3f2fee",
                  names=("mulmod", "mulmod", "mulmod", "mulmod", "addmod", "intt", "fusedks", "intt",
                         "fused_moddown", "addmod", "addmod") + RESCALE_OPS * 2)


def traced_mul_port_names() -> list:
    """``TRACED_MUL``'s slice names as the port's: the closing rescale's
    reference dispatches (``RESCALE_OPS`` of each component) as one ``rescale``."""
    names = list(TRACED_MUL["names"])
    assert len(names) == TRACED_MUL["slices"] and names_sha256(names) == TRACED_MUL["names_sha256"]
    tail = 2 * len(RESCALE_OPS)
    return names[:-tail] + ["rescale"]


# Phase 3h, the scheduling layer: SHA-256 of the obs smoke scenario's Chrome
# export (dumps_chrome_trace of obs_smoke_fleet), of json.dumps(summary,
# sort_keys=True) of each of SERVING_SCENARIOS, and of plan_and_price_blob
# over every preset, from the reference package on the CPU (the same builders,
# given the reference's modules).
SCHEDULING = dict(
    obs_trace="69339530608fc73f4c6a2a1cfee863127cb73a710a87caaf6cec3cedea7d5ee1",
    summaries=dict(single="506a5c2d919a0aa70bceb7a0953ac45d0d4b083cc82ac352cc2c4794621a40ca",
                   hetero="5465ebd0cf15202eb9d56672b1cd53051f6915e20d17e447949100ee468132ff",
                   overload="a64b333a95b8cb7df084724de647402d9e90bc079987e17601e565fb8da47ee2",
                   diurnal="613ba20e8dc4b294f398dfb820f55625c1381b4bff0d8bfd86bbec4f90b42e32",
                   mixed_schemes="966c990ea3c35608cae00ab444edee5743d696473e60ddbc402207bd8bdd078e"),
    plan_and_price="e5308def188f9efa297a7a7303dfd8125bd3096986625dd188752251200a47e6",
)
# bsgs_mac's cases: (preset, level, n1, diagonals) of one of the lstm step's
# eight plans (128 diagonals at n1 = 8, 14 limbs), then LoLa-MNIST's three at
# N = 2^13: the convolution's 25 taps (5 × 5 at stride 2 over stride planes of
# 14 × 14 pixels, in its packing's order) at the top level, the dense layers below.
LOLA_CONV_DIAGONALS = tuple(((dy % 2) * 2 + dx % 2) * 196 + 14 * (dy // 2) + dx // 2
                            for dy in range(5) for dx in range(5))
BSGS_MAC_CASES = (("lstm", 13, 8, tuple(range(128))), ("lola_mnist_plain", 6, 14, LOLA_CONV_DIAGONALS),
                  ("lola_mnist_plain", 4, 16, tuple(range(128))), ("lola_mnist_plain", 2, 4, tuple(range(16))))
# Which kernel each dispatch op launches.
KERNEL_OF = {"mulmod": "modops", "addmod": "modops", "submod": "modops", "ntt": "ntt", "intt": "ntt",
             "fusedks": "fused_ks", "fused_moddown": "fused_moddown", "bconv": "bconv",
             "hoistmodup": "hoist_modup", "hoistmac": "hoist_mac", "bsgsmac": "bsgs_mac", "rescale": "fused_rescale"}

# H100 SXM peaks.  Memory: 3.35 TB/s (NVIDIA data sheet).  Integer
# instructions: an SM issues at most 4 warp instructions a clock, 128 thread
# operations, so 132 SMs × 128 × 1.98 GHz ≈ 33.5e12 a second; the kernels'
# counts (MONTMUL, MULMOD, ADDMOD) are such instructions.  (The data sheet's
# 67 TFLOP/s is the float32 FMA rate, an FMA counted as two operations; the
# 32-bit integer multiply-add alone issues at 64 a clock per SM on compute
# capability 9.0, the CUDA programming guide's throughput table.)  Int8
# tensor-core products: 1,979 TOP/s dense (data sheet), a multiply-add
# counted as two operations.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 33.5e12
PEAK_INT8_OPS_PER_S = 1979e12
MONTMUL, MULMOD, ADDMOD = 8, 16, 3  # integer operations per modular op
WORD = 4
SLEEP_CYCLES = 20_000_000  # ~10 ms at the H100's 1.98 GHz boost clock


def bound(nbytes: float, ops: float, int8_ops: float = 0.0) -> tuple[float, str]:
    """The least time for the work: bytes at the memory rate, or integer
    operations at the issue ceiling plus int8 tensor-core operations at their
    peak, whichever is larger (ms, and which one)."""
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S + int8_ops / PEAK_INT8_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def ntt_ops_per_limb(n: int) -> int:
    return (n // 2) * (n.bit_length() - 1) * (MONTMUL + 2 * ADDMOD) + n * MONTMUL


def modup_ops(n: int, k: int, m: int, rows: int) -> int:
    """Operations of a ModUp of k source limbs to m target limbs, ``rows`` NTT
    rows in all: the prescale once per source limb, one montmul and one add per
    (source, target) term, and each row's twist and forward NTT."""
    return n * k * MONTMUL + m * n * k * (MONTMUL + ADDMOD) + rows * ntt_ops_per_limb(n)


def time_ms(fn, iters: int = 20, warmup: int = 3, hide_host: bool = False, sleep_cycles: int = SLEEP_CYCLES) -> float:
    """Mean milliseconds per call between CUDA events around ``iters`` calls.

    With ``hide_host`` the stream first spins ``sleep_cycles`` (~10 ms by
    default, ``torch.cuda._sleep``), so the host has queued every launch
    before the start event runs and the events time the device alone.
    Without it, a call's host overhead counts.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hide_host:
        torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mlp_model(p) -> dict:
    """The 2-layer MLP of examples/fhe_inference.py, with its weights packed as
    slots×slots block matrices, its input packed in the first 16 slots, and
    the cleartext output."""
    rng = np.random.default_rng(1)
    w1 = rng.normal(size=(16, 16)) * 0.4
    w2 = rng.normal(size=(16, 4)) * 0.4
    x = rng.normal(size=16) * 0.5

    def block(w):
        m = np.zeros((p.slots, p.slots))
        m[: w.shape[1], : w.shape[0]] = w.T
        return m

    x_slots = np.zeros(p.slots)
    x_slots[:16] = x
    return dict(m1=block(w1), m2=block(w2), x_slots=x_slots, want=((x @ w1) ** 2) @ w2)


def packed_bootstrap_context(p, keys):
    """The ``BootstrapContext`` of ``PACKED``, built field by field: no BSGS
    plans (CoeffToSlot's dense slots × slots matrices would take 16 GiB each at
    N = 2^16, and ModRaise and EvalMod use none), EvalMod at K = 2 with
    ``build_context``'s target function and default degree."""
    from repro_torch.fhe import bootstrap as B
    from repro_torch.fhe import polyeval

    k, degree = PACKED["K"], PACKED["degree"]
    return B.BootstrapContext(params=p, keys=keys, cts_plans=(), stc_plans=(),
                              sine_coeffs=polyeval.chebyshev_fit(B.eval_mod_target(p, k), degree), K=k,
                              eval_mod_degree=degree)


def oracle_mul(a: np.ndarray, b: np.ndarray, n: int, t: int) -> np.ndarray:
    """Negacyclic convolution mod t: the product that X^n + 1 induces on
    coefficient-packed BGV messages (``tests/test_bgv.py``'s oracle)."""
    conv = np.convolve(a.astype(np.int64), b.astype(np.int64))
    res = np.zeros(n, np.int64)
    res[: min(n, conv.shape[0])] += conv[:n]
    wrap = conv[n:]
    res[: wrap.shape[0]] -= wrap
    return res % t


def bgv_messages(p) -> tuple:
    """Three messages of N integers mod t, from one seeded generator."""
    rng = np.random.default_rng(0)
    return tuple(rng.integers(0, p.plain_modulus, size=p.n) for _ in range(3))


def bgv_path(ctx, msgs) -> tuple[dict, dict]:
    """The BGV path of ``BGV`` through a context's public API: encode and
    encrypt a, b, c; a + b, a − b, −a; a·b and (a·b)·c, each mod-switched
    after the product; (a·b·c)·a without the switch, then ``ctx.mod_switch``;
    decrypt and decode each.  Returns ({output: ciphertext}, {output: integers})."""
    a, b, c = (ctx.encrypt(ctx.encode(z), seed=s) for z, s in zip(msgs, (1, 2, 3)))
    outs = dict(add=ctx.add(a, b), sub=ctx.sub(a, b), neg=ctx.negate(a))
    outs["ab"] = ctx.mul(a, b)
    outs["abc"] = ctx.mul(outs["ab"], c)
    outs["switched"] = ctx.mod_switch(ctx.mul(outs["abc"], a, rescale_after=False))
    return outs, {k: ctx.decrypt_decode(v) for k, v in outs.items()}


def bgv_oracle(msgs, n: int, t: int) -> dict:
    """What ``bgv_path`` must decode to, from the plain integers."""
    za, zb, zc = (np.asarray(z, np.int64) for z in msgs)
    ab = oracle_mul(za, zb, n, t)
    abc = oracle_mul(ab, zc, n, t)
    return dict(add=(za + zb) % t, sub=(za - zb) % t, neg=(-za) % t, ab=ab, abc=abc, switched=oracle_mul(abc, za, n, t))


def executor_pairs(ctx) -> list:
    """``EXECUTOR``'s jobs: job 0 is ``REFERENCE["matmul"]``'s (a, a); job j ≥ 1
    multiplies encryptions of default_rng(j) and default_rng(100 + j) normals."""
    slots = ctx.params.slots
    a = ctx.encrypt(ctx.encode(np.random.default_rng(0).normal(size=slots) * 0.4))
    pairs = [(a, a)]
    for j in range(1, EXECUTOR["jobs"]):
        x = np.random.default_rng(j).normal(size=slots) * 0.4
        y = np.random.default_rng(100 + j).normal(size=slots) * 0.4
        pairs.append((ctx.encrypt(ctx.encode(x), seed=j), ctx.encrypt(ctx.encode(y), seed=100 + j)))
    return pairs


def digest(*cts) -> str:
    h = hashlib.sha256()
    for c in cts:
        h.update(c.c0.cpu().numpy().astype("<u4").tobytes() + c.c1.cpu().numpy().astype("<u4").tobytes())
    return h.hexdigest()


def timed(steps: dict, label: str, fn):
    """Run ``fn`` between two ``torch.cuda.synchronize()``s; record its host milliseconds under ``label``."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    steps[label] = (time.perf_counter() - t) * 1e3
    return out


def device_busy(fn) -> tuple[float, float, dict]:
    """(ms the device spent in kernels and copies, wall ms, {device event name: ms})
    over one call of ``fn`` after a first call, from ``torch.profiler`` (the wall
    time includes its overhead).  The busy time sums the self device time of
    every row of ``key_averages()``, as in earlier runs; the dict holds only the
    rows of device events (kernels, copies), named without their arguments."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    rows = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in rows)
    by_name = {e.key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]:
               e.self_device_time_total / 1e3 for e in rows if e.device_type == DeviceType.CUDA}
    return busy_us / 1e3, wall, by_name


def kernel_streams(fn, trace_path: pathlib.Path) -> dict:
    """{CUDA stream: kernels} over one call of ``fn`` after a first call, from
    the ``args.stream`` of the kernel events of ``torch.profiler``'s Chrome
    trace, which is written to ``trace_path``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    streams = {}
    for e in json.loads(trace_path.read_text())["traceEvents"]:
        if e.get("cat") == "kernel" and "stream" in e.get("args", {}):
            streams[e["args"]["stream"]] = streams.get(e["args"]["stream"], 0) + 1
    return streams


def sig(instrs) -> dict:
    """Multiset of (op, n, limbs) of an instruction stream (meta ignored), as the
    reference's planner-parity tests compare them."""
    out = {}
    for i in instrs:
        out[(i.op, i.n, i.limbs)] = out.get((i.op, i.n, i.limbs), 0) + 1
    return out


def planner_cases(PL, lstm, mlp, psi, exact, levels) -> list:
    """Phase 3h's ops against the planner, as (label, thunk, planner stream).

    ``lstm`` = (ctx, ct) with Galois keys for 1..4, ``mlp`` = (ctx, ct, plan),
    ``psi`` = (BGV ctx, a, b), ``exact`` = (BGV ctx, a); ``levels`` are the
    levels of the CKKS multiply.  Each op runs under backend "fused", "staged"
    and "auto"; "auto" must give the fused stream on a CUDA device and the
    staged one on the CPU."""
    cases = []
    for backend in ("fused", "staged", "auto"):
        fused = backend == "fused" or (backend == "auto" and lstm[0].device.type == "cuda")
        ctx, ct = lstm
        c = ctx.with_policy(backend=backend)
        pp = PL.PlanParams.of(ctx.params)
        for level in levels:
            x = c.level_drop(ct, level)
            cases.append((f"{backend} ctx.mul level {level}", lambda c=c, x=x: c.mul(x, x),
                          PL.hmul(pp, level, fused=fused)))
        cases.append((f"{backend} ctx.rotate 1", lambda c=c, ct=ct: c.rotate(ct, 1),
                      PL.rotate(pp, ct.level, fused=fused)))
        cases.append((f"{backend} hoisted group of 4", lambda c=c, ct=ct: c.rotate_hoisted_group(ct, (1, 2, 3, 4)),
                      PL.hoisted_rotations(pp, ct.level, 4, fused=fused)))
        ctx, ct, plan = mlp
        pp = PL.PlanParams.of(ctx.params)
        for hoisting in ("always", "never"):
            c = ctx.with_policy(backend=backend, hoisting=hoisting)
            # a copy holding no encoded diagonal: the exec stream encodes each one
            cases.append((f"{backend} apply_bsgs hoisting={hoisting}",
                          lambda c=c, ct=ct, plan=dataclasses.replace(plan): c.apply_bsgs(ct, plan),
                          PL.bsgs_matvec(pp, ct.level, len(plan.diags), plan.n1, mode="exec",
                                         hoist=hoisting == "always", fused=fused)))
        ctx, a, b = psi
        c = ctx.with_policy(backend=backend)
        cases.append((f"{backend} BGV ctx.mul", lambda c=c, a=a, b=b: c.mul(a, b),
                      PL.bgv_hmul(PL.PlanParams.of(ctx.params), a.level, mod_switch_after=True, fused=fused)))
        ctx, a = exact
        c = ctx.with_policy(backend=backend)
        cases.append((f"{backend} BGV ctx.mod_switch", lambda c=c, a=a: c.mod_switch(a),
                      PL.bgv_mod_switch(PL.PlanParams.of(ctx.params), a.level)))
    return cases


def traced_mul(ctx, x, Tracer) -> tuple:
    """ctx.mul(x, x) under ``ctx.policy.traced(tracer)``: (output, tracer, slice names)."""
    tracer = Tracer()
    out = ctx.with_policy(ctx.policy.traced(tracer)).mul(x, x)
    return out, tracer, [e["name"] for e in tracer.events]


def names_sha256(names) -> str:
    return hashlib.sha256("\n".join(names).encode()).hexdigest()


# The scheduling layer's scenarios.  ``pkg`` is a namespace of one package's
# modules (serve, H = core.hardware, J = core.jobs, PL = core.planner,
# S = core.simulator, P = fhe.params), so that the same builders run the port
# here and the reference where the digests of SCHEDULING are computed.

OBS_SMOKE_SEED = 20260809


def obs_smoke_jobs(pkg, seed: int = OBS_SMOKE_SEED, n: int = 48, deep_frac: float = 0.3) -> list:
    """tools/obs_smoke.py's 48 jobs: shallow presets and lstm, three tenants."""
    import random

    rng = random.Random(seed)
    jobs, t = [], 0
    for i in range(n):
        t += rng.randint(1_000, 30_000)
        wl = "lstm" if rng.random() < deep_frac else rng.choice(("matmul", "lola_mnist_plain", "dblookup"))
        jobs.append(pkg.J.make_job(wl, priority=rng.randint(0, 2), arrival_cycle=t, job_id=i, tenant_id=i % 3))
    return jobs


def obs_smoke_fleet(pkg, tracer=None):
    """tools/obs_smoke.py's fleet: 4 FLASH-FHE chips under jsq with gangs of 2, a
    crash of chip 1, a straggler window on chip 0, two flaky failures on chip 2,
    and the default retry policy."""
    FP = pkg.serve.faults.FaultPlan
    faults = (FP.single_crash(chip=1, at=2.0e5, down=1.0e6)
              .merged(FP.straggler(chip=0, at=1.0e5, span=8.0e5, factor=2.0))
              .merged(FP.flaky(chip=2, times=(3.0e5, 6.0e5))))
    return pkg.serve.serve_cluster(obs_smoke_jobs(pkg), pkg.H.FLASH_FHE, n_chips=4, router="jsq", seed=3,
                                   gang_max_chips=2, faults=faults, retry=pkg.serve.faults.RetryPolicy(),
                                   tracer=tracer, validate=True)


MIXED_SCHEMES = {"lola_mnist_plain": 0.25, "matmul": 0.15, "psi": 0.25, "exact_count": 0.2, "lstm": 0.15}


def _single(pkg):
    """One FLASH-FHE chip, 120 Poisson arrivals of the mixed CKKS mix."""
    cfg = pkg.serve.traffic.PoissonConfig(rate_per_mcycle=20.0, n_jobs=120, seed=3)
    res = pkg.serve.serve(pkg.serve.traffic.poisson_jobs(cfg), pkg.H.FLASH_FHE)
    return pkg.serve.summarize(res), res


def _hetero(pkg):
    """The README's heterogeneous fleet under the hetero router, gangs of 2."""
    cfg = pkg.serve.traffic.PoissonConfig(rate_per_mcycle=20.0, n_jobs=120, seed=3)
    H = pkg.H
    res = pkg.serve.serve_cluster(pkg.serve.traffic.poisson_jobs(cfg),
                                  chips=[H.FLASH_FHE, H.FLASH_FHE, H.CRATERLAKE, H.F1PLUS],
                                  router="hetero", gang_max_chips=2)
    return pkg.serve.metrics.summarize_cluster(res), res


def _overload(pkg):
    """3× overload of two chips, three tenants, admission at the door and a queue timeout."""
    cfg = pkg.serve.traffic.PoissonConfig(rate_per_mcycle=60.0, n_jobs=150, seed=5, priority_mix={0: 0.7, 2: 0.3})
    jobs = [pkg.J.make_job(j.workload, priority=j.priority, arrival_cycle=j.arrival_cycle, job_id=j.job_id,
                           tenant_id=j.job_id % 3) for j in pkg.serve.traffic.poisson_jobs(cfg)]
    adm = pkg.serve.AdmissionConfig(max_wait_cycles=4e5, tenant_rate_per_mcycle=15.0, tenant_burst=4.0,
                                    shed_after_cycles=1.5e6)
    res = pkg.serve.serve_cluster(jobs, pkg.H.FLASH_FHE, n_chips=2, router="po2", seed=7, admission=adm)
    return pkg.serve.metrics.summarize_cluster(res), res


def _diurnal(pkg):
    """Two simulated days of diurnal traffic on two chips."""
    cfg = pkg.serve.DiurnalConfig(peak_rate_per_mcycle=10.0, period_mcycles=5.0, n_periods=2.0, trough_frac=0.5,
                                  seed=9)
    res = pkg.serve.serve_cluster(pkg.serve.diurnal_jobs(cfg), pkg.H.FLASH_FHE, n_chips=2, router="jsq")
    return pkg.serve.metrics.summarize_cluster(res), res


def _mixed_schemes(pkg):
    """CKKS and BGV jobs in one stream on two chips under the affinity router."""
    cfg = pkg.serve.traffic.PoissonConfig(rate_per_mcycle=15.0, n_jobs=100, mix=MIXED_SCHEMES, seed=11)
    res = pkg.serve.serve_cluster(pkg.serve.traffic.poisson_jobs(cfg), pkg.H.FLASH_FHE, n_chips=2,
                                  router="affinity")
    return pkg.serve.metrics.summarize_cluster(res), res


SERVING_SCENARIOS = {"single": _single, "hetero": _hetero, "overload": _overload, "diurnal": _diurnal,
                     "mixed_schemes": _mixed_schemes}


def summary_sha256(summary: dict) -> str:
    return hashlib.sha256(json.dumps(summary, sort_keys=True).encode()).hexdigest()


def plan_and_price(pkg, name: str):
    """``name``'s hw-mode stream under the default policy, priced on one
    FLASH-FHE chip at the lanes its kind is granted (a deep job: every
    bootstrappable cluster; a shallow one: one affiliation)."""
    stream = pkg.PL.workload_stream(name, pkg.P.workload_params(name), mode="hw")
    lanes = pkg.S.lanes_deep if pkg.P.workload_kind(name) == "deep" else pkg.S.lanes_shallow
    return pkg.S.simulate_stream(stream, pkg.H.FLASH_FHE, lanes(pkg.H.FLASH_FHE))


def plan_and_price_blob(sims: dict) -> str:
    """{preset: SimResult} as sorted JSON of every field."""
    return json.dumps({name: [s.cycles, s.hbm_bytes, s.unit_cycles, s.cache_hit_ratio, s.instr_count, s.time_s]
                       for name, s in sims.items()}, sort_keys=True)


def phase_3h(kernels, paths, launches_of, lstm, mlp, psi, exact, mul, smi) -> int:
    """Phase 3h: the planner against the traces of ops whose kernels run on the
    card, a traced multiply, and the scheduling layer on the card's host.

    ``kernels`` and ``paths`` are ``main``'s launch counters and per-path
    launch table, ``launches_of`` maps dispatch counts to kernel launches;
    ``lstm``, ``mlp``, ``psi`` and ``exact`` are ``planner_cases``'s contexts,
    ``mul`` = (ctx, ct) at ``TRACED_MUL``'s preset, ``smi`` the card's name and
    power limit.  Returns 0, or 1 after printing what failed."""
    import types

    from repro_torch import obs
    from repro_torch import serve as serve_pkg
    from repro_torch.core import hardware, jobs, planner, simulator
    from repro_torch.fhe import params as P
    from repro_torch.fhe import trace
    from repro_torch.kernels import dispatch

    def reset_launches():
        for v in kernels.values():
            v["k"].launches = 0

    def read_launches() -> dict:
        return {k: v["k"].launches for k, v in kernels.items()}

    print("planner against the instruction traces of the ops on the card (fused, staged, auto):")
    cases = planner_cases(planner, lstm, mlp, psi, exact, levels=(lstm[0].params.L, 9))
    problems = []
    for label, fn, want in cases:
        reset_launches()
        with dispatch.count_dispatches() as counts, trace.capture_trace() as got:
            fn()
        torch.cuda.synchronize()
        paths[f"3h {label}"] = launched = read_launches()
        match = sig(got) == sig(want)
        print(f"  {label}: {len(got)} records, planner {len(want)}, match={match}, "
              f"{dispatch.total(counts)} dispatches, launches {sum(launched.values())}")
        if not match:
            problems.append(f"{label}: trace {sig(got)} != planner {sig(want)}")
        if launched != launches_of(counts) or dispatch.total(counts) < 1:
            problems.append(f"{label}: launches {launched} != dispatches {launches_of(counts)}")
    h_launched = {k: sum(paths[f"3h {label}"][k] for label, _, _ in cases) for k in kernels}
    print(f"  kernel launches over the {len(cases)} ops: {h_launched}")
    if min(h_launched[k] for k in ("modops", "ntt", "fused_ks", "fused_moddown", "bconv", "hoist_modup",
                                    "hoist_mac", "bsgs_mac", "fused_rescale")) < 1:
        problems.append(f"a kernel of phase 3h was not launched: {h_launched}")
    if problems:
        print("FAILED planner parity: " + "; ".join(problems), file=sys.stderr)
        return 1

    print(f"traced ctx.mul at {TRACED_MUL['preset']} ({TRACED_MUL['backend']}):")
    tctx, tx = mul
    tctx = tctx.with_policy(backend=TRACED_MUL["backend"])
    reset_launches()
    with dispatch.count_dispatches() as counts:
        out, tracer, names = traced_mul(tctx, tx, obs.Tracer)
    torch.cuda.synchronize()
    paths["3h traced mul"] = launched = read_launches()
    trace_problems = obs.validate_chrome_trace(obs.to_chrome_trace(tracer))
    want_names = traced_mul_port_names()
    print(f"  {len(names)} slices, {dispatch.total(counts)} dispatches, {sum(launched.values())} launches, "
          f"names sha256 {names_sha256(names)[:16]} (the reference's {TRACED_MUL['names_sha256'][:16]}, "
          f"its rescale as one dispatch: {names_sha256(want_names)[:16]}), "
          f"export problems {trace_problems}, digest {digest(out)[:16]}")
    problems = []
    if not (len(names) == len(want_names) == dispatch.total(counts) == sum(launched.values())
            == sum(fused_rescale_counts(FUSED_MUL_DISPATCHES, 1).values())):
        problems.append(f"{len(names)} slices, {dispatch.total(counts)} dispatches, {launched} launches")
    if names != want_names or trace_problems:
        problems.append(f"names {names} != {want_names}, export problems {trace_problems}")
    if launched != launches_of(counts) or digest(out) != REFERENCE[TRACED_MUL["preset"]]["digest"]:
        problems.append(f"launches {launched}, digest {digest(out)}")
    if problems:
        print("FAILED traced multiply: " + "; ".join(problems), file=sys.stderr)
        return 1

    print("scheduling layer on the card's host (planner, simulator, serving, tracing):")
    pkg = types.SimpleNamespace(serve=serve_pkg, H=hardware, J=jobs, PL=planner, S=simulator, P=P)
    host_ms, sims = {}, {}
    for name in planner.available_workloads():
        t = time.perf_counter()
        sims[name] = plan_and_price(pkg, name)
        host_ms[f"plan+price {name}"] = (time.perf_counter() - t) * 1e3
    problems = []
    sha = hashlib.sha256(plan_and_price_blob(sims).encode()).hexdigest()
    if sha != SCHEDULING["plan_and_price"]:
        problems.append(f"plan_and_price sha256 {sha} != reference {SCHEDULING['plan_and_price']}")
    t = time.perf_counter()
    tracer = obs.Tracer()
    fleet = obs_smoke_fleet(pkg, tracer)
    host_ms["obs smoke fleet (traced)"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    bare = obs_smoke_fleet(pkg)
    host_ms["obs smoke fleet (untraced)"] = (time.perf_counter() - t) * 1e3
    blob = obs.dumps_chrome_trace(tracer)
    trace_out = ROOT / "build" / "obs_trace.json"
    trace_out.parent.mkdir(parents=True, exist_ok=True)
    trace_out.write_text(blob)
    sha = hashlib.sha256(blob.encode()).hexdigest()
    if sha != SCHEDULING["obs_trace"]:
        problems.append(f"obs trace sha256 {sha} != reference {SCHEDULING['obs_trace']}")
    if obs.validate_chrome_trace(obs.to_chrome_trace(tracer)):
        problems.append("the obs trace fails validation")
    done = lambda res: sorted((je.job.job_id, je.completion) for je in res.jobs if je.completion is not None)
    if bare.makespan != fleet.makespan or done(bare) != done(fleet):
        problems.append("the untraced fleet run gave another timeline")
    print(f"  obs smoke: {len(tracer.events)} trace events, {len(blob)} bytes, sha256 {sha[:16]}, "
          f"written to {trace_out.relative_to(ROOT)}")
    for name, scenario in SERVING_SCENARIOS.items():
        t = time.perf_counter()
        summary, res = scenario(pkg)
        host_ms[f"serve {name}"] = (time.perf_counter() - t) * 1e3
        sha = summary_sha256(summary)
        print(f"  {name}: {len(res.jobs)} jobs, makespan {res.makespan:.0f} cycles, summary sha256 {sha[:16]}")
        if sha != SCHEDULING["summaries"][name]:
            problems.append(f"{name} summary sha256 {sha} != reference {SCHEDULING['summaries'][name]}")
    print(f"  host times on {smi} (ms): " + " ".join(f"{k}={v:.1f}" for k, v in host_ms.items()))
    print(f"  host time of plan+price over {len(sims)} presets on {smi}: "
          f"{sum(v for k, v in host_ms.items() if k.startswith('plan+price')):.1f} ms")
    if problems:
        print("FAILED scheduling layer: " + "; ".join(problems), file=sys.stderr)
        return 1
    return 0


# -- phase 3i: the LLM serving path --------------------------------------------
# smollm-135m at full width at the launcher's defaults (batch 4, prompt 16, 32
# tokens, max_seq 128).  Its weights come from a numpy seed in the reference's
# tree layout and scales (repro.models.lm.init_params, _dense_init); the
# prompts from the data pipeline; FORCED more tokens from it drive the
# teacher-forced decode steps.  tests/test_torch_llm_serving.py holds the
# port's CPU path against the reference at these weights and inputs, so the
# chain card → CPU port → reference is explicit.
LLM = dict(arch="smollm-135m", seed=20261017, batch=4, prompt_len=16, tokens=32, max_seq=128, forced=8)
# |card − CPU port| ≤ atol + rtol·|CPU| and a correlation floor: the full
# width's logits; the SMOKE archs' logits, bfloat16 caches and float32 SSM
# state (the tests hold the CPU port to the reference with the same bounds).
# All lie far inside the reference's own prefill/decode consistency bound
# (atol 0.55, rtol 0.15, corr > 0.98, tests/test_arch_smoke.py).
LLM_TOL = dict(atol=0.1, rtol=0.02, corr=0.9995)
SMOKE_TOL = dict(logits=dict(atol=0.08, rtol=0.02, corr=0.9995), cache=dict(atol=0.05, rtol=0.01, corr=0.9995),
                 ssm=dict(atol=0.05, rtol=0.02, corr=0.9995))
# A first-layer router gap (k-th minus (k+1)-th probability) below this is a
# near-tie that two bfloat16 implementations may break either way: the MoE
# archs' caches after that layer are compared without those positions.
MOE_MARGIN = 2e-3


def llm_reference_tree(cfg, seed: int) -> dict:
    """A dense attention model's parameters in the reference's tree layout
    (``blocks`` stacked on a leading layer axis) and init scales, as float32
    numpy arrays drawn from ``seed``."""
    if cfg.mixer != "attn" or cfg.is_moe:
        raise ValueError(f"{cfg.arch_id}: llm_reference_tree builds dense attention models only")
    rng = np.random.default_rng(seed)
    d, f, hd, nl = cfg.d_model, cfg.d_ff, cfg.hd, cfg.n_layers

    def dense(shape, scale=None):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            scale if scale is not None else 1.0 / np.sqrt(shape[0]))

    def stacked(shape):
        return np.stack([dense(shape) for _ in range(nl)])

    n_qkv = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    attn = {"ln": np.ones((nl, d), np.float32), "wqkv": stacked((d, n_qkv)), "wo": stacked((cfg.n_heads * hd, d))}
    if cfg.qkv_bias:
        attn["bqkv"] = np.zeros((nl, n_qkv), np.float32)
    ffn = {"w1": stacked((d, f)), "w2": stacked((f, d))}
    if cfg.act == "swiglu":
        ffn["w3"] = stacked((d, f))
    tree = {"embed": dense((cfg.vocab, d), 0.02), "final_ln": np.ones((d,), np.float32),
            "blocks": {"attn": attn, "ffn_ln": np.ones((nl, d), np.float32), "ffn": ffn}}
    if not cfg.tie_embeddings:
        tree["head"] = dense((d, cfg.vocab))
    return tree


def llm_inputs(cfg) -> tuple[np.ndarray, np.ndarray]:
    """(prompts (batch, prompt_len), forced tokens (batch, FORCED)), int32."""
    from repro_torch.data import pipeline

    prompts = pipeline.synthetic_lm_batch(0, 0, LLM["batch"], LLM["prompt_len"] - 1, cfg.vocab)
    forced = pipeline.synthetic_lm_batch(0, 1, LLM["batch"], LLM["forced"] - 1, cfg.vocab)
    return prompts, forced


def teacher_forced(api, params, prompts, forced, max_seq: int, device) -> tuple[list, dict]:
    """Prefill ``prompts``, then one decode step per column of ``forced``:
    ([prefill logits, step logits...], the last cache)."""
    cache = api.init_cache(prompts.shape[0], max_seq, device=device)
    logits, cache = api.prefill(params, cache, tokens=torch.as_tensor(prompts, device=device))
    out = [logits]
    for i in range(forced.shape[1]):
        logits, cache = api.decode_step(params, torch.as_tensor(forced[:, i], device=device), cache)
        out.append(logits)
    return out, cache


def smoke_inputs(cfg, b: int = 2, s: int = 48, seed: int = 7) -> dict:
    """Numpy prefill inputs of ``s`` positions (patches or frames included)
    and a decode token, for a SMOKE arch."""
    rng = np.random.default_rng(seed)
    n, out = s, {}
    if cfg.family == "vlm":
        n -= cfg.n_patches
        out["patches"] = rng.standard_normal((b, cfg.n_patches, cfg.d_model), dtype=np.float32)
    elif cfg.family == "audio":
        n -= cfg.enc_seq
        out["frames"] = rng.standard_normal((b, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    out["tokens"] = rng.integers(0, cfg.vocab, (b, n), dtype=np.int32)
    out["token"] = rng.integers(0, cfg.vocab, b, dtype=np.int32)
    return out


def near_ties(cfg, params, tokens) -> np.ndarray:
    """(B, S) mask of the positions whose first-layer router gap is below
    ``MOE_MARGIN`` (all False for a dense model), from the port's ``params``."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    b, s = tokens.shape
    if not cfg.is_moe:
        return np.zeros((b, s), bool)
    p0 = params["blocks"][0]
    tok = torch.as_tensor(tokens, device=params.device)
    with torch.no_grad():
        x = lm.embed(cfg, params, tok)
        h = x + lm.attn_forward(cfg, p0["attn"], x, torch.arange(s, device=tok.device).expand(b, s), window=0)
        hn = L.rmsnorm(h, p0["ffn_ln"].to(h.dtype)).float()
        probs = torch.sort(torch.softmax(hn @ p0["moe"]["router"], dim=-1), dim=-1, descending=True).values
    return (probs[..., cfg.top_k - 1] - probs[..., cfg.top_k] < MOE_MARGIN).cpu().numpy()


def compare(ref, got, atol: float, rtol: float, corr: float, where=None) -> tuple[float, float, bool]:
    """(max |got − ref|, correlation, within atol + rtol·|ref| and above ``corr``),
    on the entries ``where`` selects if given."""
    r = ref.detach().float().cpu().numpy()
    g = got.detach().float().cpu().numpy()
    if where is not None:
        r, g = r[where], g[where]
    d = np.abs(g - r)
    c = float(np.corrcoef(r.ravel(), g.ravel())[0, 1]) if r.size > 1 else 1.0
    return float(d.max(initial=0.0)), c, bool(np.all(d <= atol + rtol * np.abs(r))) and c > corr


def compare_caches(cfg, ref: dict, got: dict, ties: np.ndarray) -> dict:
    """{cache key: compare(...)} under ``SMOKE_TOL``; the layers after a MoE
    layer leave out its near-tie positions (the axis after batch)."""
    out = {}
    for k in ref:
        if k == "t":
            out[k] = (float(abs(int(ref[k]) - int(got[k]))), 1.0, int(ref[k]) == int(got[k]))
            continue
        where = None
        if k in ("k", "v") and ties.any():
            where = np.ones(tuple(ref[k].shape), bool)
            bi, pi = np.nonzero(ties)
            where[1:, bi, pi] = False
        out[k] = compare(ref[k], got[k], where=where, **SMOKE_TOL["ssm" if k == "ssm" else "cache"])
    return out


def phase_3i(paths, reset_launches, read_launches, smi) -> int:
    """Phase 3i: the LLM serving path on the card — smollm-135m at full width
    against the port's CPU path, 32 greedy tokens twice, the nine other archs
    at SMOKE width, and ``launch.serve`` in-process.  ``paths``,
    ``reset_launches`` and ``read_launches`` are ``main``'s launch table and
    counters (this path launches none of the FHE kernels), ``smi`` the card's
    name and power limit.  Returns 0, or 1 after printing what failed."""
    import copy

    from repro_torch import configs
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import lm, registry
    from repro_torch.models.convert import params_from_reference
    from repro_torch.serving.engine import Engine, SamplerConfig

    problems = []
    cfg = configs.get_config(LLM["arch"])
    api = registry.build(cfg)
    print(f"{cfg.arch_id} at full width: {cfg.n_layers} layers, d = {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} KV, vocab {cfg.vocab}, {cfg.param_count() / 1e6:.1f} M parameters; batch "
          f"{LLM['batch']}, prompt {LLM['prompt_len']}, {LLM['forced']} teacher-forced steps, max_seq {LLM['max_seq']}")
    t = time.perf_counter()
    tree = llm_reference_tree(cfg, LLM["seed"])
    cpu_params = params_from_reference(cfg, tree, device="cpu")
    params = params_from_reference(cfg, tree, device=DEVICE)
    print(f"  weights from numpy seed {LLM['seed']} through params_from_reference: {time.perf_counter() - t:.1f} s")
    prompts, forced = llm_inputs(cfg)

    reset_launches()
    on_card, cache = teacher_forced(api, params, prompts, forced, LLM["max_seq"], DEVICE)
    torch.cuda.synchronize()
    paths["3i smollm teacher-forced"] = launched = read_launches()
    if any(launched.values()):
        problems.append(f"the LLM path launched FHE kernels: {launched}")
    off_device = [k for k, v in cache.items() if v.device.type != "cuda"]
    if off_device:
        problems.append(f"cache tensors off the card: {off_device}")
    t = time.perf_counter()
    on_cpu, _ = teacher_forced(api, cpu_params, prompts, forced, LLM["max_seq"], "cpu")
    print(f"  the same on the port's CPU path: {time.perf_counter() - t:.1f} s")
    rows = [compare(c, g, **LLM_TOL) for c, g in zip(on_cpu, on_card)]
    print(f"  card vs CPU logits (prefill, then each step): max |d| "
          + " ".join(f"{r[0]:.4f}" for r in rows) + f"; min corr {min(r[1] for r in rows):.6f}; "
          f"bound atol {LLM_TOL['atol']} rtol {LLM_TOL['rtol']} corr > {LLM_TOL['corr']}")
    if not all(r[2] for r in rows):
        problems.append(f"smollm-135m card vs CPU logits out of bounds: {rows}")
    # the same with cuBLAS free to reduce bfloat16 products in bfloat16 and to
    # take TF32 (PyTorch's defaults, which layers.reference_precision turns off)
    m = torch.backends.cuda.matmul
    saved = m.allow_bf16_reduced_precision_reduction, m.allow_tf32
    m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = True, True
    try:
        with torch.no_grad():
            c0 = lm.init_cache(cfg, LLM["batch"], LLM["max_seq"], DEVICE)
            loose, _ = lm.prefill(cfg, params, torch.as_tensor(prompts, device=DEVICE), c0)
    finally:
        m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = saved
    r = compare(on_cpu[0], loose, **LLM_TOL)
    print(f"  prefill with reduced-precision bf16 reductions and TF32 allowed: max |d| {r[0]:.4f}, corr {r[1]:.6f} "
          f"(reference precision: {rows[0][0]:.4f}, {rows[0][1]:.6f})")

    # timing: CUDA events, host included (the engine's own launches)
    def prefill_once():
        return api.prefill(params, api.init_cache(LLM["batch"], LLM["max_seq"], device=DEVICE),
                           tokens=torch.as_tensor(prompts, device=DEVICE))

    _, warm = prefill_once()
    tok = torch.as_tensor(forced[:, 0], device=DEVICE)
    prefill_ms = time_ms(prefill_once, iters=5, warmup=1)
    state = {"cache": warm}

    def decode_once():
        _, state["cache"] = api.decode_step(params, tok, state["cache"])

    decode_ms = time_ms(decode_once, iters=LLM["tokens"] - 1, warmup=1)
    eng = Engine(api, params, batch=LLM["batch"], max_seq=LLM["max_seq"], device=DEVICE)
    greedy = SamplerConfig(temperature=0.0)
    steps = {}
    first = timed(steps, "generate #1", lambda: eng.generate(prompts, LLM["tokens"], greedy))
    second = timed(steps, "generate #2", lambda: eng.generate(prompts, LLM["tokens"], greedy))
    if not np.array_equal(first, second) or first.shape != (LLM["batch"], LLM["tokens"]):
        problems.append(f"greedy generation differs between two runs: {first} vs {second}")
    busy, wall, by_name = device_busy(lambda: api.decode_step(params, tok, warm))
    gen_tps = LLM["batch"] * LLM["tokens"] / (steps["generate #2"] / 1e3)
    print(f"  on {smi}: prefill {prefill_ms:.3f} ms; decode {decode_ms:.3f} ms a step, "
          f"{LLM['batch'] * 1e3 / decode_ms:.1f} tokens/s; Engine.generate of {LLM['tokens']} tokens "
          f"{steps['generate #1']:.1f} ms then {steps['generate #2']:.1f} ms, {gen_tps:.1f} tokens/s; "
          f"one decode step under the profiler: device busy {busy:.3f} ms of {wall:.3f} ms wall, "
          f"busy share {busy / wall:.3f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"    device events {sum(by_name.values()):.3f} ms: " + ", ".join(f"{k[:48]} {v:.4f}" for k, v in top))
    print(f"  greedy tokens identical over two runs: {np.array_equal(first, second)}; row 0: {first[0, :12].tolist()}")

    print("the nine other archs at SMOKE width, card vs the port's CPU path (prefill, one decode step):")
    for arch in configs.ARCH_IDS:
        if arch == LLM["arch"]:
            continue
        scfg = configs.get_config(arch, smoke=True)
        sapi = registry.build(scfg)
        cpu_p = sapi.init_params(0, device="cpu")
        card_p = copy.deepcopy(cpu_p).to(DEVICE)
        inp = smoke_inputs(scfg)
        token = inp.pop("token")
        outs = {}
        for dev, p in (("cpu", cpu_p), (DEVICE, card_p)):
            c = sapi.init_cache(2, 64, device=dev)
            lg, c = sapi.prefill(p, c, **{k: torch.as_tensor(v, device=dev) for k, v in inp.items()})
            lg2, c2 = sapi.decode_step(p, torch.as_tensor(token, device=dev), c)
            outs[dev] = (lg, c, lg2, c2)
        ties = near_ties(scfg, cpu_p, np.concatenate([inp["tokens"], token[:, None]], 1))
        (lc, cc, lc2, cc2), (lg, cg, lg2, cg2) = outs["cpu"], outs[DEVICE]
        res = {"prefill logits": compare(lc, lg, **SMOKE_TOL["logits"]),
               "decode logits": compare(lc2, lg2, **SMOKE_TOL["logits"])}
        res.update({f"prefill {k}": v for k, v in compare_caches(scfg, cc, cg, ties[:, :-1]).items()})
        res.update({f"decode {k}": v for k, v in compare_caches(scfg, cc2, cg2, ties).items()})
        bad = {k: v for k, v in res.items() if not v[2]}
        print(f"  {arch}: " + ", ".join(f"{k} {v[0]:.4f}" for k, v in res.items())
              + (f"; near-tie positions left out {int(ties.sum())}" if scfg.is_moe else ""))
        if bad:
            problems.append(f"{arch} card vs CPU out of bounds: {bad}")
        if any(v.device.type != "cuda" for v in cg2.values()):
            problems.append(f"{arch}: cache tensors off the card")

    t = time.perf_counter()
    out = serve_launch.main(["--arch", LLM["arch"], "--full"])
    torch.cuda.synchronize()
    print(f"  repro_torch.launch.serve --arch {LLM['arch']} --full: {out.shape} tokens in "
          f"{(time.perf_counter() - t) * 1e3:.1f} ms (init included)")
    if out.shape != (LLM["batch"], LLM["tokens"]) or out.min() < 0 or out.max() >= cfg.vocab:
        problems.append(f"launch.serve gave {out.shape} tokens in [{out.min()}, {out.max()}]")
    if problems:
        print("FAILED LLM serving: " + "; ".join(problems), file=sys.stderr)
        return 1
    return 0


# Phase 3j: the training path (repro_torch.training, checkpoint, roofline,
# launch.train).  TRAIN_ACFG is the schedule of the SMOKE run below (warm-up
# max(5, 300 // 20) = 15 steps); the parity steps use it too, so their first
# step moves each weight by about lr_at(TRAIN_ACFG, 0) = 2e-4.
TRAIN = dict(arch="smollm-135m", parity=(2, 128), speed=(16, 512), warmup=3, iters=10, microbatch=4,
             e2e=dict(steps=300, batch=16, seq=64, lr=3e-3, ckpt_every=100, resume=200, tokens=48))
TRAIN_ACFG = dict(lr_peak=3e-3, warmup_steps=15, total_steps=300)
# |card − CPU port| of one train step.  The loss, the gradient norm and the
# gradients' per-leaf correlation; then the AdamW update d = w_new − w0,
# weight by weight (both sides start from the same w0, so the updates differ
# as the weights after the step do).  The first Adam step moves a weight by
# lr·(g/(|g| + eps) + wd·w) ≈ lr·(sign g + wd·w): where the two gradients
# share a sign the updates differ by float32 roundings (two of the weight,
# 2^-22·|w|) and by the eps term, far below update_lr·lr.  A weight whose
# gradient on the side held as the reference lies below `tie` of its leaf's
# largest is a near-tie that two implementations may break either way; it
# is held only to params_lr·lr, what a sign flip costs.  Leaving the weights
# unchanged, or the bias correction out, moves every update by ≥ 0.55·lr.
# The second step (AdamW alone, on identical inputs on both devices, where
# m̂/√v̂ is no longer sign g) holds every weight to update_lr·lr.
TRAIN_TOL = dict(loss=0.01, grad_norm_rel=1e-2, grad_corr=0.999, tie=0.05, update_lr=1e-3, params_lr=2.0,
                 params_rtol=2**-22, microbatch_loss=2e-2, resume=0.05)
# the ten archs at SMOKE width (the loss as the serving checks' SMOKE bound)
SMOKE_TRAIN_TOL = dict(loss=0.011, grad_norm_rel=2e-2)


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).cpu().numpy()
    return np.asarray(x, np.float64)


def update_gap(w0, ref, got, ref_grads, lr: float) -> dict:
    """One AdamW update of ``got`` against ``ref`` (leaf lists in one order:
    the weights before, the reference's and the held side's after, the
    gradients or first moments behind ``ref``), in units of ``lr`` after the
    slack of two float32 roundings: {"kept": largest over the weights that
    are not near-ties (``|ref_grads|`` ≥ TRAIN_TOL["tie"] of the leaf's
    largest), "all": largest over all weights, "share": the share kept}."""
    kept = total = 0
    worst_kept = worst_all = 0.0
    for a, r, g, m in zip(w0, ref, got, ref_grads):
        a, r, g, m = (_np64(x).ravel() for x in (a, r, g, m))
        err = (np.abs((g - a) - (r - a)) - TRAIN_TOL["params_rtol"] * np.abs(a)) / lr
        keep = np.abs(m) >= TRAIN_TOL["tie"] * np.abs(m).max()
        kept, total = kept + int(keep.sum()), total + a.size
        worst_all = max(worst_all, float(err.max()))
        if keep.any():
            worst_kept = max(worst_kept, float(err[keep].max()))
    return {"kept": worst_kept, "all": worst_all, "share": kept / total}


def train_once(api, acfg, params, batch: dict) -> dict:
    """One train step from fresh AdamW state on ``params``' device: the loss,
    the gradients, their global norm, the params and the state after the
    update."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts

    dev = opt.tree_leaves(params)[0].device
    loss, grads = ts.loss_and_grads(api, params, {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
    new_params, state, gnorm = opt.apply_updates(acfg, params, grads, opt.init_state(params))
    return dict(loss=float(loss), grads=grads, grad_norm=float(gnorm), params=new_params, state=state)


def second_step_gap(acfg, cpu: dict, seed: int) -> float:
    """AdamW's second step alone, on the card against the CPU from identical
    inputs: ``cpu``'s weights and state after its first step, and its
    gradients times a seeded normal draw.  The largest update gap in units
    of lr_at(1), over every weight."""
    from repro_torch.training import optimizer as opt

    gen = torch.Generator().manual_seed(seed)
    p1, grads = cpu["params"], cpu["grads"]
    g2 = opt.tree_map(lambda g: g * torch.randn(g.shape, generator=gen, dtype=g.dtype), grads)
    on = lambda t: opt.tree_map(lambda x: x.detach().to(DEVICE), t)
    state = {"m": on(cpu["state"]["m"]), "v": on(cpu["state"]["v"]), "step": cpu["state"]["step"].to(DEVICE)}
    c, _, _ = opt.apply_updates(acfg, p1, g2, cpu["state"])
    g, _, _ = opt.apply_updates(acfg, on(p1), on(g2), state)
    leaves = opt.tree_leaves
    return update_gap(leaves(p1), leaves(c), leaves(g), leaves(g2), float(opt.lr_at(acfg, 1)))["all"]


def train_parity(acfg, before, cpu: dict, card: dict) -> dict:
    """``train_once`` on the CPU and on the card from the weights ``before``,
    held against ``TRAIN_TOL``: {name: (value, bound, ok)}, the gradients'
    min per-leaf correlation included (leaves of one element, or constant
    ones, left out)."""
    from repro_torch.training import optimizer as opt

    gc = [g.detach().float().cpu().numpy().ravel() for g in opt.tree_leaves(cpu["grads"])]
    gg = [g.detach().float().cpu().numpy().ravel() for g in opt.tree_leaves(card["grads"])]
    corr = min(float(np.corrcoef(a, b)[0, 1]) for a, b in zip(gc, gg) if a.size > 1 and a.std() > 0)
    leaves = opt.tree_leaves
    up = update_gap(leaves(before), leaves(cpu["params"]), leaves(card["params"]), gc, float(opt.lr_at(acfg, 0)))
    finite = all(bool(torch.isfinite(g).all()) for g in opt.tree_leaves(card["grads"]))
    dl = abs(card["loss"] - cpu["loss"])
    rel = abs(card["grad_norm"] - cpu["grad_norm"]) / cpu["grad_norm"]
    return {"loss |d|": (dl, TRAIN_TOL["loss"], dl <= TRAIN_TOL["loss"]),
            "grad_norm rel": (rel, TRAIN_TOL["grad_norm_rel"], rel <= TRAIN_TOL["grad_norm_rel"]),
            "grad corr min": (corr, TRAIN_TOL["grad_corr"], corr >= TRAIN_TOL["grad_corr"]),
            f"update |d|/lr, {up['share']:.3f} of the weights (no near-tie)":
                (up["kept"], TRAIN_TOL["update_lr"], up["kept"] <= TRAIN_TOL["update_lr"]),
            "update |d|/lr, all weights": (up["all"], TRAIN_TOL["params_lr"], up["all"] <= TRAIN_TOL["params_lr"]),
            "grads finite": (float(finite), 1.0, finite)}


def phase_3j(paths, reset_launches, read_launches, smi) -> int:
    """Phase 3j: the training path on the card — the ten archs' SMOKE train
    step against the CPU, smollm-135m at full width (one step against the
    CPU; ms a step, tokens/s, MFU and the roofline at 16 × 512; microbatch
    4), ``launch.train.run`` at SMOKE with checkpoints and a resume, and the
    int8 compression.  Arguments as ``phase_3i``'s.  Returns 0, or 1 after
    printing what failed."""
    import copy
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.checkpoint import manager
    from repro_torch.core.hardware import H100_HBM_BPS, H100_PEAK_FLOPS_BF16
    from repro_torch.data import pipeline
    from repro_torch.launch import train as train_launch
    from repro_torch.models import registry
    from repro_torch.models.convert import params_from_reference, reference_layout
    from repro_torch.roofline import analysis, memory_model
    from repro_torch.serving.engine import Engine, SamplerConfig
    from repro_torch.training import compress
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts

    problems = []
    acfg = opt.AdamWConfig(**TRAIN_ACFG)
    reset_launches()

    print("the ten archs at SMOKE width, one train step, card vs the port's CPU path:")
    for arch in configs.ARCH_IDS:
        scfg = configs.get_config(arch, smoke=True)
        sapi = registry.build(scfg)
        cpu_p = sapi.init_params(0, device="cpu")
        batch = smoke_inputs(scfg, 2, 49)
        batch.pop("token")
        c, g = (train_once(sapi, acfg, p, batch) for p in (cpu_p, copy.deepcopy(cpu_p).to(DEVICE)))
        dl, rel = abs(g["loss"] - c["loss"]), abs(g["grad_norm"] - c["grad_norm"]) / c["grad_norm"]
        finite = all(bool(torch.isfinite(x).all()) for x in opt.tree_leaves(g["grads"]))
        print(f"  {arch}: loss {g['loss']:.4f} (|d| {dl:.5f}), grad_norm {g['grad_norm']:.4f} (rel {rel:.2e}), "
              f"grads finite {finite}")
        if not (dl <= SMOKE_TRAIN_TOL["loss"] and rel <= SMOKE_TRAIN_TOL["grad_norm_rel"] and finite):
            problems.append(f"{arch} SMOKE train step: loss |d| {dl}, grad_norm rel {rel}, finite {finite} "
                            f"(bounds {SMOKE_TRAIN_TOL})")

    cfg = configs.get_config(TRAIN["arch"])
    api = registry.build(cfg)
    tree = llm_reference_tree(cfg, LLM["seed"])
    cpu_params = params_from_reference(cfg, tree, device="cpu")
    params = params_from_reference(cfg, tree, device=DEVICE)
    b, s = TRAIN["parity"]
    batch = {"tokens": pipeline.synthetic_lm_batch(LLM["seed"], 0, b, s, cfg.vocab)}
    t = time.perf_counter()
    on_cpu = train_once(api, acfg, cpu_params, batch)
    cpu_s = time.perf_counter() - t
    on_card = train_once(api, acfg, params, batch)
    res = train_parity(acfg, cpu_params, on_cpu, on_card)
    gap2 = second_step_gap(acfg, on_cpu, LLM["seed"])
    res["second step (AdamW alone) |d|/lr, all weights"] = (gap2, TRAIN_TOL["update_lr"],
                                                           gap2 <= TRAIN_TOL["update_lr"])
    print(f"{cfg.arch_id} at full width ({cfg.param_count() / 1e6:.1f} M parameters), one train step at {b} × {s}, "
          f"card vs the port's CPU path ({cpu_s:.1f} s): loss {on_card['loss']:.5f} vs {on_cpu['loss']:.5f}, "
          f"grad_norm {on_card['grad_norm']:.5f} vs {on_cpu['grad_norm']:.5f}; "
          + ", ".join(f"{k} {v[0]:.6g} (bound {v[1]:.3g})" for k, v in res.items()))
    bad = {k: v for k, v in res.items() if not v[2]}
    if bad:
        problems.append(f"{cfg.arch_id} full-width train step card vs CPU out of bounds: {bad}")
    # the backward outside layers.reference_precision(), for the record (the
    # train step never does this): under the process's own cuBLAS flags, and
    # with bf16-reduced reductions and TF32 both allowed
    m = torch.backends.cuda.matmul
    saved = m.allow_bf16_reduced_precision_reduction, m.allow_tf32
    for flags in (saved, (True, True)):
        m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = flags
        try:
            loss = api.train_loss(params, tokens=torch.as_tensor(batch["tokens"], device=DEVICE))
            loose = torch.autograd.grad(loss, opt.tree_leaves(params))
        finally:
            m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = saved
        dloose = max(float((a - bb).abs().max()) for a, bb in zip(loose, opt.tree_leaves(on_card["grads"])))
        print(f"  the same gradients with the backward outside reference_precision (allow_bf16_reduced_"
              f"precision_reduction={flags[0]}, allow_tf32={flags[1]}): max |d| {dloose:.3g}")
    # compression of the full-width gradients: the card's bits are the CPU's
    grads_cpu = [g.detach().cpu() for g in opt.tree_leaves(on_card["grads"])]
    same = True
    for g, gc in zip(opt.tree_leaves(on_card["grads"]), grads_cpu):
        q, sc = compress.quantize(g)
        qc, scc = compress.quantize(gc)
        back = compress.dequantize(q, sc, g.shape, g.dtype).cpu()
        same &= torch.equal(q.cpu(), qc) and torch.equal(sc.cpu(), scc) and torch.equal(
            back, compress.dequantize(qc, scc, gc.shape, gc.dtype))
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            reduced = opt.tree_leaves(compress.compressed_psum_mean(on_card["grads"]))
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    psum_same = all(torch.equal(r, compress.dequantize(*compress.quantize(g), g.shape, g.dtype))
                    for r, g in zip(reduced, opt.tree_leaves(on_card["grads"])))
    print(f"  int8 compression of the {len(grads_cpu)} gradient leaves: quantize/dequantize on the card equal the "
          f"CPU's bit for bit: {same}; compressed_psum_mean over a one-rank NCCL group equals "
          f"dequantize(quantize(g)): {psum_same}")
    if not (same and psum_same):
        problems.append(f"compression on the card: bit-equal to the CPU {same}, one-rank psum exact {psum_same}")
    del on_cpu, cpu_params, loose

    # speed at 16 × 512 (remat on): CUDA events, host included
    b, s = TRAIN["speed"]
    tokens = torch.as_tensor(pipeline.synthetic_lm_batch(LLM["seed"], 1, b, s, cfg.vocab), device=DEVICE)
    state0 = opt.init_state(params)
    step1 = ts.build_train_step(api, None, acfg)
    step4 = ts.build_train_step(api, None, acfg, microbatch=TRAIN["microbatch"])
    _, _, m1 = step1(params, state0, {"tokens": tokens})
    _, _, m4 = step4(params, state0, {"tokens": tokens})
    dmb = abs(float(m1["loss"]) - float(m4["loss"]))
    run = {"params": params, "state": state0}

    def one_step(fn=step1):
        run["params"], run["state"], _ = fn(run["params"], run["state"], {"tokens": tokens})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(one_step, iters=TRAIN["iters"], warmup=TRAIN["warmup"])
    peak = torch.cuda.max_memory_allocated()
    mb_ms = time_ms(lambda: one_step(step4), iters=3, warmup=1)
    # the step's two layers apart: forward + backward (remat), then AdamW
    _, grads = ts.loss_and_grads(api, run["params"], {"tokens": tokens})
    fb_ms = time_ms(lambda: ts.loss_and_grads(api, run["params"], {"tokens": tokens}), iters=3, warmup=1)
    adam_ms = time_ms(lambda: opt.apply_updates(acfg, run["params"], grads, run["state"]), iters=5, warmup=1)
    del grads
    busy, wall, by_name = device_busy(one_step)
    n = cfg.param_count()
    flops = analysis.model_flops_per_step(n, n, b * s, "train")
    roof = analysis.roofline_terms(flops, memory_model.train_bytes(cfg, b, s), 0.0, 1)
    print(f"  on {smi}: train step at {b} × {s} ({b * s} tokens, remat): {step_ms:.3f} ms a step over "
          f"{TRAIN['iters']} steps after {TRAIN['warmup']}, {b * s * 1e3 / step_ms:.1f} tokens/s, "
          f"MFU {flops / (step_ms / 1e3) / H100_PEAK_FLOPS_BF16:.4f} ({flops:.4g} FLOP ÷ {H100_PEAK_FLOPS_BF16:.3g}); "
          f"roofline: compute {roof.compute_s * 1e3:.3f} ms, memory {roof.memory_s * 1e3:.3f} ms "
          f"({roof.hbm_bytes:.4g} B ÷ {H100_HBM_BPS:.3g}); peak memory {peak / 2**30:.2f} GiB; "
          f"microbatch {TRAIN['microbatch']}: {mb_ms:.3f} ms a step, loss {float(m4['loss']):.5f} vs "
          f"{float(m1['loss']):.5f} (|d| {dmb:.2e}, bound {TRAIN_TOL['microbatch_loss']})")
    print(f"  the step's parts: loss and gradients {fb_ms:.3f} ms, AdamW over "
          f"{len(opt.tree_leaves(run['params']))} leaves {adam_ms:.3f} ms")
    print(f"  one step under the profiler: device busy {busy:.3f} ms of {wall:.3f} ms wall, busy share "
          f"{busy / wall:.3f}; device events {sum(by_name.values()):.3f} ms, their share "
          f"{sum(by_name.values()) / wall:.3f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"    device events {sum(by_name.values()):.3f} ms: " + ", ".join(f"{k[:48]} {v:.3f}" for k, v in top))
    if dmb > TRAIN_TOL["microbatch_loss"]:
        problems.append(f"microbatch {TRAIN['microbatch']} loss differs by {dmb}")
    del run, params, state0

    # launch.train at SMOKE: checkpoints, restore, a resume from step 200, generation
    e2e = TRAIN["e2e"]
    with tempfile.TemporaryDirectory() as tmp:
        first, second = os.path.join(tmp, "run"), os.path.join(tmp, "resume")
        kw = dict(smoke=True, steps=e2e["steps"], batch=e2e["batch"], seq=e2e["seq"], ckpt_every=e2e["ckpt_every"],
                  lr=e2e["lr"], log_every=100, device=DEVICE)
        t = time.perf_counter()
        out = train_launch.run(TRAIN["arch"], ckpt_dir=first, **kw)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t
        step, restored = manager.restore(first)
        same = all(np.array_equal(a, bb) for a, bb in zip(
            opt.tree_leaves(restored["params"]), opt.tree_leaves(reference_layout(out["params"]))))
        at = f"step_{e2e['resume']:08d}"
        os.makedirs(second)
        shutil.copytree(os.path.join(first, at), os.path.join(second, at))
        again = train_launch.run(TRAIN["arch"], ckpt_dir=second, **kw)
        torch.cuda.synchronize()
    gap = float(np.max(np.abs(np.array(again["history"]) - np.array(out["history"][e2e["resume"]:]))))
    print(f"  launch.train.run({TRAIN['arch']} SMOKE, {e2e['steps']} steps, batch {e2e['batch']} × seq {e2e['seq']}, "
          f"lr {e2e['lr']}): {e2e_s:.1f} s, first loss {out['first_loss']:.4f}, final loss {out['final_loss']:.4f}; "
          f"restore of step {step} equals the run's params: {same}; resume from step {e2e['resume']}: "
          f"max |loss d| over steps {e2e['resume']}–{e2e['steps'] - 1} {gap:.3g} (bound {TRAIN_TOL['resume']})")
    if not out["final_loss"] < out["first_loss"] - 1.0:
        problems.append(f"SMOKE training loss {out['first_loss']} → {out['final_loss']}, not down by 1.0")
    if step != e2e["steps"] or not same:
        problems.append(f"restore gave step {step}, params equal {same}")
    if not gap <= TRAIN_TOL["resume"] or len(again["history"]) != e2e["steps"] - e2e["resume"]:
        problems.append(f"resumed losses differ by {gap}")
    scfg = configs.get_config(TRAIN["arch"], smoke=True)
    corpus = pipeline.ByteCorpus(vocab=scfg.vocab)
    prompts = corpus.batch(seed=1, step=0, batch=2, seq=15)
    eng = Engine(registry.build(scfg), out["params"], batch=2, max_seq=64, device=DEVICE)
    toks = eng.generate(prompts, e2e["tokens"], SamplerConfig(temperature=0.0))
    for p, row in zip(prompts, toks):
        print(f"    {bytes(p.tolist())!r} → {bytes(row.tolist())!r}")
    if toks.shape != (2, e2e["tokens"]) or toks.min() < 0 or toks.max() >= scfg.vocab:
        problems.append(f"generation from the trained params gave {toks.shape} tokens")
    torch.cuda.synchronize()
    paths["3j training"] = launched = read_launches()
    if any(launched.values()):
        problems.append(f"the training path launched FHE kernels: {launched}")
    if problems:
        print("FAILED training: " + "; ".join(problems), file=sys.stderr)
        return 1
    return 0


# Phase 3k: sharding, meshes, the sharded train step and the dry-run.  The
# sharded step runs TRAIN's speed shape (16 × 512, remat) for two steps from
# 3j's weights (LLM["seed"]) on a one-rank NCCL mesh; a 1×1 mesh's local
# shards are the whole tensors, so it must equal the plain step bit for bit.
SHARDED = dict(arch="smollm-135m", batch=(16, 512), steps=2, iters=3, warmup=1)
# The dry-run cells, one process each, started in 3k after its last timed
# step so that no timed phase shares the host's cores with them: smollm-135m
# at train_4k on the fake 16×16 and 2×16×16 meshes (multi_pod False, True)
# at full depth, each with the mesh on device type "cuda" and on "cpu";
# without the dry-run's MemTracker pass, which would double each cell's time
# (the sweep, tools/dryrun_sweep.sh, measures the peak bytes).
DRYRUN = dict(arch="smollm-135m", shape="train_4k", multi_pods=(False, True), device_types=("cuda", "cpu"),
              timeout=600)
DRYRUN_WORKER = r"""
import json, sys, time
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun
arch, shape, multi_pod, device_type, out = sys.argv[1:6]
t = time.perf_counter()
rec = dryrun.lower_cell(arch, shape, multi_pod == "1", device_type=device_type, memory=False)
rec["wall_s"] = time.perf_counter() - t
with open(out, "w") as f:
    json.dump(rec, f)
"""
# the keys of a dry-run record that the card's cell and the CPU's must share
DRYRUN_SAME = ("flops", "model_flops", "hbm_bytes", "collectives", "coll_bytes_total", "roofline", "chips")


def start_dryrun_cells() -> list:
    """One process per (cell, device type) of ``DRYRUN``; each writes its
    record to build/dryrun_3k/ and its log beside it."""
    out = ROOT / "build" / "dryrun_3k"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cells = []
    for multi_pod in DRYRUN["multi_pods"]:
        for device_type in DRYRUN["device_types"]:
            tag = f"{DRYRUN['arch']}_{DRYRUN['shape']}_{'pod2' if multi_pod else 'pod1'}_{device_type}"
            log = open(out / f"{tag}.log", "w")
            proc = subprocess.Popen([sys.executable, "-c", DRYRUN_WORKER, DRYRUN["arch"], DRYRUN["shape"],
                                     "1" if multi_pod else "0", device_type, str(out / f"{tag}.json")],
                                    cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
            cells.append(dict(tag=tag, multi_pod=multi_pod, device_type=device_type, proc=proc,
                              log=log, path=out / f"{tag}.json", started=time.perf_counter()))
    return cells


def stop_dryrun_cells(cells: list) -> None:
    for c in cells:
        if c["proc"].poll() is None:
            c["proc"].kill()
            c["proc"].wait()
        c["log"].close()


def phase_3k(paths, reset_launches, read_launches, smi, matmul_keys) -> int:
    """Phase 3k: the sharded train step of smollm-135m at full width on a 1×1
    NCCL mesh against the plain step (two steps, every weight and moment),
    the multi-job step lowered on an 8-affiliation fake mesh, its graph run
    on the card against ``EXECUTOR``'s digests, and then the dry-run cells of
    ``DRYRUN`` (card against CPU).  Arguments as ``phase_3i``'s, plus the
    keys of ``EXECUTOR["preset"]``.  Returns 0, or 1 after printing what
    failed."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core import executor as E
    from repro_torch.data import pipeline
    from repro_torch.distributed import sharding as sh
    from repro_torch.fhe import keys as K
    from repro_torch.fhe import ops as fhe_ops
    from repro_torch.fhe import params as P
    from repro_torch.fhe.context import ExecPolicy, FheContext
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.models import registry
    from repro_torch.models.convert import params_from_reference
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts

    problems = []
    # the lowered multi-job step's inputs, encrypted before the counts are
    # set to 0: encryption launches the FHE kernels, the path below none
    fhe_p = P.workload_params(EXECUTOR["preset"])
    ctx = FheContext(params=fhe_p, keys=matmul_keys, policy=ExecPolicy(backend="ref"), device=DEVICE)
    pairs = executor_pairs(ctx)
    torch.cuda.synchronize()
    reset_launches()

    # -- the sharded step at full width on a one-rank NCCL mesh --------------
    cfg = configs.get_config(SHARDED["arch"])
    api = registry.build(cfg)
    acfg = opt.AdamWConfig(**TRAIN_ACFG)
    params = params_from_reference(cfg, llm_reference_tree(cfg, LLM["seed"]), device=DEVICE)
    b, s = SHARDED["batch"]
    batches = [{"tokens": torch.as_tensor(pipeline.synthetic_lm_batch(LLM["seed"], i, b, s, cfg.vocab), device=DEVICE)}
               for i in range(SHARDED["steps"])]
    mesh = single_device_mesh(DEVICE)
    try:
        spec = {k: v[1] for k, v in api.input_specs("train_4k", mesh).items()}
        steps = {"plain": ts.build_train_step(api, None, acfg), "sharded": ts.jit_train_step(api, mesh, acfg, spec)}
        runs = {}
        for name, step in steps.items():
            p, st, metrics = params, opt.init_state(params), []
            for batch in batches:
                p, st, m = step(p, st, batch)
                metrics.append({k: float(v.full_tensor() if sh.is_dtensor(v) else v) for k, v in m.items()})
            runs[name] = dict(params=p, state=st, metrics=metrics)
        torch.cuda.synchronize()
        local = lambda x: x.to_local() if sh.is_dtensor(x) else x
        pl, sd = runs["plain"], runs["sharded"]
        placed = [sh.is_dtensor(x) and x.device_mesh is mesh for x in opt.tree_leaves(sd["params"])]
        gaps = {}
        for what in ("params", "m", "v"):
            a = opt.tree_leaves(pl["params"] if what == "params" else pl["state"][what])
            g = opt.tree_leaves(sd["params"] if what == "params" else sd["state"][what])
            gaps[what] = max(float((x.detach().float() - local(y).detach().float()).abs().max()) for x, y in zip(a, g))
            gaps[what + " bit-equal"] = all(torch.equal(x.detach(), local(y).detach()) for x, y in zip(a, g))
        same_metrics = all(pm[k] == sm[k] for pm, sm in zip(pl["metrics"], sd["metrics"]) for k in ("loss", "grad_norm"))
        print(f"{cfg.arch_id} at full width ({cfg.param_count() / 1e6:.1f} M parameters), {SHARDED['steps']} train "
              f"steps at {b} × {s} (remat), jit_train_step on a 1×1 NCCL mesh (params, moments and batch as DTensors "
              f"by the specs: {sum(placed)} of {len(placed)} leaves) against build_train_step(mesh=None):")
        for i, (pm, sm) in enumerate(zip(pl["metrics"], sd["metrics"])):
            print(f"  step {i + 1}: loss {sm['loss']:.6f} vs {pm['loss']:.6f}, grad_norm {sm['grad_norm']:.6f} vs "
                  f"{pm['grad_norm']:.6f}")
        print("  after the last step, max |Δ| " + ", ".join(f"{k} {v}" for k, v in gaps.items()))
        if not (all(placed) and same_metrics and gaps["params bit-equal"] and gaps["m bit-equal"]
                and gaps["v bit-equal"]):
            problems.append(f"sharded step on a 1×1 mesh differs from the plain step: metrics equal {same_metrics}, "
                            f"gaps {gaps}, DTensor leaves {sum(placed)}/{len(placed)}")
        del runs, pl, sd
        ms = {}
        for name, step in steps.items():
            run = {"p": params, "s": opt.init_state(params)}

            def one(step=step, run=run):
                run["p"], run["s"], _ = step(run["p"], run["s"], batches[0])

            ms[name] = time_ms(one, iters=SHARDED["iters"], warmup=SHARDED["warmup"])
            del run
        print(f"  on {smi}: {ms['sharded']:.3f} ms a step sharded, {ms['plain']:.3f} ms plain (CUDA events over "
              f"{SHARDED['iters']} steps after {SHARDED['warmup']}, host included): DTensor's dispatch costs "
              f"{ms['sharded'] - ms['plain']:.3f} ms a step")
    finally:
        dist.destroy_process_group()
    del params, batches

    # -- the lowered multi-job step -----------------------------------------------
    aff = E.affiliation_mesh(EXECUTOR["affiliations"], torch.device(DEVICE).type, fake=True)
    try:
        t = time.perf_counter()
        gm, counts = E.lower_multi_job_step(fhe_p, K.full_keyset(fhe_p, seed=0, device="cpu"), aff, jobs_per_aff=1)
        lower_s = time.perf_counter() - t
        gm = E.place_graph(gm, DEVICE)
        got = []
        for a, bb in pairs:  # one affiliation's real inputs at a time: its one job
            c0, c1 = gm(a.c0[None], a.c1[None], bb.c0[None], bb.c1[None])
            got.append(digest(fhe_ops.Ciphertext(c0[0], c1[0], a.level - 1, a.scale)))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    print(f"  lower_multi_job_step at {EXECUTOR['preset']} on an {aff.size()}-affiliation fake ('aff',) mesh (CPU "
          f"keys, keygen included): {lower_s:.2f} s, {sum(counts.values())} graph ops ({len(counts)} kinds); its graph "
          f"placed on {DEVICE}, on each job's inputs: digests equal EXECUTOR's "
          f"{sum(g == w for g, w in zip(got, EXECUTOR['digests']))}/{len(got)}")
    if got != list(EXECUTOR["digests"]):
        problems.append(f"lowered multi-job step digests {got} != {EXECUTOR['digests']}")

    # -- the dry-run cells, card against CPU, after the last timed step ----------
    cells = start_dryrun_cells()
    try:
        t = time.perf_counter()
        recs = {}
        for c in cells:
            left = DRYRUN["timeout"] - (time.perf_counter() - c["started"])
            try:
                rc = c["proc"].wait(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                rc = None
            c["log"].flush()
            if rc != 0 or not c["path"].exists():
                tail = c["path"].with_suffix(".log").read_text()[-1500:]
                problems.append(f"dry-run cell {c['tag']} exit {rc}: {tail}")
                continue
            recs[c["tag"]] = rec = json.loads(c["path"].read_text())
            r = rec["roofline"]
            print(f"  dry-run {c['tag']}: {rec['status']} in {rec['wall_s']:.1f} s ({rec['lower_s']} s the step), "
                  f"flops {rec['flops']:.6g} (model {rec['model_flops']:.6g}, useful {rec['useful_flops_ratio']:.4f}), "
                  f"collectives {rec['collectives']['count']} = {rec['coll_bytes_total']:.6g} B over {rec['chips']} "
                  f"ranks, roofline compute {r['compute_s']:.3e} s, memory {r['memory_s']:.3e} s, collective "
                  f"{r['collective_s']:.3e} s ({r['dominant']}), memory {rec['memory']}")
        print(f"  waited {time.perf_counter() - t:.1f} s for the {len(cells)} dry-run processes")
    finally:
        stop_dryrun_cells(cells)
    for multi_pod in DRYRUN["multi_pods"]:
        pair = [recs.get(c["tag"]) for c in cells if c["multi_pod"] == multi_pod]
        if None in pair or len(pair) != 2:
            continue
        card, cpu = pair
        diff = [k for k in DRYRUN_SAME if card[k] != cpu[k]]
        if diff or card["memory"]["argument_bytes"] != cpu["memory"]["argument_bytes"] or card["status"] != "ok":
            problems.append(f"dry-run cell multi_pod {multi_pod}: card and CPU differ in {diff}")

    paths["3k sharding"] = launched = read_launches()
    if any(launched.values()):
        problems.append(f"the sharding path launched FHE kernels: {launched}")
    if problems:
        print("FAILED sharding: " + "; ".join(problems), file=sys.stderr)
        return 1
    return 0


def rand_residues(shape, primes, gen) -> torch.Tensor:
    q = torch.tensor(primes, dtype=torch.int64, device=DEVICE)[:, None]
    x = torch.randint(0, 1 << 31, shape, generator=gen, device=DEVICE, dtype=torch.int64)
    return (x % q).int()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout that holds src/repro_torch", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    return phases()


def phases() -> int:
    """Phases 1–4."""
    from repro_torch.core import executor as E
    from repro_torch.fhe import keys as K
    from repro_torch.fhe import linear
    from repro_torch.fhe import params as P
    from repro_torch.fhe import poly, rns
    from repro_torch.fhe.context import ExecPolicy, FheContext
    from repro_torch.kernels import cuda, dispatch, tables
    from repro_torch.kernels.bconv import ops as bops
    from repro_torch.kernels.bconv import ref as bref
    from repro_torch.kernels.bsgsmac import ops as bmops
    from repro_torch.kernels.bsgsmac import ref as bmref
    from repro_torch.kernels.fusedks import ops as fops
    from repro_torch.kernels.fusedks import ref as fref
    from repro_torch.kernels.hoistrot import ops as hops
    from repro_torch.kernels.hoistrot import ref as href
    from repro_torch.kernels.modops import ops as mops
    from repro_torch.kernels.modops import ref as mref
    from repro_torch.kernels.ntt import ops as nops
    from repro_torch.kernels.ntt import ref as nref
    from repro_torch.kernels.rescale import ops as rsops
    from repro_torch.kernels.rescale import ref as rsref

    # -- 1. card and build ------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = cuda.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'nothing (cached)'}")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    kernels = {
        "modops": dict(k=mops.KERNEL, source="src/repro_torch/csrc/modops.cu",
                       replaces="src/repro/kernels/modops/kernel.py:62 (mulmod_pallas), :76, :90"),
        "ntt": dict(k=nops.KERNEL, source="src/repro_torch/csrc/ntt.cu",
                    replaces="src/repro/kernels/ntt/kernel.py:104 (ntt_pallas)"),
        "fused_ks": dict(k=fops.FUSED_KS, source="src/repro_torch/csrc/fusedks.cu",
                         replaces="src/repro/kernels/fusedks/kernel.py:121 (fused_ks_pallas)"),
        "fused_moddown": dict(k=fops.FUSED_MODDOWN, source="src/repro_torch/csrc/fusedks.cu",
                              replaces="src/repro/kernels/fusedks/kernel.py:178 (fused_moddown_pallas)"),
        "bconv": dict(k=bops.KERNEL, source="src/repro_torch/csrc/bconv.cu",
                      replaces="src/repro/kernels/bconv/kernel.py:56 (bconv_pallas)"),
        "hoist_modup": dict(k=hops.HOIST_MODUP, source="src/repro_torch/csrc/hoistrot.cu",
                            replaces="src/repro/kernels/hoistrot/kernel.py:56 (hoist_modup_pallas)"),
        "hoist_mac": dict(k=hops.HOIST_MAC, source="src/repro_torch/csrc/hoistrot.cu",
                          replaces="src/repro/kernels/hoistrot/kernel.py:111 (hoist_mac_pallas)"),
        "bsgs_mac": dict(k=bmops.KERNEL, source="src/repro_torch/csrc/bsgsmac.cu",
                         replaces="none: a BSGS matvec's mulmod_pallas and addmod_pallas chain, one launch"),
        "fused_rescale": dict(k=rsops.KERNEL, source="src/repro_torch/csrc/rescale.cu",
                              replaces="none: a rescale's ntt_pallas, int64 arithmetic and modops chain, one launch"),
    }
    for v in kernels.values():
        v["cases"] = []

    def reset_launches():
        for v in kernels.values():
            v["k"].launches = 0

    def read_launches() -> dict:
        return {k: v["k"].launches for k, v in kernels.items()}

    def launches_of(counts) -> dict:
        """The kernel launches a dict of dispatch counts implies."""
        want = {k: 0 for k in kernels}
        for op, c in counts.items():
            want[KERNEL_OF[op]] += c
        return want

    # The MLP's BSGS plans (numpy): their baby-step groups give hoist_mac's shape.
    mlp_p = P.workload_params(MLP["preset"])
    model = mlp_model(mlp_p)
    plan1 = linear.plan_matrix(model["m1"], tol=1e-12, params=mlp_p, level=mlp_p.L, hoisting=True)
    plan2 = linear.plan_matrix(model["m2"], tol=1e-12, params=mlp_p, level=mlp_p.L - 2, hoisting=True)

    # -- 2. every kernel against its plain version, at the main path's shapes ---
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    failures = []

    def check(kname, case, kernel_fn, plain_fn, nbytes, ops, blocks=None, grid=None, int8_ops=0):
        k = kernels[kname]["k"]
        before = k.launches
        got = kernel_fn()
        torch.cuda.synchronize()
        launched = k.launches - before
        want = plain_fn()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        kms = time_ms(kernel_fn, hide_host=True)
        call_ms = time_ms(kernel_fn)
        pms = time_ms(plain_fn, iters=5, warmup=1)
        bms, by = bound(nbytes, ops, int8_ops)
        rec = dict(case=case, exact=exact, max_abs_err=err, launched=launched, kernel_ms=kms, call_ms=call_ms,
                   plain_ms=pms, bound_ms=bms, bound_by=by)
        shown = ""
        if blocks is not None:
            rec["blocks_per_pass"] = list(blocks)
            shown = f" blocks/pass {blocks[0]}+{blocks[1]}"
        if grid is not None:
            rec["grid"] = list(grid)
            shown = f" grid {grid[0]}x{grid[1]}"
        kernels[kname]["cases"].append(rec)
        print(f"  {kname:14s} {case:40s} exact={exact} launched={launched} kernel {kms:.4f} ms "
              f"call {call_ms:.4f} ms plain {pms:.3f} ms bound {bms:.4f} ms ({by}){shown}")
        if not exact or launched < 1:
            failures.append(f"{kname} {case}")

    def check_ntt(case, kfn, pfn, x, plan):
        n, l = x.shape[-1], x.shape[-2]
        rows = x.numel() // n
        check("ntt", case, lambda: kfn(x, plan), lambda: pfn(x, plan), (2 * rows + 2 * l) * n * WORD,
              rows * ntt_ops_per_limb(n), blocks=nops.blocks_per_pass(rows, n))

    def check_fused_moddown(name, p, n_acc):
        n, lv, alpha = p.n, p.L, p.alpha
        nq = lv + 1
        pc = rand_residues((n_acc * alpha, n), poly.primes_for(p, poly.p_idx(p)) * n_acc, gen).reshape(n_acc, alpha, n)
        qpart = rand_residues((n_acc * nq, n), poly.primes_for(p, poly.q_idx(p, lv)) * n_acc, gen).reshape(n_acc, nq, n)
        md_ops = n_acc * (modup_ops(n, alpha, nq, nq) + nq * n * (ADDMOD + MONTMUL))
        check("fused_moddown", f"{name} pc {tuple(pc.shape)} q {tuple(qpart.shape)}",
              lambda: fops.mod_down_digits(pc, qpart, p, lv), lambda: fref.mod_down_digits_ref(pc, qpart, p, lv),
              (n_acc * alpha + 2 * n_acc * nq + 2 * nq) * n * WORD, md_ops,
              blocks=fops.moddown_blocks_per_pass(n_acc, nq, n))

    def check_fused_ks(p, level, case):
        n, beta = p.n, p.beta(level)
        nq, m = level + 1, level + 1 + p.alpha
        d = rand_residues((nq, n), poly.primes_for(p, poly.q_idx(p, level)), gen)
        ksk = rand_residues((beta, 2, m, n), poly.primes_for(p, poly.ext_idx(p, level)), gen)
        ks_ops = modup_ops(n, nq, m, beta * m) + beta * m * 2 * n * (MULMOD + ADDMOD)
        check("fused_ks", f"{case} ksk {tuple(ksk.shape)}", lambda: fops.key_switch_digits(d, ksk, p, level),
              lambda: fref.key_switch_digits_ref(d, ksk, p, level), (nq + 2 * beta * m + 2 * m + 2 * m) * n * WORD,
              ks_ops, blocks=fops.ks_blocks_per_pass(beta, m, n))

    print("kernels vs plain versions:")
    for name in ("lstm", "matmul"):
        p = P.workload_params(name)
        n, lv, alpha = p.n, p.L, p.alpha
        nq = lv + 1
        qp = poly.primes_for(p, poly.q_idx(p, lv))
        pp = poly.primes_for(p, poly.p_idx(p))
        a, b = rand_residues((nq, n), qp, gen), rand_residues((nq, n), qp, gen)
        for op, kfn, pfn, opc in (("mul", mops.pointwise_mulmod, mref.mulmod_ref, MULMOD),
                                  ("add", mops.pointwise_addmod, mref.addmod_ref, ADDMOD),
                                  ("sub", mops.pointwise_submod, mref.submod_ref, ADDMOD)):
            check("modops", f"{name} {op} ({nq}, {n})", lambda: kfn(a, b, qp), lambda: pfn(a, b, qp),
                  3 * nq * n * WORD, nq * n * opc)
        qplan, pplan = poly.plan_for(p, poly.q_idx(p, lv)), poly.plan_for(p, poly.p_idx(p))
        xp = rand_residues((2, alpha, n), pp, gen)
        ntt_cases = [(a, qplan), (xp, pplan)]
        if name == "lstm":  # the rescale's 1-limb iNTT (and NTT) of the dropped limb
            ntt_cases.append((a[lv:lv + 1], poly.plan_for(p, (lv,))))
        for inv, kfn, pfn in ((False, nops.ntt_fwd, nref.ntt_fwd_ref), (True, nops.ntt_inv, nref.ntt_inv_ref)):
            tag = "inv" if inv else "fwd"
            for x, plan in ntt_cases:
                check_ntt(f"{name} {tag} {tuple(x.shape)}", kfn, pfn, x, plan)
        # the top level, and (lstm) a level whose last digit is ragged: 10 limbs in digits of 7
        for level in (lv, 9) if name == "lstm" else (lv,):
            check_fused_ks(p, level, f"{name} level={level} beta={p.beta(level)}")
        # one key-switch's 2 accumulators; at lstm also a group of 4 rotations' 8
        for n_acc in (2, 2 * len(LSTM_GROUP["rotations"])) if name == "lstm" else (2,):
            check_fused_moddown(name, p, n_acc)

    check_fused_moddown(MLP["preset"], mlp_p, 2)
    # the NTT at the MLP's widest shape: the 10 extended limbs of lola_mnist_plain's top level
    mlp_ext = poly.ext_idx(mlp_p, mlp_p.L)
    x = rand_residues((len(mlp_ext), mlp_p.n), poly.primes_for(mlp_p, mlp_ext), gen)
    for tag, kfn, pfn in (("fwd", nops.ntt_fwd, nref.ntt_fwd_ref), ("inv", nops.ntt_inv, nref.ntt_inv_ref)):
        check_ntt(f"{MLP['preset']} {tag} {tuple(x.shape)}", kfn, pfn, x, poly.plan_for(mlp_p, mlp_ext))

    # BConv at the staged pipeline's shapes: digit 0 → extended basis, and ModDown's
    # P → q; then where BConv is large, at the dnum = 1 preset packed_bootstrap
    # (ModUp 58 → 116, ModDown 58 → 58) and at logreg (17 → 51), all at N = 2^16
    boot_p = P.make_params(BOOTSTRAP["n"], BOOTSTRAP["L"], BOOTSTRAP["dnum"], check_security=False)
    for name, moddown in (("lstm", True), ("matmul", False), (MLP["preset"], False),
                          ("packed_bootstrap", True), ("logreg", False), ("bootstrap ring", True),
                          ("exact_count", True)):
        p = boot_p if name == "bootstrap ring" else P.workload_params(name)
        n, lv = p.n, p.L
        ext = poly.primes_for(p, poly.ext_idx(p, lv))
        src = poly.primes_for(p, tuple(i for i in p.digit(0) if i <= lv))
        convs = [(src, ext)]
        if moddown:
            convs.append((poly.primes_for(p, poly.p_idx(p)), poly.primes_for(p, poly.q_idx(p, lv))))
        for bsrc, dst in convs:
            _, w = rns.bconv_tables(bsrc, dst)
            xh = rand_residues((len(bsrc), n), bsrc, gen)
            k, m = len(bsrc), len(dst)
            # whatever the design: read x̂, write the output; each of the k·m·n
            # products is 16 int8 multiply-adds, each output one reduction
            check("bconv", f"{name} ({k}, {n}) -> ({m}, {n})", lambda: bops.bconv(xh, w, dst),
                  lambda: bref.bconv_ref(xh, w, dst), (k + m) * n * WORD, m * n * MONTMUL,
                  grid=bops.bconv_blocks(k, m, n), int8_ops=2 * 16 * k * m * n)

    # the hoisted ModUp and the batched Galois MAC: the lstm group of 4 and the MLP's first baby group
    for name, nrot in (("lstm", len(LSTM_GROUP["rotations"])), (MLP["preset"], len(plan1.baby_steps()))):
        p = P.workload_params(name)
        n, lv, beta = p.n, p.L, p.beta(p.L)
        nq, m = lv + 1, lv + 1 + p.alpha
        qp = poly.primes_for(p, poly.q_idx(p, lv))
        ext = poly.primes_for(p, poly.ext_idx(p, lv))
        # the top level, and (lstm) level 9, whose second digit is ragged
        for level in (lv, 9) if name == "lstm" else (lv,):
            lnq, lm, lbeta = level + 1, level + 1 + p.alpha, p.beta(level)
            d = rand_residues((lnq, n), qp[:lnq], gen)
            check("hoist_modup", f"{name} level={level} d ({lnq}, {n}) -> ({lbeta}, {lm}, {n})",
                  lambda: hops.mod_up_digits(d, p, level), lambda: href.mod_up_digits_ref(d, p, level),
                  (lnq + 2 * lm + lbeta * lm) * n * WORD, modup_ops(n, lnq, lm, lbeta * lm),
                  blocks=hops.modup_blocks_per_pass(lbeta, lm, n))
        dig = rand_residues((beta * m, n), ext * beta, gen).reshape(beta, m, n)
        ksk = rand_residues((nrot * beta * 2 * m, n), ext * (nrot * beta * 2), gen).reshape(nrot, beta, 2, m, n)
        check("hoist_mac", f"{name} R={nrot} ksk {tuple(ksk.shape)}", lambda: hops.galois_mac(dig, ksk, p, lv),
              lambda: href.galois_mac_ref(dig, ksk, p, lv), (beta * m + nrot * 2 * beta * m + nrot * 2 * m) * n * WORD,
              nrot * 2 * m * n * beta * (MULMOD + ADDMOD))
        del dig, ksk

    # a BSGS matvec's products and sums in one launch, at the plans of BSGS_MAC_CASES
    for name, level, n1, diagonals in BSGS_MAC_CASES:
        p = P.workload_params(name)
        rows, babies, idx, off = linear.BsgsPlan(n1=n1, diags=dict.fromkeys(diagonals)).mac_layout()
        nd, nb, ng, l = len(rows), len(babies), len(off) - 1, level + 1
        qs = p.q_primes[:l]
        dg = rand_residues((nd * l, p.n), qs * nd, gen).reshape(nd, l, p.n)
        bab = rand_residues((nb * 2 * l, p.n), qs * (2 * nb), gen).reshape(nb, 2, l, p.n)
        idx, off = (torch.tensor(v, dtype=torch.int32, device=DEVICE) for v in (idx, off))
        # each diagonal, baby and partial sum once; a montmul and a 64-bit add a product,
        # a REDC and a montmul an output
        check("bsgs_mac", f"{name} D={nd} n1={n1} G={ng} ({l}, {p.n})",
              lambda: bmops.bsgs_mac(dg, bab, idx, off, qs), lambda: bmref.bsgs_mac_ref(dg, bab, idx, off, qs),
              (nd + 2 * nb + 2 * ng) * l * p.n * WORD, 2 * l * p.n * (nd * (MONTMUL + 2) + ng * 2 * MONTMUL))
        del dg, bab

    # both components' rescale in one launch, from the top level of the cells'
    # presets: lola_mnist_plain (N = 2^13), lstm, logreg and packed_bootstrap
    # (57 → 56, EvalMod's first); the device time of each pass from the profiler
    for name in (MLP["preset"], "lstm", "logreg", PACKED["preset"]):
        p = P.workload_params(name)
        n, level = p.n, p.L
        qs = p.q_primes[: level + 1]
        c0, c1 = rand_residues((level + 1, n), qs, gen), rand_residues((level + 1, n), qs, gen)
        # read both components once and write both outputs; the iNTT of 2 limbs and
        # the NTT of 2·level, then a submod and a montmul an output word
        check("fused_rescale", f"{name} level={level} -> {level - 1} 2 x ({level + 1}, {n})",
              lambda: rsops.rescale(c0, c1, p, level), lambda: rsref.rescale_ref(c0, c1, p, level),
              (2 * (level + 1) + 2 * level) * n * WORD,
              (2 + 2 * level) * ntt_ops_per_limb(n) + 2 * level * n * (ADDMOD + MONTMUL))
        if name == PACKED["preset"]:
            _, _, by_name = device_busy(lambda: rsops.rescale(c0, c1, p, level))
            print(f"    fused_rescale at {name} by pass (profiler, ms): "
                  + ", ".join(f"{k[:48]} {v:.4f}" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])))
        del c0, c1

    # one key-switch digit (β = 1) at packed_bootstrap's top level: 58 → 116
    # limbs, the shapes of EvalMod's first relinearisations (phase 3e); the
    # device time of each pass comes from the profiler
    pb = P.workload_params(PACKED["preset"])
    check_fused_ks(pb, pb.L, f"{PACKED['preset']} level={pb.L} beta={pb.beta(pb.L)}")
    check_fused_moddown(PACKED["preset"], pb, 2)
    pb_nq, pb_m = pb.L + 1, pb.L + 1 + pb.alpha
    pb_ext = poly.primes_for(pb, poly.ext_idx(pb, pb.L))
    d = rand_residues((pb_nq, pb.n), pb.q_primes, gen)
    check("hoist_modup", f"{PACKED['preset']} level={pb.L} d ({pb_nq}, {pb.n}) -> (1, {pb_m}, {pb.n})",
          lambda: hops.mod_up_digits(d, pb, pb.L), lambda: href.mod_up_digits_ref(d, pb, pb.L),
          (pb_nq + 2 * pb_m + pb_m) * pb.n * WORD, modup_ops(pb.n, pb_nq, pb_m, pb_m),
          blocks=hops.modup_blocks_per_pass(1, pb_m, pb.n))
    dig = rand_residues((pb_m, pb.n), pb_ext, gen).reshape(1, pb_m, pb.n)
    ksk = rand_residues((2 * pb_m, pb.n), pb_ext * 2, gen).reshape(1, 1, 2, pb_m, pb.n)
    check("hoist_mac", f"{PACKED['preset']} R=1 ksk {tuple(ksk.shape)}", lambda: hops.galois_mac(dig, ksk, pb, pb.L),
          lambda: href.galois_mac_ref(dig, ksk, pb, pb.L), (pb_m + 2 * pb_m + 2 * pb_m) * pb.n * WORD,
          2 * pb_m * pb.n * (MULMOD + ADDMOD))
    ksk = rand_residues((2 * pb_m, pb.n), pb_ext * 2, gen).reshape(1, 2, pb_m, pb.n)
    pc = rand_residues((2 * pb.alpha, pb.n), poly.primes_for(pb, poly.p_idx(pb)) * 2, gen).reshape(2, pb.alpha, pb.n)
    qpart = rand_residues((2 * pb_nq, pb.n), pb.q_primes * 2, gen).reshape(2, pb_nq, pb.n)
    for label, fn in (("fused_ks", lambda: fops.key_switch_digits(d, ksk, pb, pb.L)),
                      ("fused_moddown C=2", lambda: fops.mod_down_digits(pc, qpart, pb, pb.L)),
                      ("hoist_modup", lambda: hops.mod_up_digits(d, pb, pb.L))):
        _, _, by_name = device_busy(fn)
        print(f"    {label} at {PACKED['preset']} by pass (profiler, ms): "
              + ", ".join(f"{k[:48]} {v:.4f}" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])))
    # ModRaise's NTT and EvalMod's products and sums at the top level's 58 limbs
    qa, qb = rand_residues((pb_nq, pb.n), pb.q_primes, gen), rand_residues((pb_nq, pb.n), pb.q_primes, gen)
    for op, kfn, pfn, opc in (("mul", mops.pointwise_mulmod, mref.mulmod_ref, MULMOD),
                              ("add", mops.pointwise_addmod, mref.addmod_ref, ADDMOD),
                              ("sub", mops.pointwise_submod, mref.submod_ref, ADDMOD)):
        check("modops", f"{PACKED['preset']} {op} ({pb_nq}, {pb.n})", lambda: kfn(qa, qb, pb.q_primes),
              lambda: pfn(qa, qb, pb.q_primes), 3 * pb_nq * pb.n * WORD, pb_nq * pb.n * opc)
    for tag, kfn, pfn in (("fwd", nops.ntt_fwd, nref.ntt_fwd_ref), ("inv", nops.ntt_inv, nref.ntt_inv_ref)):
        check_ntt(f"{PACKED['preset']} {tag} {tuple(qa.shape)}", kfn, pfn, qa, poly.plan_for(pb, poly.q_idx(pb, pb.L)))
    del d, dig, ksk, pc, qpart, qa, qb
    # the bootstrap ring's widest NTT: the 38 extended limbs of its top level
    boot_ext = poly.ext_idx(boot_p, boot_p.L)
    x = rand_residues((len(boot_ext), boot_p.n), poly.primes_for(boot_p, boot_ext), gen)
    for tag, kfn, pfn in (("fwd", nops.ntt_fwd, nref.ntt_fwd_ref), ("inv", nops.ntt_inv, nref.ntt_inv_ref)):
        check_ntt(f"bootstrap ring {tag} {tuple(x.shape)}", kfn, pfn, x, poly.plan_for(boot_p, boot_ext))
    # the BGV presets of phase 3f.  exact_count's chain (L = 4, dnum = 3, α = 2) is
    # a shape no case above has: its products, the t-sandwich's product of the 7
    # extended limbs by a per-limb column, the NTT over them and the key-switch
    # kernels (its BConvs are in the loop above); psi's chain is lola_mnist_plain's,
    # whose fused_ks alone had no case
    ec = P.workload_params("exact_count")
    ec_nq, ec_ext = ec.L + 1, poly.ext_idx(ec, ec.L)
    ec_q, ec_m = poly.primes_for(ec, poly.q_idx(ec, ec.L)), len(ec_ext)
    a, b = rand_residues((ec_nq, ec.n), ec_q, gen), rand_residues((ec_nq, ec.n), ec_q, gen)
    for op, kfn, pfn, opc in (("mul", mops.pointwise_mulmod, mref.mulmod_ref, MULMOD),
                              ("add", mops.pointwise_addmod, mref.addmod_ref, ADDMOD),
                              ("sub", mops.pointwise_submod, mref.submod_ref, ADDMOD)):
        check("modops", f"exact_count {op} ({ec_nq}, {ec.n})", lambda: kfn(a, b, ec_q), lambda: pfn(a, b, ec_q),
              3 * ec_nq * ec.n * WORD, ec_nq * ec.n * opc)
    ec_ext_q = poly.primes_for(ec, ec_ext)
    x = rand_residues((ec_m, ec.n), ec_ext_q, gen)
    col = rand_residues((ec_m, 1), ec_ext_q, gen).expand(ec_m, ec.n)
    check("modops", f"exact_count t-sandwich mul ({ec_m}, {ec.n}) by ({ec_m}, 1)",
          lambda: mops.pointwise_mulmod(x, col, ec_ext_q), lambda: mref.mulmod_ref(x, col, ec_ext_q),
          (2 * ec_m * ec.n + ec_m) * WORD, ec_m * ec.n * MULMOD)
    for tag, kfn, pfn in (("fwd", nops.ntt_fwd, nref.ntt_fwd_ref), ("inv", nops.ntt_inv, nref.ntt_inv_ref)):
        check_ntt(f"exact_count {tag} {tuple(x.shape)}", kfn, pfn, x, poly.plan_for(ec, ec_ext))
    check_fused_ks(ec, ec.L, f"exact_count level={ec.L} beta={ec.beta(ec.L)}")
    check_fused_moddown("exact_count", ec, 2)
    psi = P.workload_params("psi")
    check_fused_ks(psi, psi.L, f"psi level={psi.L} beta={psi.beta(psi.L)}")
    if failures:
        print("FAILED kernel checks: " + ", ".join(failures), file=sys.stderr)
        return 1

    # -- 3. the main path, through the public API --------------------------------
    print("main path (keygen, encode, encrypt, ctx.mul, decrypt, decode):")
    mul_kernels = ("modops", "ntt", "fused_ks", "fused_moddown", "fused_rescale")
    main_launches, keysets, mul_ctxs = {}, {}, {}
    for name in ("matmul", "lstm"):
        p = P.workload_params(name)
        reset_launches()
        steps = {}
        ks = timed(steps, "keygen", lambda: K.full_keyset(p, seed=0, device=DEVICE))
        keysets[name] = ks
        ctx = FheContext(params=p, keys=ks, policy=ExecPolicy(), device=DEVICE)
        z = np.random.default_rng(0).normal(size=p.slots) * 0.4
        pt = timed(steps, "encode", lambda: ctx.encode(z))
        ct = timed(steps, "encrypt", lambda: ctx.encrypt(pt))
        before = read_launches()
        with dispatch.count_dispatches() as counts:
            out = timed(steps, "mul", lambda: ctx.mul(ct, ct))
        mul_launches = {k: v - before[k] for k, v in read_launches().items()}
        again = timed(steps, "mul again", lambda: ctx.mul(ct, ct))  # tables are built: steady state
        mul_ctxs[name] = (ctx, ct)  # profiled after the checks
        dec = timed(steps, "decrypt", lambda: ctx.decrypt(out))
        got = timed(steps, "decode", lambda: ctx.decode(dec))
        main_launches[name] = read_launches()

        dg = digest(out)
        err = float(np.max(np.abs(got - z * z)))
        ref = REFERENCE[name]
        print(f"  {name}: pipeline={ctx.pipeline} " + " ".join(f"{k}={v:.1f}ms" for k, v in steps.items()))
        print(f"  {name}: digest {dg[:16]} decode err {err:.3e} dispatches {dict(counts)}")
        print(f"  {name}: kernel launches in ctx.mul {mul_launches}, in the whole path {main_launches[name]}")
        problems = []
        if ctx.pipeline != "fused":
            problems.append(f"pipeline {ctx.pipeline}")
        if dg != ref["digest"]:
            problems.append(f"digest {dg} != reference {ref['digest']}")
        if not err < ref["max_err"]:
            problems.append(f"decode error {err} ≥ {ref['max_err']}")
        if not (torch.equal(again.c0, out.c0) and torch.equal(again.c1, out.c1)):
            problems.append("a second ctx.mul gave other bytes")
        if dict(counts) != fused_rescale_counts(FUSED_MUL_DISPATCHES, 1):
            problems.append(f"dispatches {dict(counts)} != {fused_rescale_counts(FUSED_MUL_DISPATCHES, 1)}")
        if mul_launches != launches_of(counts):
            problems.append(f"kernel launches {mul_launches} != dispatches {launches_of(counts)}")
        if min(main_launches[name][k] for k in mul_kernels) < 1:
            problems.append(f"a kernel was not launched: {main_launches[name]}")
        if problems:
            print(f"FAILED main path {name}: " + "; ".join(problems), file=sys.stderr)
            return 1
    paths = {f"mul {name}": launches for name, launches in main_launches.items()}

    # -- 3a. ctx.mul on the staged pipeline: BConv on the card -------------------
    print("staged pipeline (ctx.mul under ExecPolicy(backend='staged')):")
    for name in ("matmul", "lstm"):
        p = P.workload_params(name)
        ctx = FheContext(params=p, keys=keysets[name], policy=ExecPolicy(backend="staged"), device=DEVICE)
        z = np.random.default_rng(0).normal(size=p.slots) * 0.4
        ct = ctx.encrypt(ctx.encode(z))
        steps = {}
        reset_launches()
        with dispatch.count_dispatches() as counts:
            out = timed(steps, "mul", lambda: ctx.mul(ct, ct))
        paths[f"staged mul {name}"] = launched = read_launches()
        again = timed(steps, "mul again", lambda: ctx.mul(ct, ct))
        dg = digest(out)
        print(f"  {name}: pipeline={ctx.pipeline} " + " ".join(f"{k}={v:.1f}ms" for k, v in steps.items()))
        print(f"  {name}: digest {dg[:16]} dispatches {dict(counts)} launches {launched}")
        problems = []
        if ctx.pipeline != "staged":
            problems.append(f"pipeline {ctx.pipeline}")
        if dg != REFERENCE[name]["digest"] or digest(again) != dg:
            problems.append(f"digest {dg} != reference {REFERENCE[name]['digest']}")
        if dict(counts) != STAGED_MUL_DISPATCHES[name]:
            problems.append(f"dispatches {dict(counts)} != {STAGED_MUL_DISPATCHES[name]}")
        if launched != launches_of(counts) or min(launched[k] for k in ("modops", "ntt", "bconv")) < 1:
            problems.append(f"kernel launches {launched} != dispatches {launches_of(counts)}")
        if problems:
            print(f"FAILED staged path {name}: " + "; ".join(problems), file=sys.stderr)
            return 1

    # -- 3b. the encrypted MLP at lola_mnist_plain: hoisted BSGS matvecs ----------
    print(f"encrypted MLP at {MLP['preset']} (keygen, apply_bsgs, square, apply_bsgs, decode):")
    p = mlp_p
    rots = tuple(sorted(plan1.rotations() | plan2.rotations()))
    plans = (plan1.n1, plan2.n1, len(plan1.diags), len(plan2.diags))
    steps = {}
    reset_launches()
    with dispatch.count_dispatches() as counts:
        ks = timed(steps, "keygen", lambda: K.full_keyset(p, seed=0, rotations=rots, device=DEVICE))
        ctx = FheContext(params=p, keys=ks, device=DEVICE)
        ct = timed(steps, "encode+encrypt", lambda: ctx.encrypt(ctx.encode(model["x_slots"])))
        ct1 = timed(steps, "apply_bsgs 1", lambda: ctx.apply_bsgs(ct, plan1))
        ct2 = timed(steps, "square", lambda: ctx.square(ct1))
        ct3 = timed(steps, "apply_bsgs 2", lambda: ctx.apply_bsgs(ct2, plan2))
        got = timed(steps, "decode", lambda: ctx.decrypt_decode(ct3))
    paths["mlp"] = launched = read_launches()
    again = timed(steps, "MLP again", lambda: ctx.apply_bsgs(ctx.square(ctx.apply_bsgs(ct, plan1)), plan2))
    err = float(np.max(np.abs(got.real[:4] - model["want"])))
    print(f"  rotations {rots}, {len(ks.gks)} Galois keys, plans (n1, n1, diags, diags) {plans}, "
          f"policy {ctx.policy_key()} pipeline={ctx.pipeline}")
    print("  " + " ".join(f"{k}={v:.1f}ms" for k, v in steps.items()))
    print(f"  ct1 {digest(ct1)[:16]} ct3 {digest(ct3)[:16]} levels {ct1.level} {ct2.level} {ct3.level} "
          f"decode err {err:.3e}")
    print(f"  dispatches {dict(counts)} launches {launched}")
    problems = []
    if ctx.pipeline != "fused" or plans != MLP["plans"] or len(ks.gks) != MLP["galois_keys"]:
        problems.append(f"pipeline {ctx.pipeline}, plans {plans}, {len(ks.gks)} Galois keys")
    if digest(ct1) != MLP["ct1"] or digest(ct3) != MLP["ct3"] or digest(again) != MLP["ct3"]:
        problems.append(f"digests {digest(ct1)}, {digest(ct3)} != reference {MLP['ct1']}, {MLP['ct3']}")
    if not err <= MLP["max_err"]:
        problems.append(f"decode error {err} > {MLP['max_err']}")
    mlp_kernels = ("modops", "ntt", "fused_ks", "fused_moddown", "hoist_modup", "hoist_mac", "bsgs_mac")
    if launched != launches_of(counts) or min(launched[k] for k in mlp_kernels) < 1:
        problems.append(f"kernel launches {launched} != dispatches {launches_of(counts)}")
    if problems:
        print("FAILED MLP path: " + "; ".join(problems), file=sys.stderr)
        return 1
    mlp_ctx, mlp_ct = ctx, ct

    # -- 3c. a hoisted rotation group at lstm -------------------------------------
    rotations = LSTM_GROUP["rotations"]
    print(f"hoisted rotation group {rotations} at {LSTM_GROUP['preset']}, against standard rotations:")
    p = P.workload_params(LSTM_GROUP["preset"])
    steps = {}
    ks = timed(steps, "keygen", lambda: K.full_keyset(p, seed=0, rotations=rotations, device=DEVICE))
    ctx = FheContext(params=p, keys=ks, device=DEVICE)
    z = np.random.default_rng(0).normal(size=p.slots) * 0.4
    ct = ctx.encrypt(ctx.encode(z))
    reset_launches()
    with dispatch.count_dispatches() as gcounts:
        g = timed(steps, "group", lambda: ctx.rotate_hoisted_group(ct, rotations))
    paths["lstm group"] = group_launched = read_launches()
    reset_launches()
    with dispatch.count_dispatches() as rcounts:
        r1 = timed(steps, "rotate 1", lambda: ctx.rotate(ct, 1))
    paths["lstm rotate"] = rot_launched = read_launches()
    four = lambda: [ctx.rotate(ct, r) for r in rotations]
    timed(steps, "group again", lambda: ctx.rotate_hoisted_group(ct, rotations))
    timed(steps, "4 rotates again", four)
    group_dev = time_ms(lambda: ctx.rotate_hoisted_group(ct, rotations), iters=5, warmup=1, hide_host=True,
                        sleep_cycles=20 * SLEEP_CYCLES)
    four_dev = time_ms(four, iters=5, warmup=1, hide_host=True, sleep_cycles=20 * SLEEP_CYCLES)
    gd = digest(*(g[r] for r in rotations))
    errs = [float(np.max(np.abs(ctx.decrypt_decode(g[r]) - np.roll(z, -r)))) for r in rotations]
    print("  " + " ".join(f"{k}={v:.1f}ms" for k, v in steps.items()))
    print(f"  device time (CUDA events, host hidden): group {group_dev:.4f} ms, 4 rotates {four_dev:.4f} ms")
    print(f"  digest {gd[:16]} decode errors {errs} (reference {list(LSTM_GROUP['decode_errors'])})")
    print(f"  group dispatches {dict(gcounts)} launches {group_launched}")
    print(f"  rotate dispatches {dict(rcounts)} launches {rot_launched}")
    problems = []
    if ctx.pipeline != "fused" or gd != LSTM_GROUP["digest"]:
        problems.append(f"pipeline {ctx.pipeline}, digest {gd} != reference {LSTM_GROUP['digest']}")
    if not (torch.equal(r1.c0, g[1].c0) and torch.equal(r1.c1, g[1].c1)):
        problems.append("ctx.rotate(ct, 1) != group[1]")
    if dispatch.total(gcounts) != 5 + len(rotations) or dispatch.total(rcounts) != 5:
        problems.append(f"dispatches {dispatch.total(gcounts)} (group) and {dispatch.total(rcounts)} (rotate)")
    if max(abs(e - w) for e, w in zip(errs, LSTM_GROUP["decode_errors"])) > 1e-9:
        problems.append(f"decode errors {errs} != reference {LSTM_GROUP['decode_errors']}")
    group_kernels = ("modops", "ntt", "fused_moddown", "hoist_modup", "hoist_mac")
    if group_launched != launches_of(gcounts) or min(group_launched[k] for k in group_kernels) < 1:
        problems.append(f"group launches {group_launched} != dispatches {launches_of(gcounts)}")
    if rot_launched != launches_of(rcounts):
        problems.append(f"rotate launches {rot_launched} != dispatches {launches_of(rcounts)}")
    if problems:
        print("FAILED lstm group path: " + "; ".join(problems), file=sys.stderr)
        return 1
    group_ctx, group_ct = ctx, ct
    for label, fn in (
        *((f"{name} ctx.mul", lambda c=c, x=x: c.mul(x, x)) for name, (c, x) in mul_ctxs.items()),
        ("MLP (apply_bsgs, square, apply_bsgs)",
         lambda: mlp_ctx.apply_bsgs(mlp_ctx.square(mlp_ctx.apply_bsgs(mlp_ct, plan1)), plan2)),
        ("lstm group of 4", lambda: ctx.rotate_hoisted_group(ct, rotations)),
        ("lstm 4 rotates", four),
    ):
        busy, wall, by_name = device_busy(fn)
        print(f"  profile {label}: device busy {busy:.3f} ms of {wall:.3f} ms wall under the profiler, "
              f"idle share {1 - busy / wall:.3f}")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        print(f"    device events {sum(by_name.values()):.3f} ms: " + ", ".join(f"{k[:40]} {v:.4f}" for k, v in top))

    # -- 3d. a whole bootstrap at the ring of tests/test_bootstrap.py --------------
    print(f"bootstrap at n = {BOOTSTRAP['n']}, L = {BOOTSTRAP['L']}, dnum = {BOOTSTRAP['dnum']} "
          "(build_context, bootstrap under the default and the staged policy):")
    from repro_torch.fhe import bootstrap as B

    steps = {}
    bctx = timed(steps, "bctx build", lambda: B.build_context(boot_p, seed=0, h=BOOTSTRAP["h"], device=DEVICE))
    rng = np.random.default_rng(7)
    z = rng.normal(size=boot_p.slots) * 0.4 + 1j * rng.normal(size=boot_p.slots) * 0.4
    boot_ctxs = {}
    for label, policy, pipeline in (("bootstrap", ExecPolicy(), "fused"),
                                    ("staged bootstrap", ExecPolicy(backend="staged"), "staged")):
        fc = FheContext(params=boot_p, keys=bctx.keys, policy=policy, device=DEVICE)
        ct = fc.level_drop(fc.mul_const(fc.encrypt(fc.encode(z)), 1 / 64), 0)
        # plans of its own, holding no encoded diagonal: the first bootstrap encodes every one
        own = dataclasses.replace(bctx, cts_plans=tuple(map(dataclasses.replace, bctx.cts_plans)),
                                  stc_plans=tuple(map(dataclasses.replace, bctx.stc_plans)))
        boot = lambda fc=fc, ct=ct, own=own: fc.bootstrap(own, ct, post_scale=64)
        reset_launches()
        with dispatch.count_dispatches() as counts:
            out = timed(steps, label, boot)
        paths[label] = launched = read_launches()
        again = timed(steps, f"{label} again", boot)
        boot_ctxs[label] = boot
        dg = digest(out)
        err = float(np.max(np.abs(fc.decrypt_decode(out) - z)))
        print(f"  {label}: policy {fc.policy_key()} pipeline={fc.pipeline} level {out.level} digest {dg[:16]} "
              f"decode err {err:.6e} (reference {BOOTSTRAP['decode_error']:.6e})")
        print(f"  {label}: {dispatch.total(counts)} dispatches {dict(counts)} launches {launched}")
        problems = []
        if fc.pipeline != pipeline or dg != BOOTSTRAP["digest"] or digest(again) != dg:
            problems.append(f"pipeline {fc.pipeline}, digest {dg} != reference {BOOTSTRAP['digest']}")
        if out.level != BOOTSTRAP["level"] or out.level < 5:
            problems.append(f"level {out.level} != {BOOTSTRAP['level']}")
        if not err <= BOOTSTRAP["max_err"] or abs(err - BOOTSTRAP["decode_error"]) > 1e-9:
            problems.append(f"decode error {err} (reference {BOOTSTRAP['decode_error']}, bound {BOOTSTRAP['max_err']})")
        if pipeline == "staged" and dict(counts) != BOOTSTRAP["staged_dispatches"]:
            problems.append(f"dispatches {dict(counts)} != {BOOTSTRAP['staged_dispatches']}")
        if launched != launches_of(counts):
            problems.append(f"kernel launches {launched} != dispatches {launches_of(counts)}")
        if problems:
            print(f"FAILED {label}: " + "; ".join(problems), file=sys.stderr)
            return 1
    unlaunched = [k for k in kernels if paths["bootstrap"][k] + paths["staged bootstrap"][k] < 1]
    if unlaunched:
        print(f"FAILED bootstrap: kernels not launched by either bootstrap: {unlaunched}", file=sys.stderr)
        return 1
    print("  " + " ".join(f"{k}={v:.1f}ms" for k, v in steps.items()))

    # -- 3e. ModRaise and EvalMod at packed_bootstrap, full width -----------------
    pp = P.workload_params(PACKED["preset"])
    print(f"ModRaise and EvalMod at {PACKED['preset']} (N = {pp.n}, L = {pp.L}, dnum = {pp.dnum}, "
          f"K = {PACKED['K']}, degree {PACKED['degree']}):")
    steps = {}
    ks = timed(steps, "keygen", lambda: K.full_keyset(pp, seed=0, device=DEVICE))
    pbctx = packed_bootstrap_context(pp, ks)
    fc = FheContext(params=pp, keys=ks, device=DEVICE)
    zp = np.random.default_rng(0).normal(size=pp.slots) * 0.4
    ct = fc.level_drop(fc.mul_const(fc.encrypt(fc.encode(zp)), 1 / 64), 0)
    reset_launches()
    with dispatch.count_dispatches() as rcounts:
        raised = timed(steps, "mod_raise", lambda: fc.mod_raise(pbctx, ct))
    paths["packed mod_raise"] = raise_launched = read_launches()
    x = np.random.default_rng(3).uniform(-0.95, 0.95, pp.slots)
    xct = fc.encrypt(fc.encode(x))
    coeff_scale = 0.5 * (PACKED["K"] + 0.5) * float(pp.q_primes[0])
    eval_mod = lambda: fc.eval_mod(pbctx, xct, coeff_scale)
    reset_launches()
    with dispatch.count_dispatches() as ecounts:
        em = timed(steps, "eval_mod", eval_mod)
    paths["packed eval_mod"] = em_launched = read_launches()
    err = float(np.max(np.abs(fc.decrypt_decode(em).real - np.polynomial.chebyshev.Chebyshev(pbctx.sine_coeffs)(0.5 * x))))
    print("  " + " ".join(f"{k}={v:.1f}ms" for k, v in steps.items()))
    print(f"  mod_raise: level {raised.level} digest {digest(raised)[:16]} dispatches {dict(rcounts)}")
    print(f"  eval_mod: level {em.level} digest {digest(em)[:16]} decode err {err:.6e} "
          f"(reference {PACKED['decode_error']:.6e}) dispatches {dict(ecounts)} launches {em_launched}")
    problems = []
    if raised.level != pp.L or digest(raised) != PACKED["mod_raise"]:
        problems.append(f"mod_raise level {raised.level}, digest {digest(raised)} != reference {PACKED['mod_raise']}")
    if em.level != PACKED["eval_mod_level"] or digest(em) != PACKED["eval_mod"]:
        problems.append(f"eval_mod level {em.level}, digest {digest(em)} != reference {PACKED['eval_mod']}")
    if abs(err - PACKED["decode_error"]) > 1e-9:
        problems.append(f"eval_mod decode error {err} != reference {PACKED['decode_error']}")
    if raise_launched != launches_of(rcounts) or em_launched != launches_of(ecounts):
        problems.append(f"launches {raise_launched}, {em_launched} != dispatches")
    if min(em_launched[k] for k in mul_kernels) < 1 or ecounts.get("fusedks") != PACKED["degree"] - 1:
        problems.append(f"eval_mod launches {em_launched}, {ecounts.get('fusedks')} fused key-switches")
    if problems:
        print("FAILED packed_bootstrap path: " + "; ".join(problems), file=sys.stderr)
        return 1
    for label, fn in (("bootstrap (fused, hoisted)", boot_ctxs["bootstrap"]),
                      ("bootstrap (staged)", boot_ctxs["staged bootstrap"]),
                      (f"eval_mod at {PACKED['preset']}", eval_mod)):
        busy, wall, by_name = device_busy(fn)
        print(f"  profile {label}: device busy {busy:.3f} ms of {wall:.3f} ms wall under the profiler, "
              f"idle share {1 - busy / wall:.3f}")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        print(f"    device events {sum(by_name.values()):.3f} ms: " + ", ".join(f"{k[:40]} {v:.4f}" for k, v in top))

    # -- 3f. BGV at psi and exact_count, full width ------------------------------
    print("BGV at psi and exact_count (keygen; encode, encrypt, add, sub, negate, a·b, (a·b)·c, "
          "((a·b)·c)·a then mod_switch, decrypt, decode), fused and staged:")
    bgv_muls = {}
    for name in ("psi", "exact_count"):
        p = P.workload_params(name)
        want = BGV[name]
        steps = {}
        ks = timed(steps, "keygen", lambda: K.full_keyset(p, seed=0, device=DEVICE))
        msgs = bgv_messages(p)
        oracle = bgv_oracle(msgs, p.n, p.plain_modulus)
        print(f"  {name}: N = {p.n}, L = {p.L}, dnum = {p.dnum}, t = {p.plain_modulus}")
        for label, policy, pipeline, want_counts in (
                (f"bgv {name}", ExecPolicy(), "fused", BGV_FUSED_DISPATCHES),
                (f"staged bgv {name}", ExecPolicy(backend="staged"), "staged", BGV_STAGED_DISPATCHES)):
            ctx = FheContext(params=p, keys=ks, policy=policy, device=DEVICE)
            reset_launches()
            with dispatch.count_dispatches() as counts:
                outs, decoded = timed(steps, label, lambda: bgv_path(ctx, msgs))
            paths[label] = launched = read_launches()
            again, _ = timed(steps, f"{label} again", lambda: bgv_path(ctx, msgs))
            digests = {k: digest(v) for k, v in outs.items()}
            levels = {k: v.level for k, v in outs.items()}
            exact = {k: bool(np.array_equal(decoded[k], oracle[k])) for k in outs}
            print(f"  {label}: policy {ctx.policy_key()} pipeline={ctx.pipeline} levels {levels} oracle-exact {exact}")
            print(f"  {label}: digests " + " ".join(f"{k}={v[:12]}" for k, v in digests.items()))
            print(f"  {label}: {dispatch.total(counts)} dispatches {dict(counts)} launches {launched}")
            problems = []
            if ctx.pipeline != pipeline or ctx.scheme != "bgv":
                problems.append(f"pipeline {ctx.pipeline}, scheme {ctx.scheme}")
            if digests != want["digests"] or levels != want["levels"]:
                problems.append(f"digests {digests} (levels {levels}) != reference {want['digests']}")
            if any(digest(again[k]) != digests[k] for k in outs):
                problems.append("a second run gave other bytes")
            if not all(exact.values()):
                problems.append(f"decoded integers differ from the negacyclic oracle mod t: {exact}")
            if dict(counts) != want_counts:
                problems.append(f"dispatches {dict(counts)} != reference {want_counts}")
            if launched != launches_of(counts) or min(launched[k] for k in ("modops", "ntt")) < 1:
                problems.append(f"kernel launches {launched} != dispatches {launches_of(counts)}")
            if pipeline == "staged" and launched["bconv"] < 1:
                problems.append(f"the staged run launched no bconv: {launched}")
            if pipeline == "fused" and min(launched[k] for k in ("fused_ks", "fused_moddown")) < 1:
                problems.append(f"the fused run launched no key-switch kernel: {launched}")
            if problems:
                print(f"FAILED {label}: " + "; ".join(problems), file=sys.stderr)
                return 1
            if pipeline == "fused":
                a, b, _ = (ctx.encrypt(ctx.encode(z), seed=s) for z, s in zip(msgs, (1, 2, 3)))
                bgv_muls[name] = (ctx, a, b)
        print(f"  {name}: " + " ".join(f"{k}={v:.1f}ms" for k, v in steps.items()))
    for name, (ctx, a, b) in bgv_muls.items():
        busy, wall, by_name = device_busy(lambda: ctx.mul(a, b))
        mul_ms = time_ms(lambda: ctx.mul(a, b), iters=10, warmup=2)
        print(f"  profile BGV ctx.mul at {name}: {mul_ms:.3f} ms a mul (CUDA events, host included); device busy "
              f"{busy:.3f} ms of {wall:.3f} ms wall under the profiler, idle share {1 - busy / wall:.3f}")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        print(f"    device events {sum(by_name.values()):.3f} ms: " + ", ".join(f"{k[:40]} {v:.4f}" for k, v in top))

    # -- 3g. the executor: one shallow job per affiliation, one CUDA stream each --
    p = P.workload_params(EXECUTOR["preset"])
    n_jobs, n_aff = EXECUTOR["jobs"], EXECUTOR["affiliations"]
    print(f"executor: {n_jobs} jobs of ctx.mul at {EXECUTOR['preset']} over {n_aff} affiliations, "
          "one CUDA stream each:")
    ks = keysets[EXECUTOR["preset"]]
    ctx = FheContext(params=p, keys=ks, policy=ExecPolicy(backend="ref"), device=DEVICE)
    pairs = executor_pairs(ctx)
    with dispatch.count_dispatches() as one:
        ctx.mul(*pairs[0])
    lone = [digest(ctx.mul(*pr)) for pr in pairs]  # each job alone, on the default stream
    # every table dropped: the first fan-out builds what it reads on the side
    # streams, each table complete before any stream reads it (kernels.tables)
    tables.clear()
    streams = E.affiliation_streams(n_aff, DEVICE)
    run8 = lambda: E.parallel_shallow_mul(p, ks, pairs, streams, DEVICE)
    one_stream = E.affiliation_streams(1, DEVICE)
    run1 = lambda: E.parallel_shallow_mul(p, ks, pairs, one_stream, DEVICE)
    steps = {}
    reset_launches()
    with dispatch.count_dispatches() as counts:
        outs = timed(steps, f"{n_jobs} jobs on {n_aff} streams (first)", run8)
    paths[f"executor {n_jobs} jobs"] = launched = read_launches()
    cold_builds = tables.builds()
    for i, (label, fn) in enumerate(((f"{n_aff} streams", run8), ("1 stream", run1), ("1 stream", run1),
                                     (f"{n_aff} streams", run8))):
        timed(steps, f"{n_jobs} jobs on {label} #{i + 1}", fn)  # in turns
    digests = [digest(o) for o in outs]
    by_stream = kernel_streams(run8, ROOT / "build" / "executor_trace.json")
    print("  " + " ".join(f"{k}={v:.1f}ms" for k, v in steps.items()))
    print(f"  levels {sorted({o.level for o in outs})} digests " + " ".join(d[:12] for d in digests))
    print(f"  dispatches {dict(counts)} (one staged ctx.mul: {dict(one)}) launches {launched}")
    print(f"  kernels by CUDA stream (profiler trace): {dict(sorted(by_stream.items()))}; "
          f"table builds in the first fan-out: {cold_builds}, in the later ones: {tables.builds() - cold_builds}")
    problems = []
    if digests != list(EXECUTOR["digests"]) or digests[0] != REFERENCE["matmul"]["digest"]:
        problems.append(f"digests {digests} != reference {list(EXECUTOR['digests'])}")
    if digests != lone:
        problems.append(f"digests {digests} != the lone ctx.muls' {lone}")
    if dict(one) != STAGED_MUL_DISPATCHES["matmul"] or dict(counts) != {k: n_jobs * v for k, v in one.items()}:
        problems.append(f"dispatches {dict(counts)} != {n_jobs} × {dict(one)}")
    if launched != launches_of(counts) or min(launched[k] for k in ("modops", "ntt", "bconv")) < 1:
        problems.append(f"kernel launches {launched} != dispatches {launches_of(counts)}")
    if cold_builds == 0:
        problems.append("the first fan-out built no table")
    if tables.builds() != cold_builds:
        problems.append(f"the later fan-outs built {tables.builds() - cold_builds} tables")
    if len(by_stream) < n_aff:
        problems.append(f"kernels ran on {len(by_stream)} CUDA streams, not ≥ {n_aff}: {by_stream}")
    if problems:
        print("FAILED executor: " + "; ".join(problems), file=sys.stderr)
        return 1
    for label, fn in ((f"{n_jobs} jobs on {n_aff} streams", run8), (f"{n_jobs} jobs on 1 stream", run1)):
        busy, wall, by_name = device_busy(fn)
        print(f"  profile {label}: device busy {busy:.3f} ms of {wall:.3f} ms wall under the profiler, "
              f"idle share {1 - busy / wall:.3f}")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"    device events {sum(by_name.values()):.3f} ms: " + ", ".join(f"{k[:40]} {v:.4f}" for k, v in top))

    # -- 3h. the planner against the card's traces; traced multiply; scheduling --
    if phase_3h(kernels, paths, launches_of, (group_ctx, group_ct), (mlp_ctx, mlp_ct, plan1), bgv_muls["psi"],
                bgv_muls["exact_count"][:2], mul_ctxs[TRACED_MUL["preset"]], smi):
        return 1

    # -- 3i. the LLM serving path ----------------------------------------------
    if phase_3i(paths, reset_launches, read_launches, smi):
        return 1

    # -- 3j. the training path ---------------------------------------------------
    if phase_3j(paths, reset_launches, read_launches, smi):
        return 1

    # -- 3k. sharding: the sharded step, the dry-run, the lowered multi-job step ---
    if phase_3k(paths, reset_launches, read_launches, smi, keysets[EXECUTOR["preset"]]):
        return 1

    # -- 4. report ---------------------------------------------------------------
    # launches: from the path that carries the kernel at the lstm shape of its first case
    home = {"bconv": "staged mul lstm", "hoist_modup": "lstm group", "hoist_mac": "lstm group", "bsgs_mac": "mlp"}
    rows = []
    for kname, v in kernels.items():
        head = v["cases"][0]  # the lstm shape its path gives the kernel
        rows.append(dict(
            name=kname, route="cuda", source=v["source"], replaces=v["replaces"],
            launches=paths[home.get(kname, "mul lstm")][kname], max_abs_err=max(c["max_abs_err"] for c in v["cases"]),
            ms=head["kernel_ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=None, exact=all(c["exact"] for c in v["cases"]), kernel_ms=head["kernel_ms"],
            blocks_per_pass=head.get("blocks_per_pass"), grid=head.get("grid"),
            call_ms=head["call_ms"], shape=head["case"], launches_path=home.get(kname, "mul lstm"),
            launches_by_path={path: launches[kname] for path, launches in paths.items()}, cases=v["cases"],
        ))
    print("no single PyTorch call computes any of these functions: library_ms is null")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
