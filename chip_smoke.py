#!/usr/bin/env python3
"""Drive the ``repro_torch`` port on one CUDA card and check it end to end.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. print the card's name and power limit, then build every CUDA kernel of
     ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at once);
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the CKKS multiply gives it for the ``lstm`` (N = 2^16) and
     ``matmul`` (N = 2^13) presets: bit-exact, launched, timed with CUDA events;
  3. run the main path for both presets through the public API — keygen,
     encode, encrypt, ``ctx.mul`` (fused key-switch), decrypt, decode — and
     check the ciphertext's SHA-256 against the reference package's, the decode
     error, the dispatch counts, and that every dispatch launched a kernel;
  4. print one JSON line of per-kernel numbers, then the result line.

It needs one CUDA card, ``nvcc`` and the repository's ``src/`` beside it.
"""

from __future__ import annotations

import hashlib
import json
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

# H100 SXM peaks (NVIDIA data sheet): memory rate, and the non-tensor float32
# rate, against which the kernels' integer operations are counted.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
MONTMUL, MULMOD, ADDMOD = 8, 16, 3  # integer operations per modular op
WORD = 4
SLEEP_CYCLES = 20_000_000  # ~10 ms at the H100's 1.98 GHz boost clock


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def ntt_ops_per_limb(n: int) -> int:
    return (n // 2) * (n.bit_length() - 1) * (MONTMUL + 2 * ADDMOD) + n * MONTMUL


def time_ms(fn, iters: int = 20, warmup: int = 3, hide_host: bool = False) -> float:
    """Mean milliseconds per call between CUDA events around ``iters`` calls.

    With ``hide_host`` the stream first spins ~10 ms (``torch.cuda._sleep``),
    so the host has queued every launch before the start event runs and the
    events time the device alone.  Without it, a call's host overhead counts.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hide_host:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    from repro_torch.fhe import keys as K
    from repro_torch.fhe import params as P
    from repro_torch.fhe import poly
    from repro_torch.fhe.context import ExecPolicy, FheContext
    from repro_torch.kernels import cuda, dispatch
    from repro_torch.kernels.fusedks import ops as fops
    from repro_torch.kernels.fusedks import ref as fref
    from repro_torch.kernels.modops import ops as mops
    from repro_torch.kernels.modops import ref as mref
    from repro_torch.kernels.ntt import ops as nops
    from repro_torch.kernels.ntt import ref as nref

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
    }
    for v in kernels.values():
        v["cases"] = []

    # -- 2. every kernel against its plain version, at the main path's shapes ---
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    failures = []

    def check(kname, case, kernel_fn, plain_fn, nbytes, ops):
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
        bms, by = bound(nbytes, ops)
        rec = dict(case=case, exact=exact, max_abs_err=err, launched=launched, kernel_ms=kms, call_ms=call_ms,
                   plain_ms=pms, bound_ms=bms, bound_by=by)
        kernels[kname]["cases"].append(rec)
        print(f"  {kname:14s} {case:40s} exact={exact} launched={launched} kernel {kms:.4f} ms "
              f"call {call_ms:.4f} ms plain {pms:.3f} ms bound {bms:.4f} ms ({by})")
        if not exact or launched < 1:
            failures.append(f"{kname} {case}")

    print("kernels vs plain versions:")
    for name in ("lstm", "matmul"):
        p = P.workload_params(name)
        n, lv, alpha, beta = p.n, p.L, p.alpha, p.beta(p.L)
        nq, m = lv + 1, lv + 1 + alpha
        qp = poly.primes_for(p, poly.q_idx(p, lv))
        pp = poly.primes_for(p, poly.p_idx(p))
        ext = poly.primes_for(p, poly.ext_idx(p, lv))
        a, b = rand_residues((nq, n), qp, gen), rand_residues((nq, n), qp, gen)
        for op, kfn, pfn, opc in (("mul", mops.pointwise_mulmod, mref.mulmod_ref, MULMOD),
                                  ("add", mops.pointwise_addmod, mref.addmod_ref, ADDMOD),
                                  ("sub", mops.pointwise_submod, mref.submod_ref, ADDMOD)):
            check("modops", f"{name} {op} ({nq}, {n})", lambda: kfn(a, b, qp), lambda: pfn(a, b, qp),
                  3 * nq * n * WORD, nq * n * opc)
        qplan, pplan = poly.plan_for(p, poly.q_idx(p, lv)), poly.plan_for(p, poly.p_idx(p))
        xp = rand_residues((2, alpha, n), pp, gen)
        for inv, kfn, pfn in ((False, nops.ntt_fwd, nref.ntt_fwd_ref), (True, nops.ntt_inv, nref.ntt_inv_ref)):
            tag = "inv" if inv else "fwd"
            for x, plan, rows, l in ((a, qplan, nq, nq), (xp, pplan, 2 * alpha, alpha)):
                check("ntt", f"{name} {tag} {tuple(x.shape)}", lambda: kfn(x, plan), lambda: pfn(x, plan),
                      (2 * rows + 2 * l) * n * WORD, rows * ntt_ops_per_limb(n))
        d = rand_residues((nq, n), qp, gen)
        ksk = rand_residues((beta, 2, m, n), ext, gen)
        ks_ops = m * sum(n * len(p.digit(j)) * (2 * MONTMUL + ADDMOD) + ntt_ops_per_limb(n)
                         + 2 * n * (MULMOD + ADDMOD) for j in range(beta))
        check("fused_ks", f"{name} beta={beta} ksk {tuple(ksk.shape)}",
              lambda: fops.key_switch_digits(d, ksk, p, lv), lambda: fref.key_switch_digits_ref(d, ksk, p, lv),
              (nq + 2 * beta * m + 2 * m + 2 * m) * n * WORD, ks_ops)
        qpart = rand_residues((2, nq, n), qp, gen)
        md_ops = 2 * nq * (n * alpha * (2 * MONTMUL + ADDMOD) + ntt_ops_per_limb(n) + n * (ADDMOD + MONTMUL))
        check("fused_moddown", f"{name} pc {tuple(xp.shape)} q {tuple(qpart.shape)}",
              lambda: fops.mod_down_digits(xp, qpart, p, lv), lambda: fref.mod_down_digits_ref(xp, qpart, p, lv),
              (2 * alpha + 2 * nq + 2 * nq + 2 * nq) * n * WORD, md_ops)
    if failures:
        print("FAILED kernel checks: " + ", ".join(failures), file=sys.stderr)
        return 1

    # -- 3. the main path, through the public API --------------------------------
    print("main path (keygen, encode, encrypt, ctx.mul, decrypt, decode):")
    main_launches = {}
    for name in ("matmul", "lstm"):
        p = P.workload_params(name)
        for v in kernels.values():
            v["k"].launches = 0
        steps = {}

        def step(label, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            steps[label] = (time.perf_counter() - t) * 1e3
            return out

        ks = step("keygen", lambda: K.full_keyset(p, seed=0, device=DEVICE))
        ctx = FheContext(params=p, keys=ks, policy=ExecPolicy(), device=DEVICE)
        z = np.random.default_rng(0).normal(size=p.slots) * 0.4
        pt = step("encode", lambda: ctx.encode(z))
        ct = step("encrypt", lambda: ctx.encrypt(pt))
        before = {k: v["k"].launches for k, v in kernels.items()}
        with dispatch.count_dispatches() as counts:
            out = step("mul", lambda: ctx.mul(ct, ct))
        mul_launches = {k: v["k"].launches - before[k] for k, v in kernels.items()}
        again = step("mul again", lambda: ctx.mul(ct, ct))  # tables are built: steady state
        dec = step("decrypt", lambda: ctx.decrypt(out))
        got = step("decode", lambda: ctx.decode(dec))
        main_launches[name] = {k: v["k"].launches for k, v in kernels.items()}

        digest = hashlib.sha256(out.c0.cpu().numpy().astype("<u4").tobytes()
                                + out.c1.cpu().numpy().astype("<u4").tobytes()).hexdigest()
        err = float(np.max(np.abs(got - z * z)))
        ref = REFERENCE[name]
        print(f"  {name}: pipeline={ctx.pipeline} " + " ".join(f"{k}={v:.1f}ms" for k, v in steps.items()))
        print(f"  {name}: digest {digest[:16]} decode err {err:.3e} dispatches {dict(counts)}")
        print(f"  {name}: kernel launches in ctx.mul {mul_launches}, in the whole path {main_launches[name]}")
        expected_launches = {
            "modops": counts.get("mulmod", 0) + counts.get("addmod", 0) + counts.get("submod", 0),
            "ntt": counts.get("ntt", 0) + counts.get("intt", 0),
            "fused_ks": counts.get("fusedks", 0),
            "fused_moddown": counts.get("fused_moddown", 0),
        }
        problems = []
        if ctx.pipeline != "fused":
            problems.append(f"pipeline {ctx.pipeline}")
        if digest != ref["digest"]:
            problems.append(f"digest {digest} != reference {ref['digest']}")
        if not err < ref["max_err"]:
            problems.append(f"decode error {err} ≥ {ref['max_err']}")
        if not (torch.equal(again.c0, out.c0) and torch.equal(again.c1, out.c1)):
            problems.append("a second ctx.mul gave other bytes")
        if dict(counts) != FUSED_MUL_DISPATCHES:
            problems.append(f"dispatches {dict(counts)} != {FUSED_MUL_DISPATCHES}")
        if mul_launches != expected_launches:
            problems.append(f"kernel launches {mul_launches} != dispatches {expected_launches}")
        if min(main_launches[name].values()) < 1:
            problems.append(f"a kernel was not launched: {main_launches[name]}")
        if problems:
            print(f"FAILED main path {name}: " + "; ".join(problems), file=sys.stderr)
            return 1

    # -- 4. report ---------------------------------------------------------------
    rows = []
    for kname, v in kernels.items():
        head = v["cases"][0]  # the lstm shape the main path gives the kernel
        rows.append(dict(
            name=kname, route="cuda", source=v["source"], replaces=v["replaces"],
            launches=main_launches["lstm"][kname], max_abs_err=max(c["max_abs_err"] for c in v["cases"]),
            ms=head["kernel_ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=None, exact=all(c["exact"] for c in v["cases"]), kernel_ms=head["kernel_ms"],
            call_ms=head["call_ms"],
            shape=head["case"], launches_matmul=main_launches["matmul"][kname], cases=v["cases"],
        ))
    print("no single PyTorch call computes any of these functions: library_ms is null")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
