#!/usr/bin/env python3
"""Time the port's ``bconv`` kernel of a checkout at the shapes where it runs.

    python3 bench_bconv.py [--tree DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds its
``bconv.cu`` there, and times ``bconv`` with CUDA events, host hidden, at the
staged key-switch's shapes (``lstm``, ``matmul``, ``lola_mnist_plain``) and
where BConv is large: the dnum = 1 preset ``packed_bootstrap`` (ModUp 58 → 116
and ModDown 58 → 58 limbs) and ``logreg`` (17 → 51), all at the presets' own
N.  Each case is checked bit-exact against the plain version first.  The API
it calls, ``bconv(xhat, w, cs)``, is the same in every slice of the port, so
two checkouts can be timed in turns on one card.  Prints the card's name and
power limit, then one JSON line.  Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

CASES = (("lstm", False), ("lstm", True), ("matmul", False), ("lola_mnist_plain", False),
         ("packed_bootstrap", False), ("packed_bootstrap", True), ("logreg", False))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).resolve().parent))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_bconv: no CUDA card", file=sys.stderr)
        return 2
    src = pathlib.Path(args.tree).resolve() / "src"
    if not (src / "repro_torch").is_dir():
        print(f"bench_bconv: {src} holds no repro_torch", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.fhe import params as P
    from repro_torch.fhe import poly, rns
    from repro_torch.kernels import cuda
    from repro_torch.kernels.bconv import ops as bops
    from repro_torch.kernels.bconv import ref as bref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    cuda.build_all(("bconv.cu",))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for name, moddown in CASES:
        p = P.workload_params(name)
        n, lv = p.n, p.L
        if moddown:  # ModDown's P → q
            src_p, dst = poly.primes_for(p, poly.p_idx(p)), poly.primes_for(p, poly.q_idx(p, lv))
        else:  # digit 0 → the extended basis
            src_p = poly.primes_for(p, tuple(i for i in p.digit(0) if i <= lv))
            dst = poly.primes_for(p, poly.ext_idx(p, lv))
        _, w = rns.bconv_tables(src_p, dst)
        q = torch.tensor(src_p, dtype=torch.int64, device="cuda")[:, None]
        x = (torch.randint(0, 1 << 31, (len(src_p), n), generator=gen, device="cuda", dtype=torch.int64) % q).int()
        exact = torch.equal(bops.bconv(x, w, dst), bref.bconv_ref(x, w, dst))
        for _ in range(3):
            bops.bconv(x, w, dst)
        torch.cuda.synchronize()
        iters = 50
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # the host queues every launch before the start event runs
        start.record()
        for _ in range(iters):
            bops.bconv(x, w, dst)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
        rows.append(dict(case=f"{name} ({len(src_p)}, {n}) -> ({len(dst)}, {n})", exact=exact, kernel_ms=ms))
        print(f"  {args.label} {rows[-1]['case']:40s} exact={exact} kernel {ms:.4f} ms")
    print(json.dumps({"label": args.label, "tree": str(args.tree), "bconv": rows}))
    return 0 if all(r["exact"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
