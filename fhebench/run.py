"""Run one cell of the port's benchmark once and print its result line.

    python3 fhebench/run.py --workload lola_mnist.infer --seed 7 --seconds 45 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, ``fhebench/`` and the
port under ``src/``.  It needs as many CUDA cards as the cell asks for and exits
with another code than 0, printing no result, without them or without the port.
The kernel libraries build once into ``build/repro_torch/`` of the checkout;
other compile caches are kept under ``build/fhebench/``.  The last lines on
standard error are the numbers compared with their limits; the last line on
standard output is the result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"  # one host thread: the window's host work is one thread's, with no pool to wake
    cache = ROOT / "build" / "fhebench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(cache / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    torch.set_num_threads(1)
    from fhebench import harness

    result = harness.run_cell(args.workload, bench, args.seed, args.seconds, bool(args.trace), T0)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
