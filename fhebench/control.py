"""The controls of a cell at the cell's own size: the reference's own answers put
in the program's place (``check.CONTROLS``: float64 residue products; an
encryption at Δ = 2^24 labelled so; the same labelled with the stated scale),
judged by the cell's comparison on several seeds.  It needs no card and runs
nothing of the program; the benchmark's runs never run it.

    python3 fhebench/control.py --workload packed_bootstrap.evalmod --seeds 11 12 13
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from fhebench import check, harness, inputs

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    _, cfg, mix, limits = harness.cell(args.workload, bench)
    for seed in args.seeds:
        ins = inputs.make(cfg, mix, seed)
        for kind in check.CONTROLS:
            answers = check.control_answers(cfg, mix, ins, np.random.default_rng(seed), kind)
            v = check.judge(cfg, mix, ins, answers, limits["max_err"])
            correct = v["max_err"] <= limits["max_err"] and v["meta_mismatch"] <= limits["meta_mismatch"]
            print(json.dumps(dict(workload=args.workload, seed=seed, control=kind, max_err=v["max_err"],
                                  meta_mismatch=v["meta_mismatch"], judged=v["judged"], bad=len(v["bad"]),
                                  correct=bool(correct), limit=limits["max_err"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
