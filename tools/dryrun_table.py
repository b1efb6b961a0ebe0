"""Print the dry-run records of a directory as tables: seconds per cell, and
the 16×16 roofline (compute, memory and collective seconds, dominant term).

  python tools/dryrun_table.py experiments/dryrun_torch

The roofline models the reference's TPU pod mesh with one H100's rates
(``repro_torch.core.hardware``); it is not a measurement.
"""

import glob
import json
import os
import sys


def main(out_dir: str) -> None:
    recs = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    print("| arch | shape | mesh | status | step s | FLOPs | useful | collective B | per-rank peak GiB |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in recs:
        if r.get("status") != "ok":
            print(f"| {r['arch']} | {r['shape']} | {r.get('mesh', '')} | {r.get('status')} | | | | | |")
            continue
        peak = r["memory"].get("bytes_per_device")
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | {r['lower_s']} | {r['flops']:.4g} | "
              f"{r['useful_flops_ratio']:.3f} | {r['coll_bytes_total']:.4g} | "
              f"{'' if peak is None else f'{peak / 2**30:.1f}'} |")
    print()
    print("| arch | shape | compute s | memory s | collective s | dominant |")
    print("|---|---|---|---|---|---|")
    for r in recs:
        if r.get("status") == "ok" and r["mesh"] == "16x16":
            rl = r["roofline"]
            print(f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.3e} | {rl['memory_s']:.3e} | "
                  f"{rl['collective_s']:.3e} | {rl['dominant']} |")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch")
