"""The sharded train step's gap to the one-device step, as
``tests/test_torch_sharded_step.py`` holds it: four gloo ranks on a 2×2
("data", "model") mesh against one device on the CPU, SMOKE config, seed 0.

Prints, for each arch and activation dtype: the loss and gradient-norm gaps,
the least per-leaf gradient correlation, ``chip_smoke.update_gap`` (the
AdamW update in units of lr where no near-tie, and over every weight), and
for a MoE arch the smallest top-k margin of the router's probabilities of
each MoE layer on one device (where bf16 rounding can move a token across).

  PYTHONPATH=src python tools/sharded_gap.py [ARCH ...]   # default smollm-135m deepseek-moe-16b
"""

import importlib.util
import pathlib
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(archs) -> None:
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.training import optimizer as opt

    t = _load("test_torch_sharded_step", ROOT / "tests" / "test_torch_sharded_step.py")
    smoke = t._chip_smoke()
    for arch in archs:
        moe = configs.get_config(arch).is_moe
        dtypes = "bf16,f32" if moe else "bf16"
        with tempfile.TemporaryDirectory() as d:
            (run,) = t._run(pathlib.Path(d), 4, arch, "tp", dtypes)
        for dtype in dtypes.split(","):
            pre = "" if dtype == "bf16" else dtype + "/"
            lm.BF16 = torch.float32 if dtype == "f32" else torch.bfloat16
            probs, orig = [], L.moe_ffn

            def record(*a, **k):
                out, p = orig(*a, **k)
                probs.append(p.detach())
                return out, p

            L.moe_ffn = record
            try:
                params, grads, new, metrics, acfg = t._one_device(arch)
            finally:
                L.moe_ffn, lm.BF16 = orig, torch.bfloat16
            ref_g = [g.numpy() for g in opt.tree_leaves(grads)]
            got_g = [run[f"{pre}grads/{i}"] for i in range(len(ref_g))]
            ref_p = [p.detach().numpy() for p in opt.tree_leaves(new)]
            got_p = [run[f"{pre}params/{i}"] for i in range(len(ref_p))]
            w0 = [p.detach().numpy() for p in opt.tree_leaves(params)]
            loss, gnorm, _ = run[f"{pre}metrics"]
            corr = min(float(np.corrcoef(a.ravel(), b.ravel())[0, 1]) for a, b in zip(ref_g, got_g)
                       if a.size > 1 and a.std() > 0)
            gap = smoke.update_gap(w0, ref_p, got_p, ref_g, float(opt.lr_at(acfg, 0)))
            line = (f"{arch} {dtype}: loss |d| {abs(loss - float(metrics['loss'])):.3g}, grad_norm rel "
                    f"{abs(gnorm - float(metrics['grad_norm'])) / float(metrics['grad_norm']):.3g}, min leaf corr "
                    f"{corr:.7f}, update gap {gap['kept']:.3g} lr where no near-tie ({gap['share']:.3f} of weights), "
                    f"{gap['all']:.4g} lr over all")
            if moe:
                k = configs.get_config(arch, smoke=True).top_k
                margins = []
                for p in probs[:configs.get_config(arch, smoke=True).n_layers]:  # the step's forward
                    top = torch.sort(p, dim=-1, descending=True).values
                    margins.append(float((top[:, k - 1] - top[:, k]).min()))
                line += ", top-k margin per layer " + " ".join(f"{m:.3g}" for m in margins)
            print(line, flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    main(sys.argv[1:] or ["smollm-135m", "deepseek-moe-16b"])
