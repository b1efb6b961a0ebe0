"""Serving driver: batched generation with the reduced (--smoke) or full config.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m --full \
      --batch 4 --prompt-len 16 --tokens 32

Runs on the CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.models import registry
from repro_torch.serving.engine import Engine, SamplerConfig


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list(configs.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch, smoke=args.smoke)
    api = registry.build(cfg)
    params = api.init_params(0, device=args.device)
    eng = Engine(api, params, batch=args.batch, max_seq=args.max_seq, device=args.device)
    prompts = pipeline.synthetic_lm_batch(0, 0, args.batch, args.prompt_len - 1, cfg.vocab)
    extra = {}
    gen = torch.Generator().manual_seed(1)
    if cfg.family == "vlm":
        extra["patches"] = torch.randn((args.batch, cfg.n_patches, cfg.d_model), generator=gen)
    if cfg.family == "audio":
        extra["frames"] = torch.randn((args.batch, cfg.enc_seq, cfg.d_model), generator=gen)
    out = eng.generate(prompts, args.tokens, SamplerConfig(temperature=args.temperature), **extra)
    print(f"[serve] arch={cfg.arch_id} generated {out.shape} tokens on {eng.device}")
    print(out[:, :16])
    return out


if __name__ == "__main__":
    main()
