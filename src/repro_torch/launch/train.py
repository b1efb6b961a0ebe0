"""End-to-end training launcher.

Trains a config (reduced with --smoke, the default) on one device: the train
step (``training.train_step``), checkpoint/restore (resume-safe),
heartbeat bookkeeping, and the deterministic data pipeline.  Runs on the
CUDA card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --smoke \
      --steps 200 --batch 16 --seq 128 --ckpt-dir /tmp/ckpt

Parameters come from the port's ``init_params(0)`` (a ``torch.Generator``,
not ``jax.random``).  The VLM's patches and whisper's frames, which the
byte corpus does not give, are drawn from numpy seeded by the step.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import failures, manager
from repro_torch.data import pipeline
from repro_torch.models import registry
from repro_torch.models.convert import params_from_reference, tree_from_reference
from repro_torch.models.lm import resolve_device
from repro_torch.training import optimizer as opt, train_step as ts


def batch_at(cfg, corpus: pipeline.ByteCorpus, step: int, batch: int, seq: int, device) -> dict:
    """Step ``step``'s batch on ``device``: ``seq`` + 1 corpus tokens a row, and
    the multimodal archs' patches or frames from numpy seeded by the step."""
    out = {"tokens": corpus.batch(seed=0, step=step, batch=batch, seq=seq)}
    rng = np.random.default_rng((0, step))
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal((batch, cfg.n_patches, cfg.d_model), dtype=np.float32)
    elif cfg.family == "audio":
        out["frames"] = rng.standard_normal((batch, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}


def run(arch: str, smoke: bool, steps: int, batch: int, seq: int,
        ckpt_dir: str | None, ckpt_every: int = 50, lr: float = 3e-3,
        microbatch: int = 0, log_every: int = 10, device="cuda") -> dict:
    dev = resolve_device(device)
    cfg = configs.get_config(arch, smoke=smoke)
    api = registry.build(cfg)
    acfg = opt.AdamWConfig(lr_peak=lr, warmup_steps=max(5, steps // 20),
                           total_steps=steps)

    corpus = pipeline.ByteCorpus(vocab=cfg.vocab)
    monitor = failures.HeartbeatMonitor(n_hosts=1)

    start_step = 0
    params = state = None
    if ckpt_dir and manager.latest_step(ckpt_dir) is not None:
        start_step, tree = manager.restore(ckpt_dir)
        params = params_from_reference(cfg, tree["params"], dev)
        state = {k: tree_from_reference(cfg, tree["opt"][k], dev) for k in ("m", "v")}
        state["step"] = torch.tensor(int(tree["opt"]["step"]), dtype=torch.int32, device=dev)
        print(f"[train] resumed from step {start_step}")
    if params is None:
        params = api.init_params(0, device=dev)
        state = opt.init_state(params)

    step_fn = ts.build_train_step(api, None, acfg, microbatch=microbatch)

    hist = []
    t0 = time.time()
    for step in range(start_step, steps):
        params, state, metrics = step_fn(params, state, batch_at(cfg, corpus, step, batch, seq, dev))
        loss = float(metrics["loss"])
        hist.append(loss)
        monitor.beat(0, now=time.time() - t0, step_time=0.0)
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            manager.save(ckpt_dir, step + 1, {"params": params, "opt": state})
    if ckpt_dir:
        manager.save(ckpt_dir, steps, {"params": params, "opt": state})
    return {"first_loss": hist[0], "final_loss": float(np.mean(hist[-10:])),
            "history": hist, "params": params}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list(configs.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.arch, args.smoke, args.steps, args.batch, args.seq,
              args.ckpt_dir, lr=args.lr, microbatch=args.microbatch, device=args.device)
    print(f"[train] loss {out['first_loss']:.3f} → {out['final_loss']:.3f}")
    return out


if __name__ == "__main__":
    main()
