"""Unified model API over the LM families.

ModelApi exposes what the launcher and the engine need:
  init_params / train_loss / prefill / decode_step / init_cache
with a kwargs convention: multimodal inputs (patches, frames) ride alongside
tokens.  ``prefill`` and ``decode_step`` run without autograd; all three
forward entries run under ``layers.reference_precision()``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from . import layers as L
from . import lm, vlm, whisper
from .config import ModelConfig

# The four canonical input shapes (per-arch cells).  LM shapes are
# (seq_len, global_batch); decode shapes run the decode step with a KV cache.
SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig
    init_params: Callable  # (key, device="cuda") -> ParamTree
    train_loss: Callable  # (params, **batch) -> scalar
    prefill: Callable  # (params, cache, **batch) -> (logits, cache)
    decode_step: Callable  # (params, token, cache) -> (logits, cache)
    init_cache: Callable  # (batch, max_seq, device="cuda") -> cache dict

    def supports_shape(self, shape_name: str) -> tuple[bool, str]:
        SHAPES[shape_name]  # KeyError for an unknown shape
        if shape_name == "long_500k" and not self.cfg.supports_long_context():
            return False, "O(S²) full attention at S=524288 is not a real configuration"
        return True, ""


def _forward(fn: Callable, grad: bool) -> Callable:
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with torch.set_grad_enabled(grad and torch.is_grad_enabled()), L.reference_precision():
            return fn(*args, **kwargs)

    return run


def build(cfg: ModelConfig) -> ModelApi:
    if cfg.family == "audio":
        mod = whisper
        loss = lambda params, **kw: whisper.train_loss(cfg, params, kw["frames"], kw["tokens"])
        pre = lambda params, cache, **kw: whisper.prefill(cfg, params, kw["frames"], kw["tokens"], cache)
    elif cfg.family == "vlm":
        mod = vlm
        loss = lambda params, **kw: vlm.train_loss(cfg, params, kw["tokens"], kw["patches"])
        pre = lambda params, cache, **kw: vlm.prefill(cfg, params, kw["tokens"], kw["patches"], cache)
    else:
        mod = lm
        loss = lambda params, **kw: lm.train_loss(cfg, params, kw["tokens"])
        pre = lambda params, cache, **kw: lm.prefill(cfg, params, kw["tokens"], cache)
    return ModelApi(
        cfg=cfg,
        init_params=lambda key, device="cuda": mod.init_params(cfg, key, device),
        train_loss=_forward(loss, grad=True),
        prefill=_forward(pre, grad=False),
        decode_step=_forward(lambda params, token, cache: mod.decode_step(cfg, params, token, cache), grad=False),
        init_cache=lambda batch, max_seq, device="cuda": mod.init_cache(cfg, batch, max_seq, device),
    )
