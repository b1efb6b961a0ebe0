"""Unified model API over the LM families.

ModelApi exposes what the launchers, the engine and the dry-run need:
  init_params / init_tree / param_specs / train_loss / prefill / decode_step /
  init_cache / cache_specs / input_specs(shape_name, mesh)
with a kwargs convention: multimodal inputs (patches, frames) ride alongside
tokens, and every input_specs entry has a (shape, dtype) and a ``Spec``.
``prefill`` and ``decode_step`` run without autograd; all three forward
entries run under ``layers.reference_precision()``, and with a ``mesh``
under ``sharding.sharded_run()`` (plain tensors beside DTensors read as
replicated).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import Spec

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
    init_tree: Callable  # (key) -> init_params' tree as dicts and lists of CPU (or fake) tensors
    param_specs: Callable  # (mesh) -> spec tree in init_params' structure
    train_loss: Callable  # (params, mesh=None, **batch) -> scalar
    prefill: Callable  # (params, cache, mesh=None, **batch) -> (logits, cache)
    decode_step: Callable  # (params, token, cache, mesh=None) -> (logits, cache)
    init_cache: Callable  # (batch, max_seq, device="cuda") -> cache dict
    cache_specs: Callable  # (mesh) -> spec dict

    def supports_shape(self, shape_name: str) -> tuple[bool, str]:
        SHAPES[shape_name]  # KeyError for an unknown shape
        if shape_name == "long_500k" and not self.cfg.supports_long_context():
            return False, "O(S²) full attention at S=524288 is not a real configuration"
        return True, ""

    def input_specs(self, shape_name: str, mesh) -> dict:
        """{name: ((shape, dtype), Spec)} of the step's inputs at ``shape_name``."""
        info = SHAPES[shape_name]
        cfg = self.cfg
        b, s = info["batch"], info["seq"]
        dp = sh.dp_axes(mesh) or None
        extra = 1 if info["kind"] == "train" else 0
        out: dict[str, Any] = {}
        if info["kind"] == "decode":
            out["token"] = (((b,), torch.int32), Spec(dp))
        elif cfg.family == "vlm":
            out["tokens"] = (((b, s - cfg.n_patches + extra), torch.int32), Spec(dp))
            out["patches"] = (((b, cfg.n_patches, cfg.d_model), torch.bfloat16), Spec(dp, None, None))
        elif cfg.family == "audio":
            out["frames"] = (((b, cfg.enc_seq, cfg.d_model), torch.bfloat16), Spec(dp, None, None))
            out["tokens"] = (((b, s - cfg.enc_seq + extra), torch.int32), Spec(dp))
        else:
            out["tokens"] = (((b, s + extra), torch.int32), Spec(dp))
        return out


def _forward(fn: Callable, grad: bool) -> Callable:
    @functools.wraps(fn)
    def run(params, *args, mesh=None, **kwargs):
        if mesh is None:
            sharded = contextlib.nullcontext()
        else:
            sharded, params = sh.sharded_run(), sh.Gathered(params, mesh)
        with torch.set_grad_enabled(grad and torch.is_grad_enabled()), L.reference_precision(), sharded:
            return fn(params, *args, mesh=mesh, **kwargs)

    return run


def build(cfg: ModelConfig) -> ModelApi:
    if cfg.family == "audio":
        mod = whisper
        loss = lambda params, mesh, **kw: whisper.train_loss(cfg, params, kw["frames"], kw["tokens"], mesh)
        pre = lambda params, cache, mesh, **kw: whisper.prefill(cfg, params, kw["frames"], kw["tokens"], cache,
                                                                mesh)
    elif cfg.family == "vlm":
        mod = vlm
        loss = lambda params, mesh, **kw: vlm.train_loss(cfg, params, kw["tokens"], kw["patches"], mesh)
        pre = lambda params, cache, mesh, **kw: vlm.prefill(cfg, params, kw["tokens"], kw["patches"], cache, mesh)
    else:
        mod = lm
        loss = lambda params, mesh, **kw: lm.train_loss(cfg, params, kw["tokens"], mesh)
        pre = lambda params, cache, mesh, **kw: lm.prefill(cfg, params, kw["tokens"], cache, mesh)
    return ModelApi(
        cfg=cfg,
        init_params=lambda key, device="cuda": mod.init_params(cfg, key, device),
        init_tree=lambda key: mod.init_tree(cfg, key),
        param_specs=lambda mesh: mod.param_specs(cfg, mesh),
        train_loss=_forward(loss, grad=True),
        prefill=_forward(pre, grad=False),
        decode_step=_forward(lambda params, token, cache, mesh: mod.decode_step(cfg, params, token, cache, mesh),
                             grad=False),
        init_cache=lambda batch, max_seq, device="cuda": mod.init_cache(cfg, batch, max_seq, device),
        cache_specs=lambda mesh: mod.cache_specs(cfg, mesh),
    )
