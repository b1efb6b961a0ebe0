"""Phi-3-vision backbone: phi3-mini decoder LM + stub CLIP patch embeddings.

The modality frontend is a stub: callers pass precomputed patch embeddings
(B, n_patches, d_model), which are prepended to the token embeddings.  The
loss is masked to text positions.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import sharding as sh

from . import layers as L
from . import lm
from .config import ModelConfig
from .lm import BF16, F32

init_params = lm.init_params
init_tree = lm.init_tree
param_specs = lm.param_specs
init_cache = lm.init_cache
cache_specs = lm.cache_specs
decode_step = lm.decode_step  # decoding past the image tokens is plain LM


def train_loss(cfg: ModelConfig, params, tokens, patches, mesh=None):
    """tokens: (B, S_txt+1) int; patches: (B, n_patches, D) stub embeddings."""
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    b = inp.shape[0]
    x = torch.cat([patches.to(BF16), lm.embed(cfg, params, inp)], dim=1)
    if mesh is not None:
        x = sh.constrain(x, mesh, sh.batch_spec(mesh, 3))
    h = lm.forward_hidden(cfg, params, x, lm._positions(b, x.shape[1], x.device), mesh)
    # next-token loss over the text region only
    return lm.chunked_xent(cfg, params, h[:, patches.shape[1]:], tgt, mesh)


def prefill(cfg: ModelConfig, params, tokens, patches, cache, mesh=None):
    """Prefill over (image patches + prompt tokens)."""
    x = torch.cat([patches.to(BF16), lm.embed(cfg, params, tokens)], dim=1)
    return _prefill_embedded(cfg, params, x, cache, mesh)


def _prefill_embedded(cfg: ModelConfig, params, x, cache, mesh=None):
    b, s, _ = x.shape
    positions = lm._positions(b, s, x.device)
    smax = cache["k"].shape[2]
    ks, vs = [], []
    h = x
    for p_block in params["blocks"]:
        pa = p_block["attn"]
        hn = L.rmsnorm(h, pa["ln"].to(h.dtype))
        qkv = hn @ pa["wqkv"].to(h.dtype)
        q, k, v = lm._split_qkv(cfg, qkv, mesh)
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
        ao = L.flash_attention(q, k, v, causal=True)
        h = h + ao.reshape(b, s, -1) @ pa["wo"].to(h.dtype)
        h = h + lm.ffn_forward(cfg, p_block, h)
        if mesh is not None:
            h = sh.constrain(h, mesh, sh.batch_spec(mesh, 3))
        ks.append(sh.pad(k, (0, 0, 0, 0, 0, smax - s)).to(BF16))
        vs.append(sh.pad(v, (0, 0, 0, 0, 0, smax - s)).to(BF16))
    new_cache = dict(cache)
    new_cache["k"], new_cache["v"] = torch.stack(ks), torch.stack(vs)
    new_cache["t"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    h = L.rmsnorm(h, params["final_ln"].to(h.dtype))
    logits = (h[:, -1] @ lm.lm_head(cfg, params)).to(F32)
    return logits, new_cache
