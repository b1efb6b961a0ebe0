"""Whisper-style encoder-decoder backbone (the audio frontend is a stub: the
encoder consumes precomputed frame embeddings).

Encoder: bidirectional attention + GELU FFN + layernorm + learned positions.
Decoder: causal self-attention + cross-attention to encoder states.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import Spec

from . import layers as L
from .config import ModelConfig
from .lm import (BF16, F32, ParamTree, _dense_init, _norm_init, _row_parallel_input, chunked_xent, generator,
                 resolve_device)

MAX_DEC_POS = 1 << 16


def init_enc_block(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    return {
        "ln1_w": _norm_init((d,)), "ln1_b": torch.zeros((d,), dtype=F32),
        "wqkv": _dense_init(gen, (d, 3 * cfg.n_heads * hd)),
        "wo": _dense_init(gen, (cfg.n_heads * hd, d)),
        "ln2_w": _norm_init((d,)), "ln2_b": torch.zeros((d,), dtype=F32),
        "w1": _dense_init(gen, (d, f)),
        "w2": _dense_init(gen, (f, d)),
    }


def init_dec_block(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    return {
        "ln1_w": _norm_init((d,)), "ln1_b": torch.zeros((d,), dtype=F32),
        "wqkv": _dense_init(gen, (d, 3 * cfg.n_heads * hd)),
        "wo": _dense_init(gen, (cfg.n_heads * hd, d)),
        "lnx_w": _norm_init((d,)), "lnx_b": torch.zeros((d,), dtype=F32),
        "xq": _dense_init(gen, (d, cfg.n_heads * hd)),
        "xkv": _dense_init(gen, (d, 2 * cfg.n_heads * hd)),
        "xo": _dense_init(gen, (cfg.n_heads * hd, d)),
        "ln2_w": _norm_init((d,)), "ln2_b": torch.zeros((d,), dtype=F32),
        "w1": _dense_init(gen, (d, f)),
        "w2": _dense_init(gen, (f, d)),
    }


def init_params(cfg: ModelConfig, key, device="cuda") -> ParamTree:
    return ParamTree(init_tree(cfg, key)).to(resolve_device(device))


def init_tree(cfg: ModelConfig, key) -> dict:
    """``init_params``' tree as nested dicts and per-layer lists of CPU tensors."""
    gen = generator(key)
    d = cfg.d_model
    return {
        "enc_pos": _dense_init(gen, (cfg.enc_seq, d), scale=0.02),
        "dec_pos": _dense_init(gen, (MAX_DEC_POS, d), scale=0.02),
        "embed": _dense_init(gen, (cfg.vocab, d), scale=0.02),
        "enc_blocks": [init_enc_block(cfg, gen) for _ in range(cfg.enc_layers)],
        "dec_blocks": [init_dec_block(cfg, gen) for _ in range(cfg.n_layers)],
        "enc_ln_w": _norm_init((d,)), "enc_ln_b": torch.zeros((d,), dtype=F32),
        "dec_ln_w": _norm_init((d,)), "dec_ln_b": torch.zeros((d,), dtype=F32),
        "head": _dense_init(gen, (d, cfg.vocab)),
    }


def param_specs(cfg: ModelConfig, mesh) -> dict:
    """Specs in ``init_params``' structure (one layer's specs per entry of
    ``enc_blocks`` and ``dec_blocks``)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    W = lambda shape, tp, fs: sh.weight_spec(mesh, shape, tp, fs)
    V = Spec(None)
    enc = {
        "ln1_w": V, "ln1_b": V,
        "wqkv": W((d, 3 * cfg.n_heads * hd), 1, 0),
        "wo": W((cfg.n_heads * hd, d), 0, 1),
        "ln2_w": V, "ln2_b": V,
        "w1": W((d, f), 1, 0), "w2": W((f, d), 0, 1),
    }
    dec = dict(enc)
    dec.update({
        "lnx_w": V, "lnx_b": V,
        "xq": W((d, cfg.n_heads * hd), 1, 0),
        "xkv": W((d, 2 * cfg.n_heads * hd), 1, 0),
        "xo": W((cfg.n_heads * hd, d), 0, 1),
    })
    return {
        "enc_pos": sh.weight_spec(mesh, (cfg.enc_seq, d), None, 0),
        "dec_pos": sh.weight_spec(mesh, (MAX_DEC_POS, d), None, 0),
        "embed": sh.weight_spec(mesh, (cfg.vocab, d), 0, 1),
        "enc_blocks": [enc] * cfg.enc_layers, "dec_blocks": [dec] * cfg.n_layers,
        "enc_ln_w": Spec(None), "enc_ln_b": Spec(None),
        "dec_ln_w": Spec(None), "dec_ln_b": Spec(None),
        "head": sh.weight_spec(mesh, (d, cfg.vocab), 1, 0),
    }


def _heads(cfg: ModelConfig, z, b: int, s: int):
    return z.reshape(b, s, cfg.n_heads, cfg.hd)


def _split_heads(cfg: ModelConfig, z, parts: int, mesh=None):
    """A fused (B, S, parts·H·D) projection as ``parts`` (B, S, H, D) tensors;
    on a mesh whole over 'model' first (heads whole on every rank)."""
    b, s, _ = z.shape
    if mesh is not None:
        z = sh.constrain(z, mesh, sh.batch_spec(mesh, 3))
    return [_heads(cfg, t, b, s) for t in torch.tensor_split(z, parts, dim=-1)]


def _merge_heads(cfg: ModelConfig, o, w, mesh=None):
    """(B, S, H, D) heads through the output projection ``w``."""
    b, s = o.shape[:2]
    return _row_parallel_input(o.reshape(b, s, -1), mesh) @ w.to(o.dtype)


def _mha(x, p, cfg, causal, mesh=None):
    h = L.layernorm(x, p["ln1_w"].to(x.dtype), p["ln1_b"].to(x.dtype))
    q, k, v = _split_heads(cfg, h @ p["wqkv"].to(x.dtype), 3, mesh)
    out = L.flash_attention(q, k, v, causal=causal)
    return _merge_heads(cfg, out, p["wo"], mesh)


def _ffn(x, p, ln_w, ln_b):
    h = L.layernorm(x, p[ln_w].to(x.dtype), p[ln_b].to(x.dtype))
    return L.gelu(h @ p["w1"].to(x.dtype)) @ p["w2"].to(x.dtype)


def encode(cfg: ModelConfig, params, frames, mesh=None):
    """frames: (B, enc_seq, D) stub frontend embeddings → encoder states."""
    x = frames.to(BF16) + params["enc_pos"][: frames.shape[1]].to(BF16)
    for p in params["enc_blocks"]:
        x = x + _mha(x, p, cfg, causal=False, mesh=mesh)
        x = x + _ffn(x, p, "ln2_w", "ln2_b")
        if mesh is not None:
            x = sh.constrain(x, mesh, sh.batch_spec(mesh, 3))
    return L.layernorm(x, params["enc_ln_w"].to(x.dtype), params["enc_ln_b"].to(x.dtype))


def _cross_kv(cfg: ModelConfig, enc_out, p, mesh=None):
    k, v = _split_heads(cfg, enc_out @ p["xkv"].to(enc_out.dtype), 2, mesh)
    return k, v


def _cross_attn(x, enc_out, p, cfg, mesh=None):
    h = L.layernorm(x, p["lnx_w"].to(x.dtype), p["lnx_b"].to(x.dtype))
    (q,) = _split_heads(cfg, h @ p["xq"].to(x.dtype), 1, mesh)
    k, v = _cross_kv(cfg, enc_out, p, mesh)
    out = L.flash_attention(q, k, v, causal=False)
    return _merge_heads(cfg, out, p["xo"], mesh)


def _dec_embed(params, tokens, positions):
    return sh.gather_rows(params["embed"], tokens).to(BF16) + sh.gather_rows(params["dec_pos"], positions).to(BF16)


def decoder_hidden(cfg: ModelConfig, params, tokens, enc_out, mesh=None):
    x = _dec_embed(params, tokens, torch.arange(tokens.shape[1], device=tokens.device))
    for p in params["dec_blocks"]:
        x = x + _mha(x, p, cfg, causal=True, mesh=mesh)
        x = x + _cross_attn(x, enc_out, p, cfg, mesh)
        x = x + _ffn(x, p, "ln2_w", "ln2_b")
        if mesh is not None:
            x = sh.constrain(x, mesh, sh.batch_spec(mesh, 3))
    return L.layernorm(x, params["dec_ln_w"].to(x.dtype), params["dec_ln_b"].to(x.dtype))


def train_loss(cfg: ModelConfig, params, frames, tokens, mesh=None):
    """frames: (B, enc_seq, D); tokens: (B, S_dec+1)."""
    enc_out = encode(cfg, params, frames, mesh)
    h = decoder_hidden(cfg, params, tokens[:, :-1], enc_out, mesh)
    return chunked_xent(cfg, params, h, tokens[:, 1:], mesh)


# --- serving -----------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda") -> dict:
    dev = resolve_device(device)
    nl, hd = cfg.n_layers, cfg.hd
    zeros = lambda s: torch.zeros((nl, batch, s, cfg.n_heads, hd), dtype=BF16, device=dev)
    return {
        "t": torch.zeros((), dtype=torch.int32, device=dev),
        "k": zeros(max_seq),
        "v": zeros(max_seq),
        # cross-attention K/V precomputed at prefill
        "xk": zeros(cfg.enc_seq),
        "xv": zeros(cfg.enc_seq),
    }


def cache_specs(cfg: ModelConfig, mesh) -> dict:
    dp_t = sh.dp_axes(mesh)
    dp = dp_t or None
    seq_ax = None if "model" in dp_t else "model"
    kv = Spec(None, dp, seq_ax, None, None)
    return {"t": Spec(), "k": kv, "v": kv,
            "xk": Spec(None, dp, None, None, None), "xv": Spec(None, dp, None, None, None)}


def prefill(cfg: ModelConfig, params, frames, tokens, cache, mesh=None):
    """Encode frames, precompute cross-KV, run decoder prompt; fill caches."""
    enc_out = encode(cfg, params, frames, mesh)
    b, s = tokens.shape
    h = _dec_embed(params, tokens, torch.arange(s, device=tokens.device))
    smax = cache["k"].shape[2]
    ks, vs, xks, xvs = [], [], [], []
    for p in params["dec_blocks"]:
        hn = L.layernorm(h, p["ln1_w"].to(h.dtype), p["ln1_b"].to(h.dtype))
        q, k, v = _split_heads(cfg, hn @ p["wqkv"].to(h.dtype), 3, mesh)
        ao = L.flash_attention(q, k, v, causal=True)
        h = h + _merge_heads(cfg, ao, p["wo"], mesh)
        h = h + _cross_attn(h, enc_out, p, cfg, mesh)
        h = h + _ffn(h, p, "ln2_w", "ln2_b")
        xk, xv = _cross_kv(cfg, enc_out, p, mesh)
        ks.append(sh.pad(k, (0, 0, 0, 0, 0, smax - s)).to(BF16))
        vs.append(sh.pad(v, (0, 0, 0, 0, 0, smax - s)).to(BF16))
        xks.append(xk.to(BF16))
        xvs.append(xv.to(BF16))
    cache = dict(cache)
    cache["k"], cache["v"], cache["xk"], cache["xv"] = (torch.stack(z) for z in (ks, vs, xks, xvs))
    cache["t"] = torch.tensor(s, dtype=torch.int32, device=tokens.device)
    h = L.layernorm(h, params["dec_ln_w"].to(h.dtype), params["dec_ln_b"].to(h.dtype))
    logits = (h[:, -1] @ params["head"].to(BF16)).to(F32)
    return logits, cache


def _whole_heads(o, mesh):
    """Decode attention's (B, 1, H, D) output, heads whole on every rank (the
    placement rule of ``lm.decode_step``)."""
    return o if mesh is None else sh.constrain(o, mesh, sh.batch_spec(mesh, 4))


def decode_step(cfg: ModelConfig, params, token, cache, mesh=None):
    """One decoder step against the self-attention cache and the precomputed
    cross-attention K/V; the new cache holds new tensors."""
    b = token.shape[0]
    t = cache["t"]
    h = _dec_embed(params, token[:, None], t.view(1).long())
    slot = t.long().view(1)
    kcache, vcache = cache["k"].clone(), cache["v"].clone()
    for idx, p in enumerate(params["dec_blocks"]):
        hn = L.layernorm(h, p["ln1_w"].to(h.dtype), p["ln1_b"].to(h.dtype))
        q, k, v = _split_heads(cfg, hn @ p["wqkv"].to(h.dtype), 3, mesh)
        kc, vc = kcache[idx], vcache[idx]
        sh.write_slot(kc, 1, slot, k.to(BF16))
        sh.write_slot(vc, 1, slot, v.to(BF16))
        h = h + _merge_heads(cfg, _whole_heads(L.decode_attention(q, kc, vc, t + 1), mesh), p["wo"], mesh)
        # cross-attention against precomputed encoder KV
        hx = L.layernorm(h, p["lnx_w"].to(h.dtype), p["lnx_b"].to(h.dtype))
        (qx,) = _split_heads(cfg, hx @ p["xq"].to(h.dtype), 1, mesh)
        xo = L.decode_attention(qx, cache["xk"][idx], cache["xv"][idx], cache["xk"].shape[2])
        h = h + _merge_heads(cfg, _whole_heads(xo, mesh), p["xo"], mesh)
        h = h + _ffn(h, p, "ln2_w", "ln2_b")
    cache = dict(cache)
    cache["k"], cache["v"] = kcache, vcache
    cache["t"] = t + 1
    h = L.layernorm(h, params["dec_ln_w"].to(h.dtype), params["dec_ln_b"].to(h.dtype))
    logits = (h[:, 0] @ params["head"].to(BF16)).to(F32)
    return logits, cache
