"""Whisper-style encoder-decoder backbone (the audio frontend is a stub: the
encoder consumes precomputed frame embeddings).

Encoder: bidirectional attention + GELU FFN + layernorm + learned positions.
Decoder: causal self-attention + cross-attention to encoder states.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers as L
from .config import ModelConfig
from .lm import BF16, F32, ParamTree, _dense_init, _norm_init, chunked_xent, generator, resolve_device

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
    dev = resolve_device(device)
    gen = generator(key)
    d = cfg.d_model
    return ParamTree({
        "enc_pos": _dense_init(gen, (cfg.enc_seq, d), scale=0.02),
        "dec_pos": _dense_init(gen, (MAX_DEC_POS, d), scale=0.02),
        "embed": _dense_init(gen, (cfg.vocab, d), scale=0.02),
        "enc_blocks": [init_enc_block(cfg, gen) for _ in range(cfg.enc_layers)],
        "dec_blocks": [init_dec_block(cfg, gen) for _ in range(cfg.n_layers)],
        "enc_ln_w": _norm_init((d,)), "enc_ln_b": torch.zeros((d,), dtype=F32),
        "dec_ln_w": _norm_init((d,)), "dec_ln_b": torch.zeros((d,), dtype=F32),
        "head": _dense_init(gen, (d, cfg.vocab)),
    }).to(dev)


def _heads(cfg: ModelConfig, z, b: int, s: int):
    return z.reshape(b, s, cfg.n_heads, cfg.hd)


def _mha(x, p, cfg, causal):
    b, s, _ = x.shape
    h = L.layernorm(x, p["ln1_w"].to(x.dtype), p["ln1_b"].to(x.dtype))
    q, k, v = (_heads(cfg, z, b, s) for z in torch.tensor_split(h @ p["wqkv"].to(x.dtype), 3, dim=-1))
    out = L.flash_attention(q, k, v, causal=causal)
    return out.reshape(b, s, -1) @ p["wo"].to(x.dtype)


def _ffn(x, p, ln_w, ln_b):
    h = L.layernorm(x, p[ln_w].to(x.dtype), p[ln_b].to(x.dtype))
    return L.gelu(h @ p["w1"].to(x.dtype)) @ p["w2"].to(x.dtype)


def encode(cfg: ModelConfig, params, frames):
    """frames: (B, enc_seq, D) stub frontend embeddings → encoder states."""
    x = frames.to(BF16) + params["enc_pos"][: frames.shape[1]].to(BF16)
    for p in params["enc_blocks"]:
        x = x + _mha(x, p, cfg, causal=False)
        x = x + _ffn(x, p, "ln2_w", "ln2_b")
    return L.layernorm(x, params["enc_ln_w"].to(x.dtype), params["enc_ln_b"].to(x.dtype))


def _cross_kv(cfg: ModelConfig, enc_out, p):
    b, se, _ = enc_out.shape
    k, v = torch.tensor_split(enc_out @ p["xkv"].to(enc_out.dtype), 2, dim=-1)
    return _heads(cfg, k, b, se), _heads(cfg, v, b, se)


def _cross_attn(x, enc_out, p, cfg):
    b, s, _ = x.shape
    h = L.layernorm(x, p["lnx_w"].to(x.dtype), p["lnx_b"].to(x.dtype))
    q = _heads(cfg, h @ p["xq"].to(x.dtype), b, s)
    k, v = _cross_kv(cfg, enc_out, p)
    out = L.flash_attention(q, k, v, causal=False)
    return out.reshape(b, s, -1) @ p["xo"].to(x.dtype)


def _dec_embed(params, tokens, positions):
    return params["embed"][tokens].to(BF16) + params["dec_pos"][positions].to(BF16)


def decoder_hidden(cfg: ModelConfig, params, tokens, enc_out):
    x = _dec_embed(params, tokens, torch.arange(tokens.shape[1], device=tokens.device))
    for p in params["dec_blocks"]:
        x = x + _mha(x, p, cfg, causal=True)
        x = x + _cross_attn(x, enc_out, p, cfg)
        x = x + _ffn(x, p, "ln2_w", "ln2_b")
    return L.layernorm(x, params["dec_ln_w"].to(x.dtype), params["dec_ln_b"].to(x.dtype))


def train_loss(cfg: ModelConfig, params, frames, tokens):
    """frames: (B, enc_seq, D); tokens: (B, S_dec+1)."""
    enc_out = encode(cfg, params, frames)
    h = decoder_hidden(cfg, params, tokens[:, :-1], enc_out)
    return chunked_xent(cfg, params, h, tokens[:, 1:])


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


def prefill(cfg: ModelConfig, params, frames, tokens, cache):
    """Encode frames, precompute cross-KV, run decoder prompt; fill caches."""
    enc_out = encode(cfg, params, frames)
    b, s = tokens.shape
    h = _dec_embed(params, tokens, torch.arange(s, device=tokens.device))
    smax = cache["k"].shape[2]
    ks, vs, xks, xvs = [], [], [], []
    for p in params["dec_blocks"]:
        hn = L.layernorm(h, p["ln1_w"].to(h.dtype), p["ln1_b"].to(h.dtype))
        q, k, v = (_heads(cfg, z, b, s) for z in torch.tensor_split(hn @ p["wqkv"].to(h.dtype), 3, dim=-1))
        ao = L.flash_attention(q, k, v, causal=True)
        h = h + ao.reshape(b, s, -1) @ p["wo"].to(h.dtype)
        h = h + _cross_attn(h, enc_out, p, cfg)
        h = h + _ffn(h, p, "ln2_w", "ln2_b")
        xk, xv = _cross_kv(cfg, enc_out, p)
        ks.append(F.pad(k, (0, 0, 0, 0, 0, smax - s)).to(BF16))
        vs.append(F.pad(v, (0, 0, 0, 0, 0, smax - s)).to(BF16))
        xks.append(xk.to(BF16))
        xvs.append(xv.to(BF16))
    cache = dict(cache)
    cache["k"], cache["v"], cache["xk"], cache["xv"] = (torch.stack(z) for z in (ks, vs, xks, xvs))
    cache["t"] = torch.tensor(s, dtype=torch.int32, device=tokens.device)
    h = L.layernorm(h, params["dec_ln_w"].to(h.dtype), params["dec_ln_b"].to(h.dtype))
    logits = (h[:, -1] @ params["head"].to(BF16)).to(F32)
    return logits, cache


def decode_step(cfg: ModelConfig, params, token, cache):
    """One decoder step against the self-attention cache and the precomputed
    cross-attention K/V; the new cache holds new tensors."""
    b = token.shape[0]
    t = cache["t"]
    nh, hd = cfg.n_heads, cfg.hd
    h = _dec_embed(params, token[:, None], t.view(1).long())
    slot = t.long().view(1)
    kcache, vcache = cache["k"].clone(), cache["v"].clone()
    for idx, p in enumerate(params["dec_blocks"]):
        hn = L.layernorm(h, p["ln1_w"].to(h.dtype), p["ln1_b"].to(h.dtype))
        q, k, v = (z.reshape(b, 1, nh, hd) for z in torch.tensor_split(hn @ p["wqkv"].to(h.dtype), 3, dim=-1))
        kc, vc = kcache[idx], vcache[idx]
        kc.index_copy_(1, slot, k.to(BF16))
        vc.index_copy_(1, slot, v.to(BF16))
        h = h + L.decode_attention(q, kc, vc, t + 1).reshape(b, 1, -1) @ p["wo"].to(h.dtype)
        # cross-attention against precomputed encoder KV
        hx = L.layernorm(h, p["lnx_w"].to(h.dtype), p["lnx_b"].to(h.dtype))
        qx = (hx @ p["xq"].to(h.dtype)).reshape(b, 1, nh, hd)
        xo = L.decode_attention(qx, cache["xk"][idx], cache["xv"][idx], cache["xk"].shape[2])
        h = h + xo.reshape(b, 1, -1) @ p["xo"].to(h.dtype)
        h = h + _ffn(h, p, "ln2_w", "ln2_b")
    cache = dict(cache)
    cache["k"], cache["v"] = kcache, vcache
    cache["t"] = t + 1
    h = L.layernorm(h, params["dec_ln_w"].to(h.dtype), params["dec_ln_b"].to(h.dtype))
    logits = (h[:, 0] @ params["head"].to(BF16)).to(F32)
    return logits, cache
