"""Structural HBM-traffic model for the roofline memory term.

The reference's model, copied: the memory term comes from the program's
*structure* (layer counts, remat policy, cache shapes), not from a compiler's
byte count, which counts every unfused op's operands at f32 — orders of
magnitude above what a fused program moves through HBM.  Accounting:

train step (remat at block boundaries, AdamW f32):
  params:      read fwd + read bwd(recompute) + read update       3×4B·P
  grads:       write + read                                       2×4B·P
  adam m,v:    read + write each                                  4×4B·P
  params out:  write                                              1×4B·P
  activations: per layer one residual stream saved (remat) r/w    ~4×2B·B·S·d
  flash K/V:   re-read per q-chunk (fwd + bwd)                    2·nq·S·KV·hd·2B
  MoE:         every expert's weights stream per step (EP local)  3·E·d·f·4B/layer ×10 (fwd+bwd+opt)
prefill: params read once + activations write + KV cache write
decode:  params read once + KV cache read to t + state r/w
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

F32, BF16_B = 4, 2


def _attn_kv_reread_bytes(cfg: ModelConfig, b: int, s: int, q_chunk=512) -> float:
    if cfg.mixer == "mamba" or cfg.n_heads == 0:
        return 0.0
    nq = -(-s // q_chunk)
    kv_bytes = b * s * cfg.n_kv_heads * cfg.hd * 2 * BF16_B  # K and V
    return float(nq) * kv_bytes


def _moe_weight_bytes(cfg: ModelConfig) -> float:
    if not cfg.is_moe:
        return 0.0
    return 3.0 * cfg.n_experts * cfg.d_model * cfg.d_ff * F32


def train_bytes(cfg: ModelConfig, batch: int, seq: int) -> float:
    p = cfg.param_count()
    layers = cfg.n_layers + cfg.enc_layers
    base = (3 + 2 + 4 + 1) * F32 * p  # params/grads/adam traffic
    acts = 4.0 * BF16_B * batch * seq * cfg.d_model * layers
    attn = 2.0 * _attn_kv_reread_bytes(cfg, batch, seq) * layers
    moe = 10.0 * _moe_weight_bytes(cfg) * cfg.n_layers
    return base + acts + attn + moe


def prefill_bytes(cfg: ModelConfig, batch: int, seq: int) -> float:
    p = cfg.param_count()
    layers = cfg.n_layers + cfg.enc_layers
    base = F32 * p  # one read of the weights
    acts = 2.0 * BF16_B * batch * seq * cfg.d_model * layers
    attn = _attn_kv_reread_bytes(cfg, batch, seq) * layers
    cache_w = _cache_bytes(cfg, batch, seq)
    moe = _moe_weight_bytes(cfg) * cfg.n_layers
    return base + acts + attn + cache_w + moe


def decode_bytes(cfg: ModelConfig, batch: int, cache_len: int) -> float:
    p = cfg.param_count()
    base = F32 * p  # weights stream once per token
    cache_r = _cache_bytes(cfg, batch, cache_len)  # attention reads the cache
    moe = _moe_weight_bytes(cfg) * cfg.n_layers  # experts stream (batch ≫ E·topk)
    return base + cache_r + moe


def _cache_bytes(cfg: ModelConfig, batch: int, s: int) -> float:
    total = 0.0
    if cfg.mixer in ("attn", "hymba") and cfg.n_heads:
        s_eff = min(s, cfg.sliding_window) if cfg.sliding_window else s
        total += cfg.n_layers * batch * s_eff * cfg.n_kv_heads * cfg.hd * 2 * BF16_B
    if cfg.mixer in ("mamba", "hymba"):
        total += cfg.n_layers * batch * cfg.n_ssm_heads * cfg.ssm_head_dim * \
            cfg.ssm_state * F32 * 2  # state read + write
    if cfg.family == "audio":
        total += cfg.n_layers * batch * cfg.enc_seq * cfg.n_heads * cfg.hd * 2 * BF16_B
    return total


def hbm_bytes(cfg: ModelConfig, kind: str, batch: int, seq: int) -> float:
    if kind == "train":
        return train_bytes(cfg, batch, seq)
    if kind == "prefill":
        return prefill_bytes(cfg, batch, seq)
    return decode_bytes(cfg, batch, seq)
