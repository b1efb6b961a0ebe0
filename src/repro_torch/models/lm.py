"""Decoder-only LM family: dense / MoE / Mamba2-SSD / Hymba-hybrid.

One implementation parameterised by ModelConfig:
  mixer = "attn"  — llama-style GQA transformer (smollm, granite, qwen1.5,
                    phi3-medium, phi-3-vision backbone, + MoE variants)
  mixer = "mamba" — attention-free Mamba2/SSD stack (mamba2-1.3b)
  mixer = "hymba" — parallel attention + SSD heads, outputs fused (hymba-1.5b)

Parameters are a ``ParamTree``: the reference's tree as modules, with fp32
``nn.Parameter`` leaves cast to bfloat16 at use and one module per layer
under ``blocks``.  Layers run in a Python loop where the reference scans;
the loss folds the LM head into a sequence-chunked cross-entropy so
(B, S, vocab) logits are never materialised.  The decode cache keeps the
reference's layout: stacked (n_layers, B, S, KV, D) tensors and ``t``.

Sharding: ``param_specs``/``cache_specs`` give the reference's specs (one
layer's per entry of ``blocks``); with ``mesh=`` the entry points take
DTensors and constrain activations at the reference's sites and at the
placement rules of ``distributed.sharding``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import Spec

from . import layers as L
from .config import ModelConfig

BF16 = torch.bfloat16
F32 = torch.float32
CONV_K = 4  # Mamba2 depthwise conv kernel


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; "cuda" raises where there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the model on device 'cuda' needs a CUDA card; pass device='cpu' for the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class ParamTree(nn.Module):
    """A nested dict of tensors as modules: each tensor an ``nn.Parameter``,
    each dict a ``ParamTree``, each list (one entry per layer) an
    ``nn.ModuleList``.  Read as the reference reads its tree:
    ``p["attn"]["ln"]``, ``"bqkv" in p``, ``p.get("sw1")``."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(ParamTree(t) for t in v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def __getitem__(self, k):
        if k in self._parameters:
            return self._parameters[k]
        return self._modules[k]

    def __contains__(self, k) -> bool:
        return k in self._parameters or k in self._modules

    def get(self, k, default=None):
        return self[k] if k in self else default

    def keys(self) -> list[str]:
        return [*self._parameters, *self._modules]

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _norm_init(shape):
    return torch.ones(shape, dtype=F32)


def _dense_init(gen: torch.Generator, shape, scale=None):
    fan_in = shape[0]
    scale = float(scale if scale is not None else 1.0 / np.sqrt(fan_in))
    return torch.randn(shape, generator=gen, dtype=F32) * scale


def generator(key) -> torch.Generator:
    """A CPU ``torch.Generator`` from an int seed (a generator passes through)."""
    return key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(int(key))


def init_block_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """One layer's parameters, as the reference's tree (CPU tensors)."""
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.hd
    p: dict[str, Any] = {}
    if cfg.mixer in ("attn", "hymba"):
        n_qkv = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
        p["attn"] = {
            "ln": _norm_init((d,)),
            "wqkv": _dense_init(gen, (d, n_qkv)),
            "wo": _dense_init(gen, (cfg.n_heads * hd, d)),
        }
        if cfg.qkv_bias:
            p["attn"]["bqkv"] = torch.zeros((n_qkv,), dtype=F32)
    if cfg.mixer in ("mamba", "hymba"):
        di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        conv_ch = di + 2 * ns
        p["mamba"] = {
            "ln": _norm_init((d,)),
            "in_proj": _dense_init(gen, (d, 2 * di + 2 * ns + nh)),
            "conv_w": _dense_init(gen, (conv_ch, CONV_K), scale=0.5),
            "conv_b": torch.zeros((conv_ch,), dtype=F32),
            "dt_bias": torch.zeros((nh,), dtype=F32),
            "a_log": torch.zeros((nh,), dtype=F32),
            "d_skip": torch.ones((nh,), dtype=F32),
            "out_norm": _norm_init((di,)),
            "out_proj": _dense_init(gen, (di, d)),
        }
    if cfg.d_ff == 0:  # pure-Mamba blocks have no MLP
        return p
    p["ffn_ln"] = _norm_init((d,))
    if cfg.is_moe:
        e = cfg.n_experts
        p["moe"] = {
            "router": _dense_init(gen, (d, e)),
            "w1": _dense_init(gen, (e, d, f)),
            "w2": _dense_init(gen, (e, f, d)),
            "w3": _dense_init(gen, (e, d, f)),
        }
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            p["moe"].update(
                sw1=_dense_init(gen, (d, fs)),
                sw2=_dense_init(gen, (fs, d)),
                sw3=_dense_init(gen, (d, fs)),
            )
    else:
        p["ffn"] = {
            "w1": _dense_init(gen, (d, f)),
            "w2": _dense_init(gen, (f, d)),
        }
        if cfg.act == "swiglu":
            p["ffn"]["w3"] = _dense_init(gen, (d, f))
    return p


def init_params(cfg: ModelConfig, key, device="cuda") -> ParamTree:
    """Random parameters at the reference's scales, drawn on the CPU from
    ``key`` (an int seed or a ``torch.Generator``), placed on ``device``."""
    dev = resolve_device(device)
    return ParamTree(init_tree(cfg, key)).to(dev)


def init_tree(cfg: ModelConfig, key) -> dict:
    """``init_params``' tree as nested dicts and per-layer lists of CPU
    tensors (under ``FakeTensorMode``, of fake ones: the dry-run's)."""
    gen = generator(key)
    params = {
        "embed": _dense_init(gen, (cfg.vocab, cfg.d_model), scale=0.02),
        "final_ln": _norm_init((cfg.d_model,)),
    }
    if not cfg.tie_embeddings:
        params["head"] = _dense_init(gen, (cfg.d_model, cfg.vocab))
    params["blocks"] = [init_block_params(cfg, gen) for _ in range(cfg.n_layers)]
    return params


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------


def block_specs(cfg: ModelConfig, mesh) -> dict:
    """Specs matching init_block_params: one layer's, as each entry of the
    ``blocks`` list holds it (the reference's stacked specs without their
    leading layer dim)."""
    W = lambda shape, tp, fsdp: sh.weight_spec(mesh, shape, tp, fsdp)
    V = lambda: Spec(None)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    p: dict[str, Any] = {}
    if cfg.mixer in ("attn", "hymba"):
        n_qkv = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
        p["attn"] = {
            "ln": V(),
            "wqkv": W((d, n_qkv), 1, 0),
            "wo": W((cfg.n_heads * hd, d), 0, 1),
        }
        if cfg.qkv_bias:
            p["attn"]["bqkv"] = sh.weight_spec(mesh, (n_qkv,), 0, None)
    if cfg.mixer in ("mamba", "hymba"):
        di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        p["mamba"] = {
            "ln": V(),
            "in_proj": W((d, 2 * di + 2 * ns + nh), None, 0),
            "conv_w": V(), "conv_b": V(), "dt_bias": V(),
            "a_log": V(), "d_skip": V(),
            "out_norm": V(),
            "out_proj": W((di, d), 0, 1),
        }
    if cfg.d_ff == 0:
        return p
    p["ffn_ln"] = V()
    if cfg.is_moe:
        e = cfg.n_experts
        p["moe"] = {
            "router": W((d, e), None, 0),
            "w1": _expert_spec(mesh, (e, d, f)),
            "w2": _expert_spec(mesh, (e, f, d)),
            "w3": _expert_spec(mesh, (e, d, f)),
        }
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            p["moe"].update(
                sw1=W((d, fs), 1, 0), sw2=W((fs, d), 0, 1), sw3=W((d, fs), 1, 0)
            )
    else:
        p["ffn"] = {"w1": W((d, f), 1, 0), "w2": W((f, d), 0, 1)}
        if cfg.act == "swiglu":
            p["ffn"]["w3"] = W((d, f), 1, 0)
    return p


def _expert_spec(mesh, shape) -> Spec:
    """Experts sharded over 'model' (EP), inner dim FSDP over 'data'."""
    parts: list = [None] * len(shape)
    if sh.divisible(shape[0], mesh, "model"):
        parts[0] = "model"
    if sh.divisible(shape[1], mesh, "data"):
        parts[1] = "data"
    return Spec(*parts)


def param_specs(cfg: ModelConfig, mesh) -> dict:
    """Specs in ``init_params``' structure: ``blocks`` holds one layer's
    specs per layer."""
    specs = {
        "embed": sh.weight_spec(mesh, (cfg.vocab, cfg.d_model), 0, 1),
        "final_ln": Spec(None),
    }
    if not cfg.tie_embeddings:
        specs["head"] = sh.weight_spec(mesh, (cfg.d_model, cfg.vocab), 1, 0)
    specs["blocks"] = [block_specs(cfg, mesh) for _ in range(cfg.n_layers)]
    return specs


# ---------------------------------------------------------------------------
# block forward
# ---------------------------------------------------------------------------


def _split_qkv(cfg: ModelConfig, qkv, mesh=None):
    hd = cfg.hd
    nq = cfg.n_heads * hd
    nkv = cfg.n_kv_heads * hd
    if mesh is not None:  # placement rule: heads whole on every rank (see sharding's docstring)
        qkv = sh.constrain(qkv, mesh, sh.batch_spec(mesh, 3))
    q, k, v = torch.tensor_split(qkv, [nq, nq + nkv], dim=-1)
    b, s = q.shape[:2]
    return (
        q.reshape(b, s, cfg.n_heads, hd),
        k.reshape(b, s, cfg.n_kv_heads, hd),
        v.reshape(b, s, cfg.n_kv_heads, hd),
    )


def _row_parallel_input(x, mesh):
    """``x`` with its feature dim whole before a product whose contraction
    dim is sharded over 'model' (placement rule): the product's backward then
    gives the gradient of ``x`` whole too, not as a shard of flattened heads."""
    return x if mesh is None else sh.constrain(x, mesh, sh.batch_spec(mesh, x.ndim))


def _qkv(cfg: ModelConfig, pa, h, positions, mesh=None):
    """Pre-norm, QKV projection (+ bias) and rotary embedding of one block."""
    hn = L.rmsnorm(h, pa["ln"].to(h.dtype))
    qkv = hn @ pa["wqkv"].to(h.dtype)
    if "bqkv" in pa:
        qkv = qkv + pa["bqkv"].to(h.dtype)
    q, k, v = _split_qkv(cfg, qkv, mesh)
    return L.rope(q, positions, cfg.rope_theta), L.rope(k, positions, cfg.rope_theta), v


def attn_forward(cfg: ModelConfig, p, x, positions, *, window: int, mesh=None):
    q, k, v = _qkv(cfg, p, x, positions, mesh)
    out = L.flash_attention(q, k, v, causal=True, window=window)
    b, s = x.shape[:2]
    return _row_parallel_input(out.reshape(b, s, -1), mesh) @ p["wo"].to(x.dtype)


def mamba_forward(cfg: ModelConfig, p, x, h0=None, conv0=None, mesh=None):
    """Returns (out, (ssm_state, conv_state))."""
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    h = L.rmsnorm(x, p["ln"].to(x.dtype))
    zxbcdt = h @ p["in_proj"].to(x.dtype)
    z, xbc, dt = torch.tensor_split(zxbcdt, [di, 2 * di + 2 * ns], dim=-1)
    xbc, conv_state = L.causal_conv1d(xbc, p["conv_w"], p["conv_b"], state=conv0)
    xs, b_in, c_in = torch.tensor_split(xbc, [di, di + ns], dim=-1)
    dt = F.softplus(dt.to(F32) + p["dt_bias"])
    bsz, s = x.shape[:2]
    xh = xs.reshape(bsz, s, nh, cfg.ssm_head_dim)
    y, h_final = L.ssd_chunked(xh, dt, p["a_log"], b_in, c_in, p["d_skip"], h0=h0)
    y = y.reshape(bsz, s, di) * F.silu(z)
    y = L.rmsnorm(y, p["out_norm"].to(x.dtype))
    y = _row_parallel_input(y, mesh)
    return y @ p["out_proj"].to(x.dtype), (h_final, conv_state)


def ffn_forward(cfg: ModelConfig, p_block, x):
    if cfg.d_ff == 0:
        return torch.zeros_like(x)
    h = L.rmsnorm(x, p_block["ffn_ln"].to(x.dtype))
    if cfg.is_moe:
        b, s, d = h.shape
        m = p_block["moe"]
        out, _ = L.moe_ffn(
            h.reshape(b * s, d), m["router"], m["w1"], m["w2"], m["w3"],
            top_k=cfg.top_k, n_shared=cfg.n_shared_experts,
            sw1=m.get("sw1"), sw2=m.get("sw2"), sw3=m.get("sw3"),
        )
        return out.reshape(b, s, d)
    f = p_block["ffn"]
    return L.ffn(h, f["w1"].to(x.dtype), f["w2"].to(x.dtype),
                 f["w3"].to(x.dtype) if "w3" in f else None, act=cfg.act)


def block_forward(cfg: ModelConfig, p_block, x, positions, mesh=None):
    """Full-sequence block (train/prefill), no cache."""
    window = cfg.sliding_window
    if cfg.mixer == "attn":
        mix = attn_forward(cfg, p_block["attn"], x, positions, window=window, mesh=mesh)
    elif cfg.mixer == "mamba":
        mix, _ = mamba_forward(cfg, p_block["mamba"], x, mesh=mesh)
    else:  # hymba: parallel heads, mean-fused
        a = attn_forward(cfg, p_block["attn"], x, positions, window=window, mesh=mesh)
        m, _ = mamba_forward(cfg, p_block["mamba"], x, mesh=mesh)
        mix = 0.5 * (a + m)
    if mesh is not None:  # placement rule: the mixer's partial sums reduced before the residual add
        mix = sh.constrain(mix, mesh, sh.batch_spec(mesh, 3))
    x = x + mix
    x = x + ffn_forward(cfg, p_block, x)
    if mesh is not None:
        x = sh.constrain(x, mesh, sh.batch_spec(mesh, 3))
    return x


# ---------------------------------------------------------------------------
# full model: train / prefill / decode
# ---------------------------------------------------------------------------


def forward_hidden(cfg: ModelConfig, params, x, positions, mesh=None, remat: bool = True):
    """Embeddings → blocks → final norm (returns hidden states).

    With ``remat`` and autograd on, each block is checkpointed at its
    boundary (``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint``): the backward pass recomputes the block's inside."""
    for p_block in params["blocks"]:
        if remat and torch.is_grad_enabled():
            x = checkpoint(block_forward, cfg, p_block, x, positions, mesh, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = block_forward(cfg, p_block, x, positions, mesh)
    return L.rmsnorm(x, params["final_ln"].to(x.dtype))


def embed(cfg: ModelConfig, params, tokens):
    return sh.gather_rows(params["embed"], tokens).to(BF16)


def lm_head(cfg: ModelConfig, params):
    return (params["embed"].T if cfg.tie_embeddings else params["head"]).to(BF16)


def chunked_xent(cfg: ModelConfig, params, hidden, targets, mesh=None, chunk: int = 512):
    """Cross-entropy with the LM head folded into a loop over sequence chunks
    — (B, S, vocab) logits are never materialised at once."""
    head = lm_head(cfg, params)
    b, s, d = hidden.shape
    nc = -(-s // chunk)
    pad = nc * chunk - s
    hp = sh.pad(hidden, (0, 0, 0, pad)).reshape(b, nc, chunk, d)
    tp = sh.pad(targets, (0, pad), value=-1).reshape(b, nc, chunk)
    total = torch.zeros((), dtype=F32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for j in range(nc):
        tc = tp[:, j]
        logits = (hp[:, j] @ head).to(F32)  # (B, chunk, V)
        if mesh is not None:
            logits = sh.constrain(logits, mesh, sh.batch_spec(mesh, 3))
        lse = torch.logsumexp(logits, dim=-1)
        gold = sh.take_gold(logits, torch.clamp_min(tc, 0).long())
        valid = tc >= 0
        nll = torch.where(valid, lse - gold, 0.0)
        total = total + nll.sum()
        count = count + valid.sum(dtype=torch.int32)
    return total / torch.clamp_min(count, 1)


def _positions(b: int, s: int, device):
    return torch.arange(s, device=device).expand(b, s)


def train_loss(cfg: ModelConfig, params, tokens, mesh=None):
    """tokens: (B, S+1) int — next-token xent averaged over positions."""
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    x = embed(cfg, params, inp)
    if mesh is not None:
        x = sh.constrain(x, mesh, sh.batch_spec(mesh, 3))
    h = forward_hidden(cfg, params, x, _positions(*inp.shape, tokens.device), mesh)
    return chunked_xent(cfg, params, h, tgt, mesh)


# --- serving -----------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda") -> dict:
    """KV / SSM / conv decode state, on ``device``."""
    dev = resolve_device(device)
    cache: dict[str, Any] = {"t": torch.zeros((), dtype=torch.int32, device=dev)}
    nl = cfg.n_layers
    if cfg.mixer in ("attn", "hymba"):
        s_eff = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
        shape = (nl, batch, s_eff, cfg.n_kv_heads, cfg.hd)
        cache["k"] = torch.zeros(shape, dtype=BF16, device=dev)
        cache["v"] = torch.zeros(shape, dtype=BF16, device=dev)
    if cfg.mixer in ("mamba", "hymba"):
        cache["ssm"] = torch.zeros(
            (nl, batch, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), dtype=F32, device=dev)
        cache["conv"] = torch.zeros(
            (nl, batch, CONV_K - 1, cfg.d_inner + 2 * cfg.ssm_state), dtype=BF16, device=dev)
    return cache


def cache_specs(cfg: ModelConfig, mesh) -> dict:
    """Specs of ``init_cache``'s tensors: KV batch over data, SEQUENCE over
    model (flash-decoding / SP layout)."""
    specs: dict[str, Any] = {"t": Spec()}
    dp = sh.dp_axes(mesh)
    seq_ax = None if "model" in dp else "model"  # no reuse under pure-DP policy
    if cfg.mixer in ("attn", "hymba"):
        kv_spec = Spec(None, dp or None, seq_ax, None, None)
        specs["k"] = kv_spec
        specs["v"] = kv_spec
    if cfg.mixer in ("mamba", "hymba"):
        specs["ssm"] = Spec(None, sh.dp_axes(mesh) or None, None, None, None)
        specs["conv"] = Spec(None, sh.dp_axes(mesh) or None, None, None)
    return specs


def decode_step(cfg: ModelConfig, params, token, cache, mesh=None):
    """token: (B,) int → (logits (B, V), new cache).  One autoregressive step.

    The new cache holds new tensors; ``cache`` is left as it was."""
    b = token.shape[0]
    t = cache["t"]
    x = embed(cfg, params, token[:, None])  # (B, 1, D)
    positions = t.view(1, 1).expand(b, 1)
    window = cfg.sliding_window
    new_cache = dict(cache)
    if cfg.mixer in ("attn", "hymba"):
        new_cache["k"], new_cache["v"] = cache["k"].clone(), cache["v"].clone()
        s_eff = cache["k"].shape[2]
        slot = (t % s_eff if window else t).long().view(1)
        eff_t = torch.clamp_max(t + 1, s_eff) if window else t + 1
    ssm_out, conv_out = [], []

    h = x
    for idx, p_block in enumerate(params["blocks"]):
        mix_parts = []
        if cfg.mixer in ("attn", "hymba"):
            pa = p_block["attn"]
            q, k, v = _qkv(cfg, pa, h, positions, mesh)
            kc, vc = new_cache["k"][idx], new_cache["v"][idx]
            sh.write_slot(kc, 1, slot, k.to(BF16))
            sh.write_slot(vc, 1, slot, v.to(BF16))
            ao = L.decode_attention(q, kc, vc, eff_t, window=0)
            if mesh is not None:  # placement rule: the heads whole before they are flattened
                ao = sh.constrain(ao, mesh, sh.batch_spec(mesh, 4))
            mix_parts.append(ao.reshape(b, 1, -1) @ pa["wo"].to(h.dtype))
        if cfg.mixer in ("mamba", "hymba"):
            pm = p_block["mamba"]
            di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
            hn = L.rmsnorm(h, pm["ln"].to(h.dtype))
            zxbcdt = hn @ pm["in_proj"].to(h.dtype)
            z, xbc, dt = torch.tensor_split(zxbcdt, [di, 2 * di + 2 * ns], dim=-1)
            xbc, conv_new = L.causal_conv1d(xbc, pm["conv_w"], pm["conv_b"], state=cache["conv"][idx])
            xs, b_in, c_in = torch.tensor_split(xbc[:, 0], [di, di + ns], dim=-1)
            dts = F.softplus(dt[:, 0].to(F32) + pm["dt_bias"])
            xh = xs.reshape(b, nh, cfg.ssm_head_dim)
            y, ssm_new = L.ssd_decode_step(xh, dts, pm["a_log"], b_in, c_in, pm["d_skip"], cache["ssm"][idx])
            y = y.reshape(b, 1, di) * F.silu(z)
            y = L.rmsnorm(y, pm["out_norm"].to(h.dtype))
            mix_parts.append(y @ pm["out_proj"].to(h.dtype))
            ssm_out.append(ssm_new)
            conv_out.append(conv_new)
        mix = mix_parts[0] if len(mix_parts) == 1 else 0.5 * (mix_parts[0] + mix_parts[1])
        h = h + mix
        h = h + ffn_forward(cfg, p_block, h)

    if cfg.mixer in ("mamba", "hymba"):
        new_cache["ssm"], new_cache["conv"] = torch.stack(ssm_out), torch.stack(conv_out)
    new_cache["t"] = t + 1
    h = L.rmsnorm(h, params["final_ln"].to(h.dtype))
    logits = (h[:, 0] @ lm_head(cfg, params)).to(F32)
    if mesh is not None:
        logits = sh.constrain(logits, mesh, Spec(sh.dp_axes(mesh) or None, "model"
                                                 if sh.divisible(cfg.vocab, mesh, "model") else None))
    return logits, new_cache


def prefill(cfg: ModelConfig, params, tokens, cache, mesh=None):
    """Full-sequence prefill filling the KV cache; returns (last_logits, cache).

    Implemented as hidden-state forward + cache write per layer."""
    b, s = tokens.shape
    x = embed(cfg, params, tokens)
    if mesh is not None:
        x = sh.constrain(x, mesh, sh.batch_spec(mesh, 3))
    positions = _positions(b, s, tokens.device)
    window = cfg.sliding_window
    ks, vs, ssm_out, conv_out = [], [], [], []

    h = x
    for p_block in params["blocks"]:
        mix_parts = []
        if cfg.mixer in ("attn", "hymba"):
            pa = p_block["attn"]
            q, k, v = _qkv(cfg, pa, h, positions, mesh)
            ao = L.flash_attention(q, k, v, causal=True, window=window)
            mix_parts.append(ao.reshape(b, s, -1) @ pa["wo"].to(h.dtype))
            s_eff = cache["k"].shape[2]
            kl, vl = k[:, -s_eff:].to(BF16), v[:, -s_eff:].to(BF16)
            if window and s >= s_eff:
                # ring-buffer alignment: token position p lives at slot p % w
                kl = torch.roll(kl, s % s_eff, dims=1)
                vl = torch.roll(vl, s % s_eff, dims=1)
            ks.append(kl)
            vs.append(vl)
        if cfg.mixer in ("mamba", "hymba"):
            mo, (ssm_new, conv_new) = mamba_forward(cfg, p_block["mamba"], h, mesh=mesh)
            mix_parts.append(mo)
            ssm_out.append(ssm_new)
            conv_out.append(conv_new)
        mix = mix_parts[0] if len(mix_parts) == 1 else 0.5 * (mix_parts[0] + mix_parts[1])
        h = h + mix
        h = h + ffn_forward(cfg, p_block, h)
        if mesh is not None:
            h = sh.constrain(h, mesh, sh.batch_spec(mesh, 3))

    new_cache = dict(cache)
    if cfg.mixer in ("attn", "hymba"):
        pad = cache["k"].shape[2] - min(s, cache["k"].shape[2])
        new_cache["k"] = sh.pad(torch.stack(ks), (0, 0, 0, 0, 0, pad))
        new_cache["v"] = sh.pad(torch.stack(vs), (0, 0, 0, 0, 0, pad))
    if cfg.mixer in ("mamba", "hymba"):
        new_cache["ssm"], new_cache["conv"] = torch.stack(ssm_out), torch.stack(conv_out)
    new_cache["t"] = torch.tensor(s, dtype=torch.int32, device=tokens.device)
    h = L.rmsnorm(h, params["final_ln"].to(h.dtype))
    logits = (h[:, -1] @ lm_head(cfg, params)).to(F32)
    return logits, new_cache
