"""Architecture configuration shared by every model family."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int  # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    # --- attention details ---
    head_dim: int = 0  # 0 ⇒ d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # 0 ⇒ full attention
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    # --- SSM (Mamba2/SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    # --- mixer layout ---
    mixer: str = "attn"  # attn | mamba | hymba (parallel attn+mamba)
    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_seq: int = 0  # encoder frame count (stub frontend output length)
    # --- multimodal stub ---
    n_patches: int = 0  # vision stub patch-embedding count
    # --- norm / act ---
    act: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attn_free(self) -> bool:
        return self.mixer == "mamba"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing (SSM or sliding-window)."""
        return self.mixer in ("mamba", "hymba") or self.sliding_window > 0

    def has_decoder(self) -> bool:
        return True  # all assigned archs generate tokens (whisper is enc-dec)

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top_k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_like = dataclasses.replace(self, n_experts=0, n_shared_experts=0, top_k=0)
        base = dense_like.param_count() - self.n_layers * (
            3 * d * f if self.act == "swiglu" else 2 * d * f)
        per_layer = (self.top_k + self.n_shared_experts) * 3 * d * f + d * self.n_experts
        return base + self.n_layers * per_layer

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.hd
        per_layer = 0
        if self.mixer in ("attn", "hymba"):
            qkv = d * (self.n_heads + 2 * self.n_kv_heads) * hd + d * d  # + out
            per_layer += qkv
        if self.mixer in ("mamba", "hymba"):
            di = self.d_inner
            per_layer += d * (2 * di + 2 * self.ssm_state + self.n_ssm_heads) + di * d
        if self.is_moe:
            per_layer += self.n_experts * 3 * d * f + self.n_shared_experts * 3 * d * f
            per_layer += d * self.n_experts  # router
        else:
            n_mats = 3 if self.act == "swiglu" else 2
            per_layer += n_mats * d * f
        layers = self.n_layers + self.enc_layers
        emb = v * d * (1 if self.tie_embeddings else 2)
        return layers * per_layer + emb
