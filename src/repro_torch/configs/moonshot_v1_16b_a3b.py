"""moonshot-v1-16b-a3b — Moonlight MoE, 64 experts top-6 [hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=163840,
    n_experts=64, n_shared_experts=2, top_k=6,
)

SMOKE = ModelConfig(
    arch_id="moonshot-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=32, vocab=128,
    n_experts=8, n_shared_experts=1, top_k=2,
)
