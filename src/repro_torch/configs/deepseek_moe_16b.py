"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6 [arXiv:2401.06066]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=102400,
    n_experts=64, n_shared_experts=2, top_k=6,
)

SMOKE = ModelConfig(
    arch_id="deepseek-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=32, vocab=128,
    n_experts=8, n_shared_experts=2, top_k=2,
)
