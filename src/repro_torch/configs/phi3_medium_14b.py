"""phi3-medium-14b — RoPE SwiGLU GQA [arXiv:2404.14219]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=10, d_ff=17920, vocab=100352,
)

SMOKE = ModelConfig(
    arch_id="phi3m-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab=128,
)
