"""mamba2-1.3b — attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
    mixer="mamba", ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    head_dim=64, tie_embeddings=True,
)

SMOKE = ModelConfig(
    arch_id="mamba2-smoke", family="ssm", n_layers=2, d_model=64,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=128,
    mixer="mamba", ssm_state=16, ssm_head_dim=16, head_dim=16, tie_embeddings=True,
)
