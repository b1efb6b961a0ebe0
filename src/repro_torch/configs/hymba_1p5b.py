"""hymba-1.5b — hybrid parallel attention+Mamba heads [arXiv:2411.13676; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, d_ff=5504, vocab=32001,
    mixer="hymba", ssm_state=16, ssm_head_dim=64, ssm_expand=2,
    sliding_window=1024,  # hymba pairs global SSM state with local SWA
)

SMOKE = ModelConfig(
    arch_id="hymba-smoke", family="hybrid", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    mixer="hymba", ssm_state=8, ssm_head_dim=16, sliding_window=16,
)
