"""granite-20b — llama-arch code model, MQA (kv=1) [arXiv:2405.04324]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-20b", family="dense", n_layers=52, d_model=6144,
    n_heads=48, n_kv_heads=1, d_ff=24576, vocab=49152, act="gelu",
)

SMOKE = ModelConfig(
    arch_id="granite-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=1, d_ff=256, vocab=128, act="gelu",
)
