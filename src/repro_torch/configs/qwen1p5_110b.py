"""qwen1.5-110b — dense GQA with QKV bias [hf:Qwen/Qwen1.5-110B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-110b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=49152, vocab=152064, qkv_bias=True,
)

SMOKE = ModelConfig(
    arch_id="qwen-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab=128, qkv_bias=True,
)
