"""whisper-medium — enc-dec, stub conv frontend [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-medium", family="audio", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=51865,
    act="gelu", norm="layernorm", enc_layers=24, enc_seq=1500,
)

SMOKE = ModelConfig(
    arch_id="whisper-smoke", family="audio", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
    act="gelu", norm="layernorm", enc_layers=2, enc_seq=32,
)
