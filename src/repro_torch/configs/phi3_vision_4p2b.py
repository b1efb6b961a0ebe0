"""phi-3-vision-4.2b — phi3-mini backbone + stub CLIP patches [hf:microsoft/Phi-3-vision-128k-instruct]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi-3-vision-4.2b", family="vlm", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32064,
    n_patches=256,  # stub frontend: precomputed patch embeddings
)

SMOKE = ModelConfig(
    arch_id="phi3v-smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=128, n_patches=8,
)
