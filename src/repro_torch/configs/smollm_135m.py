"""smollm-135m — llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="smollm-135m", family="dense", n_layers=30, d_model=576,
    n_heads=9, n_kv_heads=3, d_ff=1536, vocab=49152, tie_embeddings=True,
)

SMOKE = ModelConfig(
    arch_id="smollm-smoke", family="dense", n_layers=2, d_model=48,
    n_heads=3, n_kv_heads=1, d_ff=128, vocab=128, tie_embeddings=True,
)
