"""Assigned-architecture registry: --arch <id> resolves here."""

from . import (
    deepseek_moe_16b, granite_20b, hymba_1p5b, mamba2_1p3b,
    moonshot_v1_16b_a3b, phi3_medium_14b, phi3_vision_4p2b,
    qwen1p5_110b, smollm_135m, whisper_medium,
)

_MODULES = {
    "hymba-1.5b": hymba_1p5b,
    "phi-3-vision-4.2b": phi3_vision_4p2b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "mamba2-1.3b": mamba2_1p3b,
    "smollm-135m": smollm_135m,
    "granite-20b": granite_20b,
    "qwen1.5-110b": qwen1p5_110b,
    "phi3-medium-14b": phi3_medium_14b,
    "whisper-medium": whisper_medium,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, smoke: bool = False):
    mod = _MODULES[arch_id]
    return mod.SMOKE if smoke else mod.CONFIG
