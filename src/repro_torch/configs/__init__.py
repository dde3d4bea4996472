"""Config registry: one module per assigned architecture.

``get_config(arch_id)`` returns the full-scale config (dry-run only);
``get_config(arch_id, smoke=True)`` returns the reduced same-family variant
used in CPU smoke tests (<=2 layers, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

ARCH_IDS = [
    "llava_next_mistral_7b",
    "yi_34b",
    "whisper_tiny",
    "gemma3_27b",
    "zamba2_1p2b",
    "falcon_mamba_7b",
    "minicpm_2b",
    "stablelm_1p6b",
    "arctic_480b",
    "deepseek_v3_671b",
]

# canonical dashed names from the assignment -> module name
ALIASES = {
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "yi-34b": "yi_34b",
    "whisper-tiny": "whisper_tiny",
    "gemma3-27b": "gemma3_27b",
    "zamba2-1.2b": "zamba2_1p2b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "minicpm-2b": "minicpm_2b",
    "stablelm-1.6b": "stablelm_1p6b",
    "arctic-480b": "arctic_480b",
    "deepseek-v3-671b": "deepseek_v3_671b",
}


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    mod_name = ALIASES.get(arch_id, arch_id)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False):
    return {a: get_config(a, smoke) for a in ARCH_IDS}
