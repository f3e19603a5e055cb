"""Architecture registry: ``--arch <id>`` -> ModelConfig."""
from __future__ import annotations

from typing import Dict

from repro_torch.common.config import ModelConfig

from repro_torch.configs.gemma_7b import CONFIG as _gemma
from repro_torch.configs.starcoder2_7b import CONFIG as _starcoder2
from repro_torch.configs.minicpm3_4b import CONFIG as _minicpm3
from repro_torch.configs.qwen3_0_6b import CONFIG as _qwen3
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon_mamba
from repro_torch.configs.grok_1_314b import CONFIG as _grok
from repro_torch.configs.deepseek_moe_16b import CONFIG as _deepseek
from repro_torch.configs.musicgen_medium import CONFIG as _musicgen
from repro_torch.configs.llama_3_2_vision_11b import CONFIG as _llama_vision
from repro_torch.configs.jamba_v0_1_52b import CONFIG as _jamba
from repro_torch.configs.llama_2_7b import CONFIG as _llama2

REGISTRY: Dict[str, ModelConfig] = {
    "gemma-7b": _gemma,
    "starcoder2-7b": _starcoder2,
    "minicpm3-4b": _minicpm3,
    "qwen3-0.6b": _qwen3,
    "falcon-mamba-7b": _falcon_mamba,
    "grok-1-314b": _grok,
    "deepseek-moe-16b": _deepseek,
    "musicgen-medium": _musicgen,
    "llama-3.2-vision-11b": _llama_vision,
    "jamba-v0.1-52b": _jamba,
    "llama-2-7b": _llama2,
}

ASSIGNED = tuple(k for k in REGISTRY if k != "llama-2-7b")


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
