"""Architecture registry of the port (the reference's ten archs); each
module defines CONFIG, the same published shape as the reference's."""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

__all__ = ["ARCHS", "ALIASES", "get_config", "list_archs"]

ARCHS: List[str] = [
    "deepseek_67b",
    "phi3_mini_3p8b",
    "nemotron_4_15b",
    "qwen2_5_14b",
    "llama4_maverick_400b_a17b",
    "phi3_5_moe_42b_a6p6b",
    "mamba2_130m",
    "llama_3_2_vision_11b",
    "recurrentgemma_2b",
    "seamless_m4t_medium",
]

#: canonical external ids (``--arch <id>``)
ALIASES: Dict[str, str] = {
    "deepseek-67b": "deepseek_67b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen2.5-14b": "qwen2_5_14b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6p6b",
    "mamba2-130m": "mamba2_130m",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}


def get_config(name: str) -> ModelConfig:
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod not in ARCHS:
        raise KeyError(f"unknown arch {name!r} (one of {list_archs()})")
    return importlib.import_module(f".{mod}", __package__).CONFIG


def list_archs() -> List[str]:
    return list(ALIASES.keys())
