"""Architecture registry of the port (the reference's ten archs); each
module defines CONFIG, the same published shape as the reference's, and
optionally RULES_OVERRIDES and SERVE_RULES_OVERRIDES (per-arch sharding
rule tweaks, training and serving) and TRAIN_POLICY (the training cell's
micro-batches and dtypes), as the reference's modules do."""
from __future__ import annotations

import importlib
from typing import Dict, List
from types import ModuleType

from ..models.config import ModelConfig

__all__ = ["ARCHS", "ALIASES", "DEFAULT_TRAIN_POLICY", "get_config",
           "get_rules_overrides", "get_train_policy", "list_archs"]

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


def _module(name: str) -> ModuleType:
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod not in ARCHS:
        raise KeyError(f"unknown arch {name!r} (one of {list_archs()})")
    return importlib.import_module(f".{mod}", __package__)


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_rules_overrides(name: str, serve: bool = False) -> dict:
    """The arch's sharding-rule overrides (logical axis -> mesh axes);
    with `serve`, its serving overrides on top."""
    m = _module(name)
    out = dict(getattr(m, "RULES_OVERRIDES", {}))
    if serve:
        out.update(getattr(m, "SERVE_RULES_OVERRIDES", {}))
    return out


#: defaults for training cells; config modules override via TRAIN_POLICY
DEFAULT_TRAIN_POLICY = {
    "microbatches": 16,        # gradient accumulation slices of the global batch
    "param_dtype": "float32",
    "opt_dtype": "float32",
    "grad_dtype": "float32",   # gradient-accumulator dtype
}


def get_train_policy(name: str) -> dict:
    return {**DEFAULT_TRAIN_POLICY, **getattr(_module(name), "TRAIN_POLICY",
                                              {})}


def list_archs() -> List[str]:
    return list(ALIASES.keys())
