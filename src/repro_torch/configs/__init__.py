"""Architecture registry of the port (the archs ported so far); each
module defines CONFIG, the same published shape as the reference's."""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

__all__ = ["ARCHS", "ALIASES", "get_config", "list_archs"]

ARCHS: List[str] = ["phi3_mini_3p8b"]

#: canonical external ids (``--arch <id>``)
ALIASES: Dict[str, str] = {"phi3-mini-3.8b": "phi3_mini_3p8b"}


def get_config(name: str) -> ModelConfig:
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod not in ARCHS:
        raise KeyError(f"unknown or unported arch {name!r} "
                       f"(ported: {list_archs()})")
    return importlib.import_module(f".{mod}", __package__).CONFIG


def list_archs() -> List[str]:
    return list(ALIASES.keys())
