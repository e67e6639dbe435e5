from .config import ModelConfig
from . import attention, nn, params, steps, transformer

__all__ = ["ModelConfig", "attention", "nn", "params", "steps",
           "transformer"]
