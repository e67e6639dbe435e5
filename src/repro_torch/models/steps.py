"""Serve step builders (port of `make_prefill_step` / `make_decode_step`
of `repro.models.steps`; no training steps)."""
from __future__ import annotations

from typing import Optional

import torch

from .config import ModelConfig
from .transformer import decode_step, prefill

__all__ = ["head_weights", "make_prefill_step", "make_decode_step"]


def head_weights(params: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["tok"].T            # (D, V)
    return params["embed"]["head"]


def _logits_last(params, cfg: ModelConfig, hidden: torch.Tensor):
    return (hidden @ head_weights(params, cfg).to(hidden.dtype)).float()


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_prefill_step(cfg: ModelConfig, cache_len: Optional[int] = None):
    """prefill_step(params, batch) -> (next_token (B,1), logits, cache)."""

    def prefill_step(params, batch):
        h_last, cache = prefill(params, cfg, batch, cache_len)
        logits = _logits_last(params, cfg, h_last)
        return _greedy(logits), logits, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """decode_fn(params, token (B,1), cache) -> (next_token, logits, cache)."""

    def decode_fn(params, token, cache):
        h, cache = decode_step(params, cfg, token, cache)
        logits = _logits_last(params, cfg, h)
        return _greedy(logits), logits, cache

    return decode_fn
