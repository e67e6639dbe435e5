"""Plain version: full-score-matrix attention from the model stack."""
from __future__ import annotations

import torch

from ...models.attention import naive_attention


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) -> (B, Sq, H, hd)."""
    return naive_attention(q, k, v, causal=causal, window=window)
