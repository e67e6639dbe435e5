"""Per-bit 2-of-3 majority voters (port of `repro.core.tmr`, the voters).

Voting is per bit, the Minority3 gate's majority: any single corrupted copy
is corrected exactly, including NaN-producing flips in float words.
"""
from __future__ import annotations

import torch

__all__ = ["vote_bits", "vote_words", "vote_array"]


def vote_bits(a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor) -> torch.Tensor:
    """Per-bit majority of three boolean bit-planes."""
    return (a & b) | (b & c) | (a & c)


def vote_words(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """Per-bit majority on integer words."""
    return (a & b) | (b & c) | (a & c)


_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
         torch.float16: torch.int16, torch.float64: torch.int64}


def vote_array(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """Per-bit majority of arbitrary tensors; floats vote on their raw bits
    (a bit view, so bf16 votes exactly as the reference's u16 path)."""
    if a.dtype == torch.bool:
        return vote_bits(a, b, c)
    if a.dtype in _BITS:
        bits = _BITS[a.dtype]
        return vote_words(a.view(bits), b.view(bits),
                          c.view(bits)).view(a.dtype)
    return vote_words(a, b, c)
