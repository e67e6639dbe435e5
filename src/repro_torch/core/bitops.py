"""Word-level bit operations (port of `repro.core.bitops`, the subset the
word code uses).

Packed words live in ``torch.int32`` storage, which holds the same 32 bits
as the reference's uint32: torch cannot shift, subtract or sum
``torch.uint32`` tensors.  The plain versions widen to int64, where a word's
unsigned value fits, do the arithmetic there and mask to 32 bits.
"""
from __future__ import annotations

import torch

__all__ = ["MASK32", "as_u64", "as_i32", "rotl32", "popcount32"]

MASK32 = 0xFFFFFFFF


def as_u64(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> their unsigned values in int64 (no bit changes)."""
    return words.to(torch.int64) & MASK32


def as_i32(values: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 words with the same low 32 bits
    (the int64 -> int32 cast keeps the low bits)."""
    return values.to(torch.int32)


def rotl32(x: torch.Tensor, r) -> torch.Tensor:
    """Rotate-left unsigned 32-bit values held in int64 by r (an int or a
    broadcastable int64 tensor); the result is again in [0, 2**32).

    The diagonal of the paper's bit matrix maps to a rotation of the
    packed word (the barrel shifter)."""
    r = r % 32
    return ((x << r) | (x >> (32 - r))) & MASK32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of unsigned 32-bit values held in int64 -> int32."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & MASK32) >> 24).to(torch.int32)

