"""Word-level bit operations (port of `repro.core.bitops`): rotations,
population count and bit position of packed words, the float <-> raw-bit
views, and the bit-plane and trial packing of the netlist engines.

Packed words live in ``torch.int32`` storage, which holds the same 32 bits
as the reference's uint32: torch cannot shift, subtract or sum
``torch.uint32`` tensors.  The plain versions widen to int64, where a word's
unsigned value fits, do the arithmetic there and mask to 32 bits.
"""
from __future__ import annotations

import torch

__all__ = ["MASK32", "PACK", "as_u64", "as_i32", "rotl32", "rotr32",
           "popcount32", "bit_position", "float_view_u32", "u32_view_float",
           "as_unsigned", "to_bits", "from_bits", "pack_trials",
           "unpack_trials"]

MASK32 = 0xFFFFFFFF
#: trials packed per 32-bit lane word (the crossbar row-parallel axis)
PACK = 32


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


def rotr32(x: torch.Tensor, r) -> torch.Tensor:
    """Rotate-right 32-bit words by r: int32 words or unsigned values in
    int64 in, unsigned values in int64 out."""
    return rotl32(as_unsigned(x), (32 - r % 32) % 32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of unsigned 32-bit values held in int64 -> int32."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & MASK32) >> 24).to(torch.int32)


def as_unsigned(x: torch.Tensor) -> torch.Tensor:
    """Integer values as int64, int32 words read as unsigned."""
    return as_u64(x) if x.dtype == torch.int32 else x.to(torch.int64)


def bit_position(x: torch.Tensor) -> torch.Tensor:
    """Index of the single set bit of each 32-bit word -> int32 in [0, 32);
    0 for 0.  As the reference, a word with several set bits gives the sum
    of their indices."""
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    isset = (as_unsigned(x)[..., None] >> shifts) & 1
    return (isset * shifts).sum(-1).to(torch.int32)


#: raw-bit storage of each float dtype: the reference's u32 / u16 views,
#: held in the signed integer of the same width (the same bits)
_RAW = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
        torch.float16: torch.int16, torch.int32: torch.int32}


def float_view_u32(x: torch.Tensor) -> torch.Tensor:
    """The raw bits of a float32 / bfloat16 / float16 / int32 tensor: an
    int32 view for 32-bit dtypes, an int16 view for 16-bit ones (the
    reference's uint32 / uint16; it has no float16 case)."""
    if x.dtype not in _RAW:
        raise TypeError(f"unsupported dtype {x.dtype}")
    return x.view(_RAW[x.dtype])


def u32_view_float(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of `float_view_u32`: integer bits (int16, int32, or unsigned
    values in int64) viewed as `dtype`; a 16-bit dtype takes the low 16
    bits of each value, a 32-bit one the low 32."""
    if dtype not in _RAW:
        raise TypeError(f"unsupported dtype {dtype}")
    if _RAW[dtype] == torch.int16:
        if bits.dtype != torch.int16:
            low = bits.to(torch.int64) & 0xFFFF
            bits = ((low ^ 0x8000) - 0x8000).to(torch.int16)
        return bits.view(dtype)
    if bits.dtype != torch.int32:
        bits = as_i32(bits.to(torch.int64) & MASK32)
    return bits.view(dtype)


def to_bits(x: torch.Tensor, width: int) -> torch.Tensor:
    """Unpack integers into a bit-plane, LSB first: (...,) -> bool
    (..., width).  int32 words are read as unsigned."""
    shifts = torch.arange(width, dtype=torch.int64, device=x.device)
    return ((as_unsigned(x)[..., None] >> shifts) & 1).to(torch.bool)


def from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a bit-plane (..., width) LSB first into integers (...,): int32
    words (the same 32 bits as the reference's uint32) for width <= 32,
    int64 above."""
    width = bits.shape[-1]
    shifts = torch.arange(width, dtype=torch.int64, device=bits.device)
    vals = (bits.to(torch.int64) << shifts).sum(-1)
    return as_i32(vals) if width <= 32 else vals


def pack_trials(bits: torch.Tensor) -> torch.Tensor:
    """Pack the leading *trials* axis 32 per word, trial-major.

    bits: bool (trials, ...) -> int32 (ceil(trials/32), ...) with trial t in
    bit t % 32 of word t // 32, padding lanes 0: the packed-state layout of
    the netlist engines (core/scheduler.py, kernels/netlist_exec,
    kernels/crossbar_nor).
    """
    t = bits.shape[0]
    pad = (-t) % PACK
    if pad:
        bits = torch.cat([bits, bits.new_zeros((pad,) + bits.shape[1:])])
    bits = bits.reshape((-1, PACK) + bits.shape[1:]).to(torch.int64)
    shifts = torch.arange(PACK, dtype=torch.int64, device=bits.device)
    shifts = shifts.reshape((1, PACK) + (1,) * (bits.ndim - 2))
    return as_i32((bits << shifts).sum(1))


def unpack_trials(words: torch.Tensor, trials: int) -> torch.Tensor:
    """Inverse of pack_trials: int32 (tw, ...) -> bool (trials, ...)."""
    shifts = torch.arange(PACK, dtype=torch.int64, device=words.device)
    shifts = shifts.reshape((1, PACK) + (1,) * (words.ndim - 1))
    bits = ((words.to(torch.int64)[:, None] >> shifts) & 1).to(torch.bool)
    return bits.reshape((-1,) + tuple(words.shape[1:]))[:trials]
