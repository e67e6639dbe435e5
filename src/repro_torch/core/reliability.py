"""Word-level diagonal-parity code (port of the word functions of
`repro.core.reliability`): the plain version behind
`kernels/diag_parity/ref.py`.

A block is 32 consecutive words, a 32 x 32 bit matrix; the slope-s parity
word is ``XOR_i rotl32(w_i, s*i)``.  Slopes (1, 2) locate a single flipped
bit, every other slope must agree with that location.  Words are int32
storage; the arithmetic runs in int64 masked to 32 bits (`core.bitops`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from .arena import BLOCK
from .bitops import MASK32, as_i32, as_u64, popcount32, rotl32

__all__ = ["WordEccConfig", "ScrubReport", "encode_words", "syndrome_words",
           "correct_words"]


@dataclasses.dataclass(frozen=True)
class WordEccConfig:
    slopes: Tuple[int, ...] = (1, 2, -1)

    @property
    def n_parity_words(self) -> int:
        return len(self.slopes)


class ScrubReport(NamedTuple):
    corrected: torch.Tensor      # int32: blocks with a single bit corrected
    parity_fixed: torch.Tensor   # int32: blocks where a check word was fixed
    uncorrectable: torch.Tensor  # int32: blocks with >= 2 errors


def _xor_reduce_rows(x: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis (length a power of two) by halving."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] ^ x[..., half:]
    return x[..., 0]


def _encode_u64(blocks: torch.Tensor, slopes: Tuple[int, ...]) -> torch.Tensor:
    i = torch.arange(BLOCK, dtype=torch.int64, device=blocks.device)
    return torch.stack([_xor_reduce_rows(rotl32(blocks, (s * i) % BLOCK))
                        for s in slopes], dim=-1)


def _blocks(words: torch.Tensor) -> torch.Tensor:
    if words.ndim != 1 or words.numel() % BLOCK:
        raise ValueError(f"expected a flat word buffer of whole blocks, "
                         f"got shape {tuple(words.shape)}")
    return as_u64(words).view(-1, BLOCK)


def encode_words(words: torch.Tensor,
                 cfg: WordEccConfig = WordEccConfig()) -> torch.Tensor:
    """Parity words of a flat int32 buffer: (n_blocks, n_families) int32.

    parity[b, f] = XOR_i rotl32(words[b*32 + i], slopes[f] * i)"""
    return as_i32(_encode_u64(_blocks(words), cfg.slopes))


def syndrome_words(words: torch.Tensor, parity: torch.Tensor,
                   cfg: WordEccConfig = WordEccConfig()) -> torch.Tensor:
    return encode_words(words, cfg) ^ parity


def correct_words(words: torch.Tensor, parity: torch.Tensor,
                  cfg: WordEccConfig = WordEccConfig()):
    """Locate and correct one flipped bit per 32-word block.

    For an error in data word i0, bit j0 the slope-s syndrome is one-hot at
    k_s = (j0 + s*i0) mod 32; slopes (1, 2) give i0 = k_2 - k_1 and
    j0 = k_1 - i0.  Returns new (words, parity, ScrubReport); the inputs are
    not modified."""
    slopes = list(cfg.slopes)
    blocks = _blocks(words)
    syn = _encode_u64(blocks, cfg.slopes) ^ as_u64(parity)     # (B, F)
    pop = popcount32(syn)
    hot = popcount32((syn - 1) & MASK32).to(torch.int64)       # one-hot index
    nonzero = pop > 0
    onehot = pop == 1
    n_nonzero = nonzero.sum(-1)

    ia, ib = slopes.index(1), slopes.index(2)
    i0 = (hot[:, ib] - hot[:, ia]) % BLOCK
    j0 = (hot[:, ia] - i0) % BLOCK
    consistent = torch.ones_like(nonzero[:, 0])
    for f, s in enumerate(slopes):
        consistent &= hot[:, f] == (j0 + s * i0) % BLOCK

    data_err = (n_nonzero == len(slopes)) & onehot.all(-1) & consistent
    parity_err = (n_nonzero == 1) & (onehot | ~nonzero).all(-1)
    uncorrectable = (n_nonzero > 0) & ~data_err & ~parity_err

    flip = torch.where(data_err, torch.ones_like(j0) << j0,
                       torch.zeros_like(j0))
    row = torch.arange(BLOCK, device=words.device)[None, :] == i0[:, None]
    fixed = blocks ^ (row.to(torch.int64) * flip[:, None])
    parity_fix = torch.where(parity_err[:, None] & nonzero, syn,
                             torch.zeros_like(syn))
    report = ScrubReport(
        corrected=data_err.sum(dtype=torch.int32),
        parity_fixed=parity_err.sum(dtype=torch.int32),
        uncorrectable=uncorrectable.sum(dtype=torch.int32))
    return (as_i32(fixed.reshape(-1)),
            as_i32(as_u64(parity) ^ parity_fix), report)
