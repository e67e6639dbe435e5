"""Plain PyTorch versions of the diagonal-parity encode and scrub, built on
`core.reliability` (bit-exact with the reference's `encode_words` /
`correct_words`).  Same contract as ops.py; they work through the arena in
chunks of blocks (the code is block-local, so chunking is exact), which
bounds their int64 temporaries when they run on a full-width arena on the
card for comparison."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...core.reliability import WordEccConfig, correct_words, encode_words

__all__ = ["encode_parity_ref", "scrub_ref"]

CHUNK_BLOCKS = 1 << 20
BLOCK = 32


def encode_parity_ref(buf: torch.Tensor,
                      slopes: Tuple[int, ...] = (1, 2, -1)) -> torch.Tensor:
    cfg = WordEccConfig(slopes=tuple(slopes))
    n = buf.numel() // BLOCK
    out = torch.empty((n, len(slopes)), dtype=torch.int32, device=buf.device)
    for c0 in range(0, n, CHUNK_BLOCKS):
        c1 = min(n, c0 + CHUNK_BLOCKS)
        out[c0:c1] = encode_words(buf[c0 * BLOCK:c1 * BLOCK], cfg)
    return out


def scrub_ref(buf: torch.Tensor, parity: torch.Tensor,
              slopes: Tuple[int, ...] = (1, 2, -1),
              out_parity: Optional[torch.Tensor] = None):
    """Scrub `buf` in place against `parity` (row b % len(parity) for block
    b).  Parity corrections go to `out_parity` (every row), else in place
    when the table is per block, else they are dropped.  Returns (buf,
    corrected parity or None, counts (3,) int32)."""
    cfg = WordEccConfig(slopes=tuple(slopes))
    n, npb = buf.numel() // BLOCK, parity.shape[0]
    in_place = out_parity is None and npb == n
    counts = torch.zeros(3, dtype=torch.int32, device=buf.device)
    for c0 in range(0, n, CHUNK_BLOCKS):
        c1 = min(n, c0 + CHUNK_BLOCKS)
        rows = torch.arange(c0, c1, device=buf.device) % npb
        chunk = buf[c0 * BLOCK:c1 * BLOCK]
        fixed, par2, rep = correct_words(chunk, parity[rows], cfg)
        chunk.copy_(fixed)
        if in_place:
            parity[c0:c1] = par2
        elif out_parity is not None:
            out_parity[c0:c1] = par2
        counts += torch.stack(list(rep))
    return buf, parity if in_place else out_parity, counts
