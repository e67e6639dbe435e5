"""Plain PyTorch versions of the Hsiao SEC-DED encode and scrub.

Words are int32 storage, the arithmetic int64 masked to 32 bits.  The
syndrome of each word is classified through a 128-entry table (data bit k,
check bit j, clean, or uncorrectable), which gives the reference's result:
a data column flips that bit, a unit vector heals the stored check bit,
any other nonzero syndrome is a detected double error and the word stays as
it is.  Counts are per word.  Same contract as ops.py; the work goes
through the arena in chunks of blocks (the code is word-local, so chunking
is exact), which bounds the int64 temporaries on a full-width arena.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.bitops import MASK32, as_i32, as_u64, popcount32
from .code import CHECK_MASKS, DATA_COLUMNS, N_CHECKS

__all__ = ["encode_hsiao_ref", "scrub_hsiao_ref", "syndrome_classes"]

BLOCK = 32
CHUNK_BLOCKS = 1 << 18
CLS_CHECK, CLS_CLEAN, CLS_UNC = 32, 64, 65


def syndrome_classes() -> list:
    """The 128-entry syndrome table: k < 32 data bit k, 32 + j check bit
    j, 64 clean, 65 uncorrectable."""
    lut = [CLS_UNC] * (1 << N_CHECKS)
    lut[0] = CLS_CLEAN
    for j in range(N_CHECKS):
        lut[1 << j] = CLS_CHECK + j
    for k, col in enumerate(DATA_COLUMNS):
        lut[col] = k
    return lut


def _check_bits(w: torch.Tensor) -> torch.Tensor:
    """(n, 32) unsigned words in int64 -> (n, 32, 7) int64 check bits."""
    return torch.stack([popcount32(w & m).to(torch.int64) & 1
                        for m in CHECK_MASKS], dim=-1)


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """(n, 32, 7) 0/1 -> (n, 7) int32, bit i of word j from [., i, j]."""
    lane = torch.arange(BLOCK, dtype=torch.int64, device=bits.device)
    return as_i32((bits << lane[None, :, None]).sum(dim=1) & MASK32)


def encode_hsiao_ref(buf: torch.Tensor) -> torch.Tensor:
    """Check table (n_blocks, 7) int32 of a flat int32 word buffer."""
    n = buf.numel() // BLOCK
    out = torch.empty((n, N_CHECKS), dtype=torch.int32, device=buf.device)
    for c0 in range(0, n, CHUNK_BLOCKS):
        c1 = min(n, c0 + CHUNK_BLOCKS)
        w = as_u64(buf[c0 * BLOCK:c1 * BLOCK]).view(-1, BLOCK)
        out[c0:c1] = _pack(_check_bits(w))
    return out


def scrub_hsiao_ref(buf: torch.Tensor, parity: torch.Tensor,
                    out_parity: Optional[torch.Tensor] = None):
    """Scrub `buf` in place against `parity` (row b % len(parity) for block
    b).  Check-row corrections go to `out_parity` (every row), else in place
    when the table is per block, else they are dropped.  Returns (buf,
    corrected parity or None, counts (3,) int32: corrected, parity_fixed,
    uncorrectable words)."""
    n, npb = buf.numel() // BLOCK, parity.shape[0]
    in_place = out_parity is None and npb == n
    dev = buf.device
    lut = torch.tensor(syndrome_classes(), dtype=torch.int64, device=dev)
    lane = torch.arange(BLOCK, dtype=torch.int64, device=dev)
    jw = torch.arange(N_CHECKS, dtype=torch.int64, device=dev)
    counts = torch.zeros(3, dtype=torch.int32, device=dev)
    for c0 in range(0, n, CHUNK_BLOCKS):
        c1 = min(n, c0 + CHUNK_BLOCKS)
        chunk = buf[c0 * BLOCK:c1 * BLOCK]
        w = as_u64(chunk).view(-1, BLOCK)
        rows = torch.arange(c0, c1, device=dev) % npb
        p = as_u64(parity[rows])                                # (m, 7)
        stored = (p[:, None, :] >> lane[None, :, None]) & 1     # (m, 32, 7)
        s = ((_check_bits(w) ^ stored) << jw).sum(-1)           # (m, 32)
        cls = lut[s]
        data = cls < BLOCK
        check = (cls >= CLS_CHECK) & (cls < CLS_CHECK + N_CHECKS)
        flip = torch.where(data, torch.ones_like(cls) << (cls % BLOCK),
                           torch.zeros_like(cls))
        chunk.copy_(as_i32(w ^ flip).view(-1))
        unit = (cls[..., None] == CLS_CHECK + jw).to(torch.int64)
        p2 = _pack(stored ^ unit)
        if in_place:
            parity[c0:c1] = p2
        elif out_parity is not None:
            out_parity[c0:c1] = p2
        counts += torch.stack([data.sum(), check.sum(),
                               (cls == CLS_UNC).sum()]).to(torch.int32)
    return buf, parity if in_place else out_parity, counts
