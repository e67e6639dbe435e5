"""Plain PyTorch version of the fused inject+scrub: XOR the mask in, then
the diagonal-parity scrub's plain version (bit-exact with the reference's
`inject_scrub_ref`).  Same contract as ops.py."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...core.bitops import as_u64, popcount32
from ..diag_parity.ref import CHUNK_BLOCKS, scrub_ref

__all__ = ["inject_scrub_ref"]

BLOCK = 32


def inject_scrub_ref(buf: torch.Tensor, parity: torch.Tensor,
                     mask: torch.Tensor,
                     slopes: Tuple[int, ...] = (1, 2, -1),
                     out_parity: Optional[torch.Tensor] = None):
    """buf ^= mask, then scrub in place.  Returns (buf, corrected parity or
    None, counts (4,) int32: injected, corrected, parity_fixed,
    uncorrectable)."""
    injected = torch.zeros((), dtype=torch.int32, device=buf.device)
    step = CHUNK_BLOCKS * BLOCK
    for c0 in range(0, buf.numel(), step):
        m = mask[c0:c0 + step]
        injected += popcount32(as_u64(m)).sum(dtype=torch.int32)
        buf[c0:c0 + step] ^= m
    buf, par, counts = scrub_ref(buf, parity, slopes, out_parity)
    return buf, par, torch.cat([injected[None], counts])
