"""Public TMR-vote op: per-bit 2-of-3 majority of three same-shape tensors
of any dtype, voted on their raw bits (bf16 votes exactly as the
reference's u16 -> u32 path, since voting bits ignores layout).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  `out` may be one of the inputs (vote in place) -- the engine votes
a KV cache into copy 0 and copies it to the others."""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from . import kernel
from .ref import vote_ref

__all__ = ["vote"]


def vote(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    for t in (b, c) + ((out,) if out is not None else ()):
        if t.shape != a.shape or t.dtype != a.dtype or t.device != a.device:
            raise ValueError(f"vote: mismatched operands {a.dtype} "
                             f"{tuple(a.shape)} {a.device} vs {t.dtype} "
                             f"{tuple(t.shape)} {t.device}")
    if a.device.type == "cpu":
        voted = vote_ref(a, b, c)
        return voted if out is None else out.copy_(voted)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if not all(t.is_contiguous() for t in (a, b, c)):
        raise ValueError("vote: the kernel takes contiguous operands")
    if out is None:
        out = torch.empty_like(a)
    elif not out.is_contiguous():
        raise ValueError("vote: `out` must be contiguous")
    kernel.vote(a, b, c, out)
    _build.count_launch("tmr_vote")
    return out
