"""Public Hsiao SEC-DED ops over a flat int32 word buffer (the packed
arena): `encode_hsiao` (protect/refresh) and `scrub` (fused syndrome ->
classify -> correct, per word).

Same contract as kernels/diag_parity/ops.py: `scrub` corrects the buffer
in place (only flagged words change), and several same-layout copies
stacked into one buffer are scrubbed in one launch against one shared
check table (row b % len(parity)), with the per-copy corrected rows
written to `out_parity` -- how `hsiao+tmr` scrubs three copies of phi3-mini
against one 3.34 GB table instead of three.

A CPU tensor takes the plain version (ref.py); a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .. import _build
from ..diag_parity.ops import BLOCK, _check_buf, _check_table
from . import kernel
from .code import N_CHECKS
from .ref import encode_hsiao_ref, scrub_hsiao_ref

__all__ = ["encode_hsiao", "scrub", "scrub_sharded"]


def encode_hsiao(buf: torch.Tensor) -> torch.Tensor:
    """Check table (n_blocks, 7) int32 of a flat word buffer.  The kernel
    refuses (RuntimeError) a CUDA buffer that is not 16-byte aligned; a view
    that starts on a block boundary is."""
    _check_buf(buf)
    if buf.device.type == "cpu":
        return encode_hsiao_ref(buf)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    parity = torch.empty((buf.numel() // BLOCK, N_CHECKS), dtype=torch.int32,
                         device=buf.device)
    kernel.encode(buf, parity)
    _build.count_launch("encode_hsiao")
    return parity


def scrub(buf: torch.Tensor, parity: torch.Tensor,
          out_parity: Optional[torch.Tensor] = None):
    """Scrub `buf` in place against its check table.

    parity: (n_pblocks, 7) with n_pblocks dividing the buffer's block count
    (block b reads row b % n_pblocks).  Corrected rows go to `out_parity`
    ((n_blocks, 7), every row written) when given, else in place when the
    table is per block, else they are dropped.  Returns (buf, corrected
    parity or None, counts (3,) int32: corrected, parity_fixed,
    uncorrectable -- per word)."""
    _check_buf(buf)
    n = buf.numel() // BLOCK
    if n == 0:
        return buf, parity, torch.zeros(3, dtype=torch.int32,
                                        device=buf.device)
    npb = parity.shape[0] if parity.ndim == 2 else -1
    if npb < 1 or n % npb:
        raise ValueError(f"parity rows {tuple(parity.shape)} do not divide "
                         f"{n} blocks")
    _check_table(parity, npb, N_CHECKS, buf, "parity")
    if out_parity is not None:
        _check_table(out_parity, n, N_CHECKS, buf, "out_parity")
    if buf.device.type == "cpu":
        return scrub_hsiao_ref(buf, parity, out_parity)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    counts = torch.zeros(3, dtype=torch.int32, device=buf.device)
    in_place = out_parity is None and npb == n
    target = parity if in_place else out_parity
    kernel.scrub(buf, parity, target, not in_place, counts)
    _build.count_launch("scrub_hsiao", f"words {buf.numel()}")
    return buf, target, counts


def scrub_sharded(buf: torch.Tensor, parity: torch.Tensor, *, mesh=None,
                  axes: Sequence[str] = ("copy", "data", "model"),
                  local_scrub: Optional[Callable] = None):
    """`scrub` with the arena block axis cut into one range per rank and
    the (3,) counts summed (`kernels.sharded`); the op is word-local, so
    per-range launches compose exactly.  Whole arena in and out, as
    `diag_parity.scrub_sharded`.  With mesh=None this IS `scrub`."""
    if local_scrub is None:
        def local_scrub(b, p):
            return scrub(b, p)
    from ..sharded import shard_scrub
    return shard_scrub(local_scrub, mesh, axes, buf, parity)
