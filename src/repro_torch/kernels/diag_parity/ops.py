"""Public diagonal-parity ops over a flat int32 word buffer (the packed
arena): `encode_parity` (protect/refresh) and `scrub` (fused encode ->
syndrome -> locate -> correct).

Where the reference returns new arrays, `scrub` corrects the buffer in
place -- only flagged words change -- so a full-width arena is scrubbed
without a second copy.  Several same-layout copies stacked into one buffer
are scrubbed in one launch against one shared parity table (row
b % len(parity)); the reference concatenates copies and tables instead.

A CPU tensor takes the plain version (ref.py); a CUDA tensor launches the
kernel or raises.  No host-side padding: the kernel masks the ragged edge.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from .. import _build
from . import kernel
from .ref import encode_parity_ref, scrub_ref

__all__ = ["encode_parity", "scrub", "scrub_sharded"]

BLOCK = 32


def _check_buf(buf: torch.Tensor) -> None:
    if buf.dtype != torch.int32 or buf.ndim != 1 or not buf.is_contiguous():
        raise ValueError(f"expected a contiguous 1-D int32 word buffer, got "
                         f"{buf.dtype} {tuple(buf.shape)}")
    if buf.numel() % BLOCK:
        raise ValueError(f"buffer length {buf.numel()} is not a whole "
                         f"number of {BLOCK}-word blocks")


def _check_table(t: torch.Tensor, rows: int, f: int, buf: torch.Tensor,
                 what: str) -> None:
    if (t.dtype != torch.int32 or tuple(t.shape) != (rows, f)
            or not t.is_contiguous() or t.device != buf.device):
        raise ValueError(f"{what}: expected contiguous int32 ({rows}, {f}) "
                         f"on {buf.device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_aligned(*bufs: torch.Tensor) -> None:
    """The scrub kernel stages blocks by 16-byte copies."""
    if any(b.data_ptr() % 16 for b in bufs):
        raise ValueError("the scrub kernel needs 16-byte aligned word "
                         "buffers (a view that starts on a block boundary "
                         "of an allocation is)")


def encode_parity(buf: torch.Tensor,
                  slopes: Tuple[int, ...] = (1, 2, -1)) -> torch.Tensor:
    """Parity table (n_blocks, len(slopes)) int32 of a flat word buffer."""
    _check_buf(buf)
    slopes = tuple(int(s) for s in slopes)
    if buf.device.type == "cpu":
        return encode_parity_ref(buf, slopes)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    parity = torch.empty((buf.numel() // BLOCK, len(slopes)),
                         dtype=torch.int32, device=buf.device)
    kernel.encode(buf, parity, slopes)
    _build.count_launch("encode_parity")
    return parity


def scrub(buf: torch.Tensor, parity: torch.Tensor,
          slopes: Tuple[int, ...] = (1, 2, -1),
          out_parity: Optional[torch.Tensor] = None):
    """Scrub `buf` in place against `parity`.

    parity: (n_pblocks, F) with n_pblocks dividing the buffer's block count
    (block b reads row b % n_pblocks).  Corrected parity goes to
    `out_parity` ((n_blocks, F), every row written) when given, else in
    place when the table is per block, else it is dropped.  Returns (buf,
    corrected parity or None, counts (3,) int32: corrected, parity_fixed,
    uncorrectable)."""
    _check_buf(buf)
    slopes = tuple(int(s) for s in slopes)
    if 1 not in slopes or 2 not in slopes:
        raise ValueError(f"scrub needs the locating slopes 1 and 2, got "
                         f"{slopes}")
    n = buf.numel() // BLOCK
    if n == 0:
        return buf, parity, torch.zeros(3, dtype=torch.int32,
                                        device=buf.device)
    npb = parity.shape[0] if parity.ndim == 2 else -1
    if npb < 1 or n % npb:
        raise ValueError(f"parity rows {tuple(parity.shape)} do not divide "
                         f"{n} blocks")
    _check_table(parity, npb, len(slopes), buf, "parity")
    if out_parity is not None:
        _check_table(out_parity, n, len(slopes), buf, "out_parity")
    if buf.device.type == "cpu":
        return scrub_ref(buf, parity, slopes, out_parity)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    _check_aligned(buf)
    counts = torch.zeros(3, dtype=torch.int32, device=buf.device)
    in_place = out_parity is None and npb == n
    target = parity if in_place else out_parity
    kernel.scrub(buf, parity, target, not in_place, slopes, counts)
    _build.count_launch("scrub")
    return buf, target, counts


def scrub_sharded(buf: torch.Tensor, parity: torch.Tensor,
                  slopes: Tuple[int, ...] = (1, 2, -1), *, mesh=None,
                  axes: Sequence[str] = ("copy", "data", "model"),
                  local_scrub: Optional[Callable] = None):
    """`scrub` with the arena block axis cut into one range per rank of
    `mesh`'s scrub axes (`kernels.sharded`) and the (3,) counts summed over
    them.  Bit-exact against `scrub`: the op is block-local, so per-range
    launches compose exactly.  `buf` and `parity` are the whole arena on
    every rank and come back repaired whole (each rank's range joined by
    an exact int32 all-reduce).  With mesh=None (or a one-rank mesh) this
    IS `scrub`.  `local_scrub` overrides the per-range op (the backend
    registry passes the `torch` or the `kernel` implementation)."""
    if local_scrub is None:
        def local_scrub(b, p):
            return scrub(b, p, slopes=tuple(slopes))
    from ..sharded import shard_scrub
    return shard_scrub(local_scrub, mesh, axes, buf, parity)
