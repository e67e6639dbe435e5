"""Public fused inject+scrub op: XOR a fault mask into a flat int32 word
buffer (the packed arena), then the diagonal-parity scrub, in one launch
and in place.  The mask is dense (one int32 word per buffer word), drawn
outside the kernel by a `faults.FaultModel`, so the kernel stays bit-exact
testable against ref.py.

Same parity contract as kernels/diag_parity/ops.py `scrub`.  A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from .. import _build
from ..diag_parity.ops import BLOCK, _check_aligned, _check_buf, _check_table
from . import kernel
from .ref import inject_scrub_ref

__all__ = ["inject_scrub", "inject_scrub_sharded"]


def inject_scrub(buf: torch.Tensor, parity: torch.Tensor,
                 mask: torch.Tensor, slopes: Tuple[int, ...] = (1, 2, -1),
                 out_parity: Optional[torch.Tensor] = None):
    """buf ^= mask, then scrub `buf` in place against `parity` (row
    b % len(parity) for block b).  Returns (buf, corrected parity or None,
    counts (4,) int32: injected, corrected, parity_fixed,
    uncorrectable)."""
    _check_buf(buf)
    slopes = tuple(int(s) for s in slopes)
    if 1 not in slopes or 2 not in slopes:
        raise ValueError(f"scrub needs the locating slopes 1 and 2, got "
                         f"{slopes}")
    if (mask.dtype != torch.int32 or mask.shape != buf.shape
            or not mask.is_contiguous() or mask.device != buf.device):
        raise ValueError(f"mask: expected a contiguous int32 "
                         f"{tuple(buf.shape)} on {buf.device}, got "
                         f"{mask.dtype} {tuple(mask.shape)} on {mask.device}")
    n = buf.numel() // BLOCK
    if n == 0:
        return buf, parity, torch.zeros(4, dtype=torch.int32,
                                        device=buf.device)
    npb = parity.shape[0] if parity.ndim == 2 else -1
    if npb < 1 or n % npb:
        raise ValueError(f"parity rows {tuple(parity.shape)} do not divide "
                         f"{n} blocks")
    _check_table(parity, npb, len(slopes), buf, "parity")
    if out_parity is not None:
        _check_table(out_parity, n, len(slopes), buf, "out_parity")
    if buf.device.type == "cpu":
        return inject_scrub_ref(buf, parity, mask, slopes, out_parity)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    _check_aligned(buf, mask)
    counts = torch.zeros(4, dtype=torch.int32, device=buf.device)
    in_place = out_parity is None and npb == n
    target = parity if in_place else out_parity
    kernel.inject_scrub(buf, mask, parity, target, not in_place, slopes,
                        counts)
    _build.count_launch("inject_scrub")
    return buf, target, counts


def inject_scrub_sharded(buf: torch.Tensor, parity: torch.Tensor,
                         mask: torch.Tensor,
                         slopes: Tuple[int, ...] = (1, 2, -1), *, mesh=None,
                         axes: Sequence[str] = ("copy", "data", "model"),
                         local_op: Optional[Callable] = None):
    """`inject_scrub` with the arena block axis cut into one range per rank
    and the (4,) counts summed (`kernels.sharded`).  The mask is cut with
    the buffer, so each rank corrupts and repairs only the blocks it owns;
    bit-exact against `inject_scrub`.  With mesh=None this IS
    `inject_scrub`."""
    if local_op is None:
        def local_op(b, p, m):
            return inject_scrub(b, p, m, slopes=tuple(slopes))
    from ..sharded import shard_scrub
    return shard_scrub(local_op, mesh, axes, buf, parity, mask)
