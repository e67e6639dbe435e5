"""Block-sharded arena scrubs (port of `repro.kernels.sharded`, DESIGN.md
§14).

The packed arena is a flat int32 buffer of 32-word ECC blocks, and every
scrub op is block-local: block i's syndrome depends only on block i's
words and parity row.  So cutting the block axis into one contiguous range
per rank and running the single-device op on each range is exactly the
single-device result, and the int32 count vectors sum exactly.

The reference zero-pads the block axis to a multiple of the shard count so
`shard_map` gets equal shards.  The ranges here are cut from that padded
length (``per = ceil(n_blocks / shards)`` blocks a rank), and a rank whose
range reaches into the padding runs on its real blocks only: padding
blocks are zero words with zero parity, syndrome-clean, and would add
nothing to the counts.  On the card each rank launches the CUDA kernel on
its range; on the CPU the plain version runs.

Where every rank needs the whole repaired arena back (`shard_scrub`),
the ranks swap only their corrections -- word index and repaired value
(`swap_fixes`) -- never the arena: the traffic follows the faults, not
the arena's size.  The serving store's build (`launch.placement`) needs
no swap: each rank scrubs the range it holds alone (`scrub_range`).
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

__all__ = ["BLOCK", "scrub_axes", "block_range", "shard_scrub",
           "scrub_range", "scrub_joined", "swap_fixes"]

BLOCK = 32


def scrub_axes(mesh, axes: Sequence[str] = ("copy", "data", "model"),
               ) -> Tuple[str, ...]:
    """Mesh axes the arena block dimension shards over: every axis of
    `axes` the mesh has, so the scrub uses the whole machine (the copy
    axis included: scrubbing is state maintenance, each TMR copy scrubbed
    where it lives)."""
    return tuple(a for a in axes if a in mesh.axis_names)


def block_range(n_blocks: int, shards: int, index: int) -> Tuple[int, int]:
    """[lo, hi) of the real blocks shard `index` of `shards` owns: ranges of
    ceil(n_blocks / shards) blocks of the zero-padded block axis, clipped
    to the real blocks."""
    per = -(-n_blocks // shards) if shards else n_blocks
    lo = min(n_blocks, index * per)
    return lo, min(n_blocks, lo + per)


def scrub_range(local_fn: Callable, mesh, axes: Sequence[str],
                buf: torch.Tensor, parity: torch.Tensor,
                *flat_extra: torch.Tensor):
    """`local_fn` on this rank's own block range -- `buf`, `parity` and
    `flat_extra` hold that range alone (`block_range` of the scrub axes),
    as a rank that never had the rest holds it -- with the counts summed
    over the ranks of the scrub axes.  Returns (fixed, parity', counts)."""
    axes = scrub_axes(mesh, axes)
    fixed, par2, counts = local_fn(buf, parity, *flat_extra)
    # the kernels' counters are int32 on the buffer's device; the sum runs
    # in place over the scrub group (gloo or nccl)
    return fixed, par2, mesh.all_reduce(counts.clone(), axes)


def scrub_joined(local_fn: Callable, mesh, axes: Sequence[str],
                 whole: torch.Tensor, parity: torch.Tensor, lo: int,
                 *flat_extra: torch.Tensor):
    """`local_fn` on the block range of `whole` that starts at block `lo`
    and that `parity` (this rank's range only) covers, with the counts
    summed over the scrub axes; then every rank's corrections of the scrub
    group are joined into `whole` on every rank (`swap_fixes`), so each
    rank's `whole` is the whole repaired arena.  `flat_extra` holds the
    range alone, like `parity`.  Returns (parity', counts)."""
    axes = scrub_axes(mesh, axes)
    rng = whole[lo * BLOCK:(lo + parity.shape[0]) * BLOCK]
    alone = mesh.group_size(axes) <= 1
    # a group of one has nothing to swap, and keeps no copy of its range
    before = None if alone else rng.clone()
    fixed, par2, counts = scrub_range(local_fn, mesh, axes, rng, parity,
                                      *flat_extra)
    if alone:
        if fixed.data_ptr() != rng.data_ptr():
            rng.copy_(fixed)
        return par2, counts
    idx, val = swap_fixes(mesh, axes, before, fixed, lo * BLOCK)
    del before
    whole[idx] = val
    return par2, counts


def shard_scrub(local_fn: Callable, mesh, axes: Sequence[str],
                buf: torch.Tensor, parity: torch.Tensor,
                *flat_extra: torch.Tensor):
    """The reference's `shard_scrub` contract: the whole arena in, the
    whole repaired arena, its parity and the summed counts out (every rank
    holds all of it; `buf` and `parity` are repaired in place).  Each rank
    scrubs its block range and the ranks swap their corrections of words
    and parity rows (`scrub_joined`).  Without a mesh, or on a one-rank
    scrub group, this is ``local_fn`` itself."""
    if mesh is None or mesh.group_size(scrub_axes(mesh, axes)) <= 1:
        return local_fn(buf, parity, *flat_extra)
    axes = scrub_axes(mesh, axes)
    lo, hi = block_range(parity.shape[0], mesh.group_size(axes),
                         mesh.index_in(axes))
    before = parity[lo:hi].clone()
    par2, counts = scrub_joined(local_fn, mesh, axes, buf, before.clone(),
                                lo, *(x[lo * BLOCK:hi * BLOCK]
                                      for x in flat_extra))
    # the parity rows' corrections join the same way, row-major words
    row = parity[0].numel() if parity.ndim > 1 and parity.shape[0] else 1
    idx, val = swap_fixes(mesh, axes, before.view(-1), par2.reshape(-1),
                          lo * row)
    parity.view(-1)[idx] = val
    return buf, parity, counts


def swap_fixes(mesh, axes: Sequence[str], before: torch.Tensor,
               after: torch.Tensor, offset: int):
    """Every rank's corrections of the scrub group, on every rank: (global
    word indices int64, repaired words int32).  `before` and `after` are
    this rank's range (flat, from word `offset` of the whole) before and
    after its scrub.  Each rank puts its own at its offset into zeros and
    a SUM all-reduce joins them (exact: a slot is one rank's value plus
    zeros); only the corrections move, never the arena."""
    mine = (after != before).nonzero().view(-1)
    n, k = mesh.group_size(axes), mesh.index_in(axes)
    dev = after.device
    sizes = torch.zeros(max(n, 1), dtype=torch.int64, device=dev)
    sizes[k] = mine.numel()
    sizes = mesh.all_reduce(sizes, axes).tolist()
    at = sum(sizes[:k])
    idx = torch.zeros(sum(sizes), dtype=torch.int64, device=dev)
    val = torch.zeros(sum(sizes), dtype=after.dtype, device=dev)
    idx[at:at + mine.numel()] = mine + offset
    val[at:at + mine.numel()] = after[mine]
    return mesh.all_reduce(idx, axes), mesh.all_reduce(val, axes)
