"""Shared-memory plan of the levelized netlist kernel (csrc/netlist_exec.cu).

The kernel keeps a trial tile's live wire state on chip for all L levels,
as the TPU kernel keeps its whole state in VMEM.  The whole state does not
fit a CTA's 227 KB, but the live part does: a row needs a place on chip
only from the level that writes it to the last level that reads it.  This
module assigns those places ("slots") on the host, in numpy, once per
schedule:

* every row that some level reads gets a slot for the span from its writer
  level to its last reader; rows [0, base) hold theirs from the start;
* a slot is reused only by a row written after the slot's last read, so a
  level's reads never race its writes and one barrier a level suffices;
* a row nobody reads gets no slot: its value goes only to device memory.

Each slot (l, s) of the schedule becomes a descriptor of four uint16: the
slots of its three inputs and of its output (NO_SLOT for none).

The kernel's trial tile is the widest of TILES (words of 32 trials a CTA)
whose slots and mask ring fit the shared-memory budget, halved while the
halved tile's grid still fits the card in one wave (`launch_tile`: a grid
of fewer CTAs than SMs leaves SMs idle, and a CTA's time per level grows
with its tile).  Plans are cached by the exact bytes of (rows_in, base).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, Tuple

import numpy as np
import torch

__all__ = ["Plan", "plan", "launch_tile", "widest_tile", "TILES", "STAGES",
           "SMEM_BUDGET", "NO_SLOT"]

#: trial words a CTA may own, widest first
TILES = (32, 16, 8, 4, 2, 1)
#: levels of descriptors and masks in the kernel's shared ring (kStages)
STAGES = 3
#: dynamic shared memory a CTA may use on sm_90 (227 KB)
SMEM_BUDGET = 232448
#: descriptor entry of no slot
NO_SLOT = 0xFFFF


@dataclasses.dataclass(frozen=True)
class Plan:
    """Slot assignment of one schedule.

    desc:      (L, W, 4) uint16 -- slots of inputs a, b, c and of the
               output; out == NO_SLOT: nobody reads the row (with k reads
               a slot, (L, W, k + 1)).
    base_slot: (base,) int32 -- slot of row r < base, -1 if nobody reads it.
    n_slots:   slots the plan uses (the most rows live at once).
    """

    L: int
    W: int
    base: int
    n_slots: int
    desc: np.ndarray          # meaningful only when n_slots <= NO_SLOT
    base_slot: np.ndarray
    _on: dict = dataclasses.field(default_factory=dict, compare=False,
                                  repr=False)

    def on(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(desc as int16, base_slot) on `device`, copied there once."""
        key = str(device)
        if key not in self._on:
            self._on[key] = (
                torch.from_numpy(self.desc.view(np.int16)).to(device),
                torch.from_numpy(self.base_slot).to(device))
        return self._on[key]

    def stage_words(self, tile: int, n_masks: int) -> int:
        """32-bit words of one ring stage: a level's W descriptors and its
        mask rows, each rounded up to 16 bytes (the kernel's
        stage_words)."""
        return (-(-2 * self.W // 4) + -(-n_masks * tile * self.W // 4)) * 4

    def smem_bytes(self, tile: int, n_masks: int) -> int:
        """Dynamic shared memory of a CTA at `tile` words with `n_masks`
        mask planes: the ring (STAGES levels) and the slots."""
        return 4 * (STAGES * self.stage_words(tile, n_masks)
                    + tile * self.n_slots)

    def tile(self, n_masks: int, budget: int = SMEM_BUDGET) -> int:
        """The widest trial tile whose shared memory fits `budget` bytes
        (a smaller budget forces a narrower tile)."""
        t = widest_tile(lambda t: self.smem_bytes(t, n_masks), self.n_slots,
                        budget)
        if t:
            return t
        limit = min(budget // 4 - STAGES * self.stage_words(1, n_masks),
                    NO_SLOT)
        raise ValueError(
            f"netlist_exec: {self.n_slots} rows live at once do not fit "
            f"{budget} bytes of shared memory even at one trial word a "
            f"CTA (at most {max(limit, 0)} live rows with W={self.W} and "
            f"{n_masks} mask planes)")


def widest_tile(smem_bytes: Callable[[int], int], n_slots: int,
                budget: int) -> int:
    """The widest of TILES whose shared memory `smem_bytes(tile)` fits
    `budget` bytes; 0 where none does, or where a uint16 descriptor cannot
    name `n_slots` slots."""
    if n_slots <= NO_SLOT:
        for t in TILES:
            if smem_bytes(t) <= budget:
                return t
    return 0


def launch_tile(tile: int, tw: int, n_sm: int) -> int:
    """`tile` halved while a grid of ceil(tw / (tile / 2)) CTAs, one a SM,
    still fits the card's n_sm SMs."""
    while tile > 1 and -(-tw // (tile // 2)) <= n_sm:
        tile //= 2
    return tile


def _check_rows(rows_in: np.ndarray, base: int) -> None:
    L, W, _ = rows_in.shape
    limit = base + W * np.arange(L).reshape(L, 1, 1)
    if ((rows_in < 0) | (rows_in >= limit)).any():
        raise ValueError("netlist_exec: a level reads a row at or above its "
                         "own output block")


def build_plan(rows_in: np.ndarray, base: int) -> Plan:
    """Assign slots to the rows of `rows_in` ((L, W, k), the k rows a slot
    of level l reads, below base + l*W; k = 3 here, and 4 for
    crossbar_nor's plan); raises ValueError on a row out of range.  The
    plan's desc is then (L, W, k + 1): the k read slots and the output
    slot."""
    rows_in = np.asarray(rows_in, dtype=np.int64)
    L, W, k = rows_in.shape
    _check_rows(rows_in, base)
    n_rows = base + L * W
    lvl = np.repeat(np.arange(L), W * k)
    flat = rows_in.reshape(-1)
    last = np.full(n_rows, -1, np.int64)
    np.maximum.at(last, flat, lvl)                 # last reader, -1: none
    writer = np.full(n_rows, -1, np.int64)         # rows < base: from start
    writer[base:] = np.arange(L * W) // W

    # interval colouring in writer order: a slot is free for a row written
    # at level w once its last read is at a level < w
    slot = np.full(n_rows, -1, np.int64)
    free: list = []                                # slot ids, lowest first
    busy: list = []                                # (last read, slot)
    n_slots = 0
    for r in np.flatnonzero(last >= 0):            # ascending = writer order
        w = writer[r]
        while busy and busy[0][0] < w:
            heapq.heappush(free, heapq.heappop(busy)[1])
        if free:
            s = heapq.heappop(free)
        else:
            s, n_slots = n_slots, n_slots + 1
        slot[r] = s
        heapq.heappush(busy, (int(last[r]), s))

    desc = np.empty((L, W, k + 1), np.int64)
    desc[..., :k] = slot[rows_in]
    out = slot[base:].reshape(L, W)
    desc[..., k] = np.where(out < 0, NO_SLOT, out)
    return Plan(L, W, base, n_slots, desc.astype(np.uint16),
                slot[:base].astype(np.int32))


_plan_cache: Dict[tuple, Plan] = {}


def plan(rows_in: np.ndarray, base: int) -> Plan:
    """Cached `build_plan`, keyed on the exact bytes of rows_in (a handful of
    schedules a process; a collision would run the wrong plan, so no
    hashing shortcut)."""
    rows_in = np.ascontiguousarray(rows_in, dtype=np.int32)
    key = (rows_in.shape, rows_in.tobytes(), int(base))
    p = _plan_cache.get(key)
    if p is None:
        p = _plan_cache[key] = build_plan(rows_in, base)
    return p
