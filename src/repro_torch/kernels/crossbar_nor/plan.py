"""Shared-memory plan of the levelized crossbar_nor kernel
(csrc/crossbar_nor.cu).

The TPU kernel walks a (G, 4) gate list strictly in list order over a trial
tile's whole wire state in VMEM.  The function is not serial, though: the
32-bit multiplier's 13,792 gates are 306 levels deep.  The kernel keeps a
trial tile's live values on chip and runs each level's gates in parallel;
this module plans that on the host, in numpy, once per gate list:

* **versions** -- the list may write a wire several times, and a gate may
  read the wire it writes.  Every write makes a new version of its wire and
  every read names the version current at its place in the list
  (read-after-write), so the list becomes an SSA list over versions with no
  write-after-read or write-after-write hazard left;
* **base rows** -- the version 0 of every wire that is read before it is
  written, taken from `state` as given (wires 0 and 1 too: this op holds no
  wire constant);
* **levels** -- the versions' dependence DAG through core/scheduler.levelize
  (capacity-capped list scheduling; an SSA list keeps its one-writer rule),
  at its own width (W = 128 for the 32-bit multiplier), at most MAX_WIDTH;
* **slots** -- netlist_exec/plan.build_plan's interval colouring: a version
  that a later level reads holds a shared-memory slot from its level to its
  last reader, and a slot is reused only after its last read;
* **final versions** -- each wire's last write goes to `out`, and a wire
  never written is copied from `state` to `out`.  A level's gates write
  scattered wires (a level of the 32-bit multiplier spreads over up to
  11,000 wires), so a final version is not stored at its level: it stays in
  its slot until every final version of its group of GROUP consecutive
  wires is computed, and the group is then flushed, in wire order, at the
  earliest later level with room (W flushes a level; one level past the
  last gate level for the multipliers).  A warp's stores cover consecutive
  wires of one trial word.

Descriptor (l, s) is 16 bytes (int32 x4) and carries a gate and a flush:
the slots of the gate's inputs a and b (16 bits each), of c and of its
output (NO_SLOT: nobody reads it); the wire the flush writes (-1: none) and
the slot it reads.  Plans are cached by the exact bytes of (gates,
n_wires).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ...core.netlist import Netlist
from ...core.scheduler import levelize
from ..netlist_exec.plan import NO_SLOT, SMEM_BUDGET, build_plan, widest_tile

__all__ = ["Plan", "plan", "build", "check_wires", "STAGES", "MAX_WIDTH",
           "GROUP"]

#: levels of descriptors in the kernel's shared ring (kStages)
STAGES = 6
#: consecutive wires flushed together (a warp's stores)
GROUP = 32
#: widest level the kernel takes (kMaxGates x kGroup: two gates a thread)
MAX_WIDTH = 256
#: the fixed rows of levelize's packed layout (ZERO, ONE), which no gate
#: of the renamed list reads
_FIXED = 2


@dataclasses.dataclass(frozen=True)
class Plan:
    """Levels and slots of one gate list over `n_wires` wires.

    gd:        (L, W, 4) int32 descriptors (see the module docstring).
    gid:       (L, W) int32 gate of each descriptor, -1 for padding.
    gate_levels: levels [0, gate_levels) hold the gates; the rest only
               flushes.
    base_wire: (n_base,) int32 wires read before they are written, and
    base_slot: (n_base,) int32 the slot of each one's version 0.
    copy_wire: (n_copy,) int32 wires never written (state -> out).
    depth:     ASAP depth of the version DAG (L >= depth when W caps it).
    """

    n_wires: int
    L: int
    W: int
    gate_levels: int
    depth: int
    n_slots: int
    gd: np.ndarray
    gid: np.ndarray
    base_wire: np.ndarray
    base_slot: np.ndarray
    copy_wire: np.ndarray
    _on: dict = dataclasses.field(default_factory=dict, compare=False,
                                  repr=False)

    def on(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(gd, (2, n_base) base wires and slots, copy_wire) on `device`,
        copied there once."""
        key = str(device)
        if key not in self._on:
            self._on[key] = tuple(torch.from_numpy(a).to(device) for a in (
                self.gd, np.stack([self.base_wire, self.base_slot]),
                self.copy_wire))
        return self._on[key]

    def smem_bytes(self, tile: int) -> int:
        """Dynamic shared memory of a CTA at `tile` words: the descriptor
        ring (STAGES levels of W) and the slots."""
        return 4 * (STAGES * 4 * self.W + tile * self.n_slots)

    def tile(self, budget: int = SMEM_BUDGET) -> int:
        """The widest trial tile whose shared memory fits `budget` bytes."""
        t = widest_tile(self.smem_bytes, self.n_slots, budget)
        if t:
            return t
        limit = min(budget // 4 - STAGES * 4 * self.W, NO_SLOT)
        raise ValueError(
            f"crossbar_nor: {self.n_slots} versions live at once do not fit "
            f"{budget} bytes of shared memory even at one trial word a CTA "
            f"(at most {max(limit, 0)} live versions with W={self.W})")


def check_wires(gates: np.ndarray, n_wires: int) -> None:
    if gates.size and ((gates < 0) | (gates >= n_wires)).any():
        raise ValueError(f"crossbar_nor: a gate names a wire outside "
                         f"[0, {n_wires})")


def _producers(gates: np.ndarray) -> np.ndarray:
    """(G, 3): the gate whose write each input reads, -1 for the wire's
    version 0 (no write of it earlier in the list)."""
    G = len(gates)
    gate = np.arange(G, dtype=np.int64)
    ins, out = gates[:, :3].astype(np.int64), gates[:, 3].astype(np.int64)
    # writes keyed (wire, gate); a read by gate g of wire w finds the last
    # key below (w, g): the last earlier write of w, or another wire's
    order = np.argsort(out * (G + 1) + gate, kind="stable")
    keys = (out * (G + 1) + gate)[order]
    pos = np.searchsorted(keys, ins * (G + 1) + gate[:, None]) - 1
    prev = order[np.maximum(pos, 0)]
    return np.where((pos >= 0) & (out[prev] == ins), prev, -1)


def _flush_levels(wire: np.ndarray, level: np.ndarray, W: int) -> np.ndarray:
    """The level that flushes each final version (`wire`, written at
    `level`): its group of min(GROUP, W) wires goes whole to the earliest
    level after the group's last write with room left (W a level)."""
    grp = wire // min(GROUP, W)
    done = np.zeros(int(grp.max()) + 1, np.int64)
    np.maximum.at(done, grp, level)
    order = np.lexsort((wire, done[grp]))      # groups by completion
    at = np.empty(len(wire), np.int64)
    fill: Dict[int, int] = {}
    for idx in np.split(order, np.flatnonzero(np.diff(grp[order])) + 1):
        f = int(done[grp[idx[0]]]) + 1
        while fill.get(f, 0) + len(idx) > W:
            f += 1
        at[idx] = f
        fill[f] = fill.get(f, 0) + len(idx)
    return at


def build(gates: np.ndarray, n_wires: int) -> Plan:
    """Plan `gates` ((G, 4) wire ids) over `n_wires` wires; raises
    ValueError on a wire out of range."""
    gates = np.asarray(gates, dtype=np.int64).reshape(-1, 4)
    check_wires(gates, n_wires)
    G = len(gates)
    prod = _producers(gates)
    base_wire = np.unique(gates[:, :3][prod < 0])
    nb = len(base_wire)
    # the SSA list over versions: rows [2, 2 + nb) version 0 of base_wire,
    # row 2 + nb + g the write of gate g
    ssa = np.empty((G, 4), np.int64)
    ssa[:, :3] = np.where(prod >= 0, _FIXED + nb + prod,
                          _FIXED + np.searchsorted(base_wire, gates[:, :3]))
    ssa[:, 3] = _FIXED + nb + np.arange(G)
    nl = Netlist(_FIXED + nb + G, np.arange(_FIXED, _FIXED + nb),
                 np.zeros(0, np.int64), ssa.astype(np.int32))
    sch = levelize(nl)
    if sch.max_width > MAX_WIDTH:
        sch = levelize(nl, MAX_WIDTH)
    L, W, gid = sch.n_levels, sch.max_width, sch.sched_gid

    # final versions: the last write of each wire, flushed by group
    last = np.full(n_wires, -1, np.int64)
    np.maximum.at(last, gates[:, 3], np.arange(G))
    fl, fs = np.nonzero((gid >= 0) & (last[gates[np.maximum(gid, 0), 3]]
                                      == gid))
    wire = gates[gid[fl, fs], 3]
    at = _flush_levels(wire, fl, W) if len(wire) else fl
    Lf = max(L, int(at.max()) + 1) if len(at) else L
    order = np.lexsort((wire, at))             # a level's flushes by wire
    lv = at[order]
    slot_of = np.arange(len(order)) - np.searchsorted(lv, lv)
    fl_row = np.full((Lf, W), -1, np.int64)
    fl_row[lv, slot_of] = sch.base + fl[order] * W + fs[order]
    fl_wire = np.full((Lf, W), -1, np.int64)
    fl_wire[lv, slot_of] = wire[order]

    # reads: a gate's three inputs (padding reads what its level's first
    # gate reads) and the flushed version (else the gate's first input);
    # a level of flushes only reads its first flush's row everywhere
    rows = np.empty((Lf, W, 4), np.int64)
    rows[:L, :, :3] = np.where((gid >= 0)[..., None], sch.rows_in,
                               sch.rows_in[:, :1])
    rows[L:] = fl_row[L:, :1, None]
    rows[..., 3] = np.where(fl_row >= 0, fl_row, rows[..., 0])
    p = build_plan(rows, sch.base)
    d = p.desc.astype(np.int64)
    gd = np.empty((Lf, W, 4), np.int64)
    gd[..., 0] = d[..., 0] | d[..., 1] << 16
    gd[..., 1] = d[..., 2] | d[..., 4] << 16
    gd[..., 2] = fl_wire
    gd[..., 3] = d[..., 3]
    gid = np.concatenate([gid, np.full((Lf - L, W), -1, gid.dtype)])
    return Plan(n_wires, Lf, W, L, sch.depth, p.n_slots,
                gd.astype(np.uint32).view(np.int32), gid,
                base_wire.astype(np.int32),
                p.base_slot[_FIXED:].astype(np.int32),
                np.flatnonzero(last < 0).astype(np.int32))


_plan_cache: Dict[tuple, List[Tuple[np.ndarray, Plan]]] = {}


def plan(gates: np.ndarray, n_wires: int) -> Plan:
    """Cached `build`, found by the exact bytes of gates and n_wires: the
    lists of one shape and n_wires are compared whole (np.array_equal,
    a few times cheaper a call than hashing the bytes; a handful of gate
    lists a process, and a collision would run the wrong plan, so no
    digest shortcut)."""
    gates = np.ascontiguousarray(gates, dtype=np.int32)
    known = _plan_cache.setdefault((gates.shape, int(n_wires)), [])
    for g, p in known:
        if np.array_equal(g, gates):
            return p
    p = build(gates, n_wires)
    known.append((gates.copy(), p))
    return p
