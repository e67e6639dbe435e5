"""Levelized netlist schedules: O(depth) wide steps instead of O(G) gates
(port of `repro.core.scheduler`).

The gate-serial executor in core/netlist.py walks the gate list one Min3 at
a time.  A Min3 netlist is a DAG, though: every gate whose inputs are
already computed can fire in the same cycle (HIPE-MAGIC's level
scheduling).  This module compiles a `Netlist` into a dense, padded
``(L, W, 4)`` schedule of dependency levels and executes it as L wide
steps over *trial-packed* words (32 trials per 32-bit lane word,
core/bitops.pack_trials), so each level is a handful of bitwise ops.

The levelizer is host numpy, the reference's own code: its outputs equal
the reference's array for array.  Two decisions carry the speedup:

* **capacity-capped levels** -- list scheduling with a width cap (default
  a power of two near 2*G/depth) spills wide levels into their successors'
  slack; every gate still executes strictly after its producers.
* **schedule-order wire renumbering** -- level l's outputs occupy one
  contiguous row block ``[base + l*W, base + (l+1)*W)`` of the packed
  state, so a level commits as one contiguous store.  Padding slots read
  row 0 (const ZERO) and own their slot's row.

Fault injection: every engine of the port draws all gates' lane masks in
one call (faults.FaultModel.gate_lane_masks), so for one generator state the scan,
levelized and kernel engines corrupt the same (gate, trial) pairs, and
single-fault planes (`fault_gate`) XOR the same positions.  The CUDA kernel
in kernels/netlist_exec consumes the same schedule and the same mask
tensors as `run_levels`, its plain version.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .bitops import PACK, pack_trials, unpack_trials
from .netlist import Netlist, gate_fault_model

__all__ = ["Schedule", "levelize", "schedule", "schedule_fault_masks",
           "min3_level", "run_levels", "packed_initial_state",
           "execute_schedule", "execute_levelized"]


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Dense levelized form of a Netlist.

    sched:     (L, W, 4) int32 — Min3 rows (in1, in2, in3, out) grouped by
               level, in *original wire ids* (padding slots read wire 0 and
               carry out = n_wires).
    sched_gid: (L, W) int32 — original gate id per slot, -1 for padding
               (the key into gate-indexed fault-mask tensors).
    widths:    (L,) int32 — real gates per level.
    depth:     critical-path depth of the DAG (ASAP level count); L >= depth
               when the width cap forces spilling.
    remap:     (n_wires,) int32 — wire id -> packed state row: row 0 ZERO,
               row 1 ONE, rows [2, base) the primary inputs in netlist
               order, then slot (l, s) owns row base + l*W + s.
    rows_in:   (L, W, 3) int32 — sched input wires through remap (padding
               slots read row 0); level l's outputs are exactly rows
               [base + l*W, base + (l+1)*W) of the packed state.
    """

    n_wires: int
    n_gates: int
    depth: int
    sched: np.ndarray
    sched_gid: np.ndarray
    widths: np.ndarray
    base: int
    remap: np.ndarray
    rows_in: np.ndarray

    @property
    def n_levels(self) -> int:
        return int(self.sched.shape[0])

    @property
    def max_width(self) -> int:
        return int(self.sched.shape[1])

    @property
    def n_slots(self) -> int:
        return int(self.sched.shape[0] * self.sched.shape[1])

    @property
    def n_rows(self) -> int:
        return self.base + self.n_slots

    def issue_counts(self, row_cap: int) -> np.ndarray:
        """Row-parallel issues per level under a crossbar row budget:
        level l's ``widths[l]`` gates fire in ``ceil(widths[l]/row_cap)``
        sequential issues (the mMPU cost model's latency unit —
        costmodel.compile.lower_schedule)."""
        if row_cap < 1:
            raise ValueError(f"row_cap must be >= 1, got {row_cap}")
        return -(-self.widths.astype(np.int64) // int(row_cap))


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length()


def _asap_levels(nl: Netlist) -> np.ndarray:
    """ASAP level per gate (1-based; constants/inputs sit at level 0)."""
    wire_level = np.zeros(nl.n_wires, np.int64)
    gate_level = np.zeros(nl.n_gates, np.int64)
    for g in range(nl.n_gates):
        i1, i2, i3, out = nl.gates[g]
        lvl = 1 + max(wire_level[i1], wire_level[i2], wire_level[i3])
        gate_level[g] = lvl
        wire_level[out] = lvl
    return gate_level


def levelize(nl: Netlist, max_width: Optional[int] = None) -> Schedule:
    """Compile a netlist into a capacity-capped levelized schedule.

    Capacity-constrained list scheduling: at each step, fire up to
    ``max_width`` ready gates (all producers in strictly earlier steps),
    lowest gate id first — deterministic, and id order is the builder's
    emission order so locality of the wire state is preserved.
    ``max_width=None`` picks a power of two near 2·G/depth (clamped to
    [32, ASAP max width]) — wide enough that spilling adds few levels,
    narrow enough that padding stays O(G).
    """
    G = nl.n_gates
    n_in = len(nl.inputs)
    base = 2 + n_in
    remap = np.zeros(nl.n_wires, np.int64)
    remap[1] = 1
    remap[nl.inputs] = 2 + np.arange(n_in)
    if G == 0:
        return Schedule(nl.n_wires, 0, 0, np.zeros((0, 1, 4), np.int32),
                        np.full((0, 1), -1, np.int32), np.zeros(0, np.int32),
                        base, remap.astype(np.int32),
                        np.zeros((0, 1, 3), np.int32))

    asap = _asap_levels(nl)
    depth = int(asap.max())
    if max_width is None:
        _, counts = np.unique(asap, return_counts=True)
        width_asap = int(counts.max())
        max_width = min(width_asap, max(32, _next_pow2(-(-2 * G // depth))))
    max_width = max(1, int(max_width))

    # producer gate of each wire (-1 for constants and primary inputs)
    producer = np.full(nl.n_wires, -1, np.int64)
    producer[nl.gates[:, 3]] = np.arange(G)
    pred = producer[nl.gates[:, :3]]                    # (G, 3), -1 = source
    indeg = (pred >= 0).sum(axis=1)
    # consumers adjacency (flat CSR to keep the python loop cheap)
    src = pred[pred >= 0]
    dst = np.repeat(np.arange(G), 3)[(pred >= 0).reshape(-1)]
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    starts = np.searchsorted(src, np.arange(G + 1))

    future: list = [(1, g) for g in range(G) if indeg[g] == 0]
    heapq.heapify(future)
    ready: list = []
    levels: list = []
    scheduled = 0
    step = 0
    while scheduled < G:
        step += 1
        if not ready and future and future[0][0] > step:
            step = future[0][0]
        while future and future[0][0] <= step:
            heapq.heappush(ready, heapq.heappop(future)[1])
        level = []
        while ready and len(level) < max_width:
            level.append(heapq.heappop(ready))
        for g in level:
            for consumer in dst[starts[g]:starts[g + 1]]:
                indeg[consumer] -= 1
                if indeg[consumer] == 0:
                    heapq.heappush(future, (step + 1, consumer))
        scheduled += len(level)
        levels.append(level)

    L, W = len(levels), max_width
    sched = np.zeros((L, W, 4), np.int32)
    sched[:, :, 3] = nl.n_wires
    sched_gid = np.full((L, W), -1, np.int32)
    widths = np.zeros(L, np.int32)
    for l, level in enumerate(levels):
        widths[l] = len(level)
        sched[l, :len(level)] = nl.gates[level]
        sched_gid[l, :len(level)] = level

    valid = sched_gid >= 0
    slot_row = base + np.arange(L * W).reshape(L, W)
    remap[nl.gates[sched_gid[valid], 3]] = slot_row[valid]
    rows_in = np.where(valid[..., None], remap[sched[:, :, :3]], 0)
    return Schedule(nl.n_wires, G, depth, sched, sched_gid, widths,
                    base, remap.astype(np.int32), rows_in.astype(np.int32))


_schedule_cache: Dict[tuple, Schedule] = {}


def schedule(nl: Netlist, max_width: Optional[int] = None) -> Schedule:
    """Cached levelize — netlists are built once and executed many times.

    Keyed on the netlist's exact bytes (a handful of netlists per process,
    ~200 KB each — collisions would silently execute the wrong schedule,
    so no hashing shortcut)."""
    key = (nl.n_wires, np.ascontiguousarray(nl.gates).tobytes(),
           np.ascontiguousarray(nl.inputs).tobytes(),
           np.ascontiguousarray(nl.outputs).tobytes(), max_width)
    sch = _schedule_cache.get(key)
    if sch is None:
        sch = _schedule_cache[key] = levelize(nl, max_width)
    return sch


def _all_ones_broadcast(keep: torch.Tensor) -> bool:
    """keep is one all-ones word broadcast over every gate and lane (every
    stride 0): read with one scalar copy, never materialized."""
    return (keep.numel() > 0 and all(st == 0 for st in keep.stride())
            and int(keep[(0,) * keep.ndim]) == -1)


def schedule_fault_masks(sch: Schedule, trials: int,
                         generator: Optional[torch.Generator] = None,
                         p_gate=0.0,
                         fault_gate: Optional[torch.Tensor] = None,
                         device=None,
                         ) -> Optional[Tuple[Optional[torch.Tensor],
                                             torch.Tensor]]:
    """Build schedule-ordered corruption masks, or None when fault-free.

    Returns (keep, flip), int32 (L, W, tw) with tw = ceil(trials/32), on
    `device` (default: fault_gate's, else the generator's): slot (l, s)'s
    freshly computed packed column corrupts as ``(val & keep[l, s]) ^
    flip[l, s]`` -- identity on padding slots.  keep is None when no iid
    model is active (single-fault only) or when the model's keep is an
    all-ones broadcast (TransientGateFaults): the corruption is then a pure
    XOR, with the same bits.
    A float p_gate means TransientGateFaults(p_gate); the iid model comes
    before the single-fault XOR (scan order), which in affine form is
    flip ^= single_fault_plane.
    """
    G, tw = sch.n_gates, -(-trials // PACK)
    model = gate_fault_model(generator, p_gate)
    if model is None and fault_gate is None:
        return None
    if device is None:
        device = fault_gate.device if fault_gate is not None \
            else generator.device
    if model is not None:
        keep_g, flip_g = model.gate_lane_masks(generator, G, trials)
        # an all-ones keep (TransientGateFaults' broadcast) changes no bit:
        # v & ~0 == v, so the corruption is the pure XOR
        keep_g = None if _all_ones_broadcast(keep_g) else keep_g.to(device)
        flip_g = flip_g.to(device)
    else:
        keep_g = None
        flip_g = torch.zeros((G, tw), dtype=torch.int32, device=device)

    if fault_gate is not None:
        # trial t flips gate fault_gate[t]: bit t%32 of word t//32 of that
        # gate's row (distinct bits per trial, so the sum is the OR); a
        # negative fault_gate lands in the spare row G
        t = torch.arange(trials, device=device)
        fg = fault_gate.to(device).long()
        fg = torch.where(fg < 0, G, fg)
        single = torch.zeros((G + 1) * tw, dtype=torch.int64, device=device)
        single.index_add_(0, fg * tw + t // PACK,
                          torch.ones_like(t) << (t % PACK))
        flip_g = flip_g ^ single[:G * tw].view(G, tw).to(torch.int32)
        del single

    gid = torch.as_tensor(sch.sched_gid, device=device).long()   # (L, W)
    pad = gid < 0
    safe = gid.clamp(min=0)
    flip = flip_g[safe]
    flip[pad] = 0
    del flip_g
    if keep_g is None:
        return None, flip
    keep = keep_g[safe]
    keep[pad] = -1
    return keep, flip


def min3_level(state: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Evaluate one schedule level: (n_rows, tw) packed state + (W, 3) input
    rows -> (W, tw) Minority3 outputs, one gather for the level."""
    abc = state[rows.long()]
    a, b, c = abc[:, 0], abc[:, 1], abc[:, 2]
    return ~((a & b) | (b & c) | (a & c))


def run_levels(rows_in: torch.Tensor, state: torch.Tensor,
               keep: Optional[torch.Tensor] = None,
               flip: Optional[torch.Tensor] = None, *,
               base: int) -> torch.Tensor:
    """The TPU kernel's function, level by level in plain PyTorch, in
    place: level l evaluates the (W, 3) rows `rows_in[l]` of the (base +
    L*W, tw) packed state, corrupts as ``(val & keep[l]) ^ flip[l]`` (flip
    without keep: a pure XOR) and writes rows [base + l*W, base +
    (l+1)*W).  Returns `state`."""
    L, W = rows_in.shape[:2]
    for l in range(L):
        val = min3_level(state, rows_in[l])
        if flip is not None:
            if keep is not None:
                val &= keep[l]
            val ^= flip[l]
        state[base + l * W:base + (l + 1) * W] = val
    return state


def packed_initial_state(sch: Schedule,
                         inputs: torch.Tensor) -> torch.Tensor:
    """(trials, n_in) bool -> (n_rows, tw) int32 packed wire state in the
    schedule's renumbered row layout (constants + inputs loaded in netlist
    input order -- rows [2, base) -- every level's output block zeroed), on
    the inputs' device."""
    tw = -(-inputs.shape[0] // PACK)
    state = torch.zeros((sch.n_rows, tw), dtype=torch.int32,
                        device=inputs.device)
    state[1] = -1
    state[2:sch.base] = pack_trials(inputs).T
    return state


def execute_schedule(nl: Netlist, inputs: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     p_gate=0.0, fault_gate: Optional[torch.Tensor] = None,
                     max_width: Optional[int] = None,
                     levels: Callable = run_levels) -> torch.Tensor:
    """Schedule, pack, draw the masks and run `levels` (`run_levels` or the
    kernel's wrapper, same signature) on the inputs' device; the same
    contract as netlist.execute."""
    sch = schedule(nl, max_width)
    trials, dev = inputs.shape[0], inputs.device
    state = packed_initial_state(sch, inputs)
    masks = schedule_fault_masks(sch, trials, generator, p_gate, fault_gate,
                                 dev)
    keep, flip = masks if masks is not None else (None, None)
    del masks
    rows_in = torch.as_tensor(sch.rows_in, device=dev)
    state = levels(rows_in, state, keep, flip, base=sch.base)
    del keep, flip
    out = state[torch.as_tensor(sch.remap[nl.outputs], device=dev).long()]
    return unpack_trials(out.T, trials)


def execute_levelized(nl: Netlist, inputs: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      p_gate=0.0, fault_gate: Optional[torch.Tensor] = None,
                      max_width: Optional[int] = None) -> torch.Tensor:
    """Levelized bit-packed executor in plain PyTorch -- same contract as
    netlist.execute, bit-exact against it (fault streams included), O(L)
    steps instead of O(G).  The plain version of kernels/netlist_exec."""
    return execute_schedule(nl, inputs, generator, p_gate, fault_gate,
                            max_width, run_levels)
