"""mMPU device timing/energy spec (port of `repro.costmodel.device`).

A :class:`DeviceSpec` pins the per-primitive cycle latencies and
per-cell switching energies of one memristive crossbar configuration.
The compiler (`costmodel.compile`) never touches these numbers — it
emits *counts* of primitive issues and touched cells — so the same
event stream can be re-priced under any device by swapping the spec.

Primitive kinds (`EVENT_KINDS`) follow the MAGIC/FELIX gate set the
repo's netlist layer already uses (`core/multpim.py`,
`core/scheduler.py`):

* ``init``  — output-cell initialization to RON before a stateful gate
  (MAGIC requires it; one cycle, Talati et al., TVLSI 2016).
* ``nor`` / ``not`` — MAGIC NOR / 1-input NOR, one cycle each.
* ``min3`` — FELIX 3-input minority, one cycle (Gupta et al.,
  ICCAD 2018); the majority vote used by TMR is Min3 + NOT.
* ``xor``  — FELIX 2-cycle in-memory XOR, the ECC syndrome primitive
  (Leitersdorf et al., arXiv:2105.04212 price their diagonal-parity
  check in exactly these).
* ``read`` / ``write`` — peripheral row read / row write.

All primitives are row-parallel: one issue applies the gate across up
to ``rows`` wordlines at once, each word ``cols``-bits wide, so a
level of W gates costs ``ceil(W / rows)`` issues regardless of W
(the paper's "single-row-operation" cost model, §III).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

# Order is load-bearing: events are encoded by index for the packed
# array form (events.EventArrays) and the batched fold.
EVENT_KINDS: Tuple[str, ...] = (
    "init", "nor", "not", "min3", "xor", "read", "write")
KIND_INDEX: Dict[str, int] = {k: i for i, k in enumerate(EVENT_KINDS)}


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Timing/energy model of one mMPU crossbar array.

    Latencies are device cycles per primitive *issue*; energies are
    picojoules per touched *cell* (bit).  Defaults live in
    ``repro_torch.configs.mmpu_paper`` — construct through
    :func:`repro_torch.configs.mmpu_paper.get_device` or override fields
    with :meth:`replace`.
    """
    name: str
    rows: int            # wordlines per crossbar == row-parallel op width
    cols: int            # bitlines per crossbar == bits per word-row
    n_crossbars: int     # arrays usable in parallel by one workload
    clock_hz: float      # device cycle rate

    # -- cycles per primitive issue ------------------------------------
    init_cycles: int = 1
    nor_cycles: int = 1
    not_cycles: int = 1
    min3_cycles: int = 1
    xor_cycles: int = 2          # FELIX XOR = 2 stateful cycles
    read_cycles: int = 1
    write_cycles: int = 1

    # -- picojoules per touched cell -----------------------------------
    init_energy_pj: float = 0.0010
    nor_energy_pj: float = 0.0064
    not_energy_pj: float = 0.0032
    min3_energy_pj: float = 0.0096
    xor_energy_pj: float = 0.0128
    read_energy_pj: float = 0.0005
    write_energy_pj: float = 0.0250

    def __post_init__(self):
        if self.rows <= 0 or self.cols <= 0 or self.n_crossbars <= 0:
            raise ValueError(f"DeviceSpec dimensions must be positive: {self}")
        if self.clock_hz <= 0:
            raise ValueError("DeviceSpec.clock_hz must be positive")

    # -- lookups -------------------------------------------------------
    def cycles_for(self, kind: str) -> int:
        return getattr(self, f"{kind}_cycles")

    def energy_pj_for(self, kind: str) -> float:
        return getattr(self, f"{kind}_energy_pj")

    def cycle_vector(self) -> Tuple[float, ...]:
        """Per-kind cycle costs ordered by EVENT_KINDS (for array folds)."""
        return tuple(float(getattr(self, f"{k}_cycles"))
                     for k in EVENT_KINDS)

    def energy_vector(self) -> Tuple[float, ...]:
        """Per-kind pJ/cell ordered by EVENT_KINDS (for array folds)."""
        return tuple(float(getattr(self, f"{k}_energy_pj"))
                     for k in EVENT_KINDS)

    # -- geometry helpers ----------------------------------------------
    def row_issues(self, width: int) -> int:
        """Sequential issues to apply one row-parallel op to `width` rows."""
        return max(1, math.ceil(width / self.rows)) if width > 0 else 0

    def seconds(self, cycles: float) -> float:
        return float(cycles) / self.clock_hz

    def replace(self, **overrides) -> "DeviceSpec":
        return dataclasses.replace(self, **overrides)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def spec_from_dict(d: dict) -> DeviceSpec:
    return DeviceSpec(**d)
