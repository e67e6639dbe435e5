"""Crossbar array simulation: in-row / in-column vectored stateful logic
(port of `repro.core.crossbar`).

A crossbar is an (n x n) boolean resistance matrix.  Stateful logic applies
the same gate across *all rows* (columns) in one cycle by driving bitlines
(wordlines).  Partitions split a row (column) into independent segments so
multiple in-row gates execute concurrently (FELIX partitions).

Two error processes (paper §II-B):

* direct   -- a gate writes the wrong value (p_gate), injected inside the
              gate primitives (stateful_logic.maybe_flip);
* indirect -- accessing (reading or using as gate input) a memristor
              corrupts it with probability p_input (state drift / read
              disturb); time-based retention drift is `drift(generator,
              dt)`.

`ErrorModel` wraps raw probabilities into the default transient/drift
fault models or takes explicit `faults.FaultModel` instances per channel.

The simulator is functional: every op returns a new `Crossbar` (the state
tensor is never written in place).  Where the reference takes a PRNG key
and splits it per input and per gate, the port takes a `torch.Generator`
and draws in order: the inputs' corruption first (one input after
another), then the gate's.  The state lives on CUDA unless the caller asks
for another device.  `CycleCounter` accounting is the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from . import prng
from . import stateful_logic as sl
from ..device import resolve_device
from ..faults.models import FaultModel, RetentionDrift, TransientBitFlips

__all__ = ["Crossbar", "ErrorModel"]


@dataclasses.dataclass(frozen=True)
class ErrorModel:
    """Error processes for the crossbar simulation.

    Raw per-event probabilities (p_gate, p_input, p_retention) are wrapped
    on demand into the default FaultModels; a faults.FaultModel per channel
    (`gate`, `input`, `retention`) overrides the default process -- e.g.
    ErrorModel(input=StuckAtFaults(1e-4, 1e-4)) pins defective cells
    instead of drawing i.i.d. transient flips.
    """

    p_gate: float = 0.0     # direct: incorrect stateful gate output
    p_input: float = 0.0    # indirect: corruption of accessed (input) bits
    p_retention: float = 0.0  # indirect: per-bit drift per time unit
    gate: Optional[FaultModel] = None       # overrides p_gate
    input: Optional[FaultModel] = None      # overrides p_input
    retention: Optional[FaultModel] = None  # overrides p_retention

    def gate_param(self):
        """What the gate primitives receive: a float or the overriding
        FaultModel."""
        return self.gate if self.gate is not None else self.p_gate

    def input_model(self) -> FaultModel:
        return self.input if self.input is not None \
            else TransientBitFlips(self.p_input)

    def retention_model(self) -> FaultModel:
        return self.retention if self.retention is not None \
            else RetentionDrift(self.p_retention)

    @property
    def has_input_noise(self) -> bool:
        return self.input is not None or self.p_input > 0.0


@dataclasses.dataclass
class Crossbar:
    """An n_rows x n_cols crossbar of boolean resistive states."""

    state: torch.Tensor                   # bool (n_rows, n_cols)
    errors: ErrorModel = dataclasses.field(default_factory=ErrorModel)
    counter: sl.CycleCounter = dataclasses.field(
        default_factory=sl.CycleCounter)

    # -- construction --------------------------------------------------------

    @staticmethod
    def zeros(n_rows: int, n_cols: int, errors: ErrorModel = ErrorModel(),
              device=None) -> "Crossbar":
        return Crossbar(torch.zeros((n_rows, n_cols), dtype=torch.bool,
                                    device=resolve_device(device)), errors)

    @staticmethod
    def from_array(a, errors: ErrorModel = ErrorModel(),
                   device=None) -> "Crossbar":
        return Crossbar(torch.as_tensor(a).to(device=resolve_device(device),
                                              dtype=torch.bool), errors)

    @property
    def shape(self):
        return tuple(self.state.shape)

    def _with(self, state) -> "Crossbar":
        return Crossbar(state, self.errors, self.counter)


    # -- input access corruption (indirect) ----------------------------------

    def _read(self, view: torch.Tensor, index, idx: Sequence[int],
              generator: Optional[torch.Generator]):
        """Read the inputs view[index(i)] for i in idx from `view` (a
        private copy of the state); with input noise, corrupt the *stored*
        inputs in it too."""
        if generator is None or not self.errors.has_input_noise:
            return [view[index(i)] for i in idx]
        model = self.errors.input_model()
        out = []
        for i, g in zip(idx, prng.streams(generator, len(idx))):
            corrupted = model.corrupt_bits(view[index(i)], g)
            view[index(i)] = corrupted
            out.append(corrupted)
        return out

    # -- vectored in-row gate: all rows in one cycle --------------------------

    def row_gate(self, gate: str, in_cols: Sequence[int], out_col: int,
                 generator: Optional[torch.Generator] = None) -> "Crossbar":
        """Apply `gate` with inputs at `in_cols`, output at `out_col`,
        simultaneously in every row (paper Fig. 1(a))."""
        state = self.state.clone()
        g_in, g_gate = prng.streams(generator, 2)   # reads, gate
        ins = self._read(state, lambda c: (slice(None), c), in_cols, g_in)
        state[:, out_col] = _apply(gate, ins, g_gate,
                                   self.errors.gate_param())
        self.counter.tick(n_parallel=self.shape[0],
                          cycles=sl.GATE_COSTS[gate])
        return self._with(state)

    # -- vectored in-column gate: all columns in one cycle ---------------------

    def col_gate(self, gate: str, in_rows: Sequence[int], out_row: int,
                 generator: Optional[torch.Generator] = None) -> "Crossbar":
        """Apply `gate` with inputs at `in_rows`, output at `out_row`,
        simultaneously in every column (paper Fig. 1(b))."""
        state = self.state.clone()
        g_in, g_gate = prng.streams(generator, 2)   # reads, gate
        ins = self._read(state, lambda r: (r, slice(None)), in_rows, g_in)
        state[out_row, :] = _apply(gate, ins, g_gate,
                                   self.errors.gate_param())
        self.counter.tick(n_parallel=self.shape[1],
                          cycles=sl.GATE_COSTS[gate])
        return self._with(state)

    # -- partitioned in-row gates (FELIX partitions, paper Fig. 1(c)) ---------

    def partitioned_row_gate(self, gate: str, part_width: int,
                             in_offsets: Sequence[int], out_offset: int,
                             generator: Optional[torch.Generator] = None
                             ) -> "Crossbar":
        """Divide every row into partitions of `part_width` columns and
        apply the gate within each partition concurrently: inputs/outputs
        are offsets *within* the partition.  One cycle for all rows x all
        partitions."""
        n_rows, n_cols = self.shape
        assert n_cols % part_width == 0
        n_parts = n_cols // part_width
        view = self.state.clone().reshape(n_rows, n_parts, part_width)
        g_in, g_gate = prng.streams(generator, 2)   # reads, gate
        ins = self._read(view, lambda o: (slice(None), slice(None), o),
                         in_offsets, g_in)
        view[:, :, out_offset] = _apply(gate, ins, g_gate,
                                        self.errors.gate_param())
        self.counter.tick(n_parallel=n_rows * n_parts,
                          cycles=sl.GATE_COSTS[gate])
        return self._with(view.reshape(n_rows, n_cols))

    # -- write / drift ---------------------------------------------------------

    def _write_vals(self, values, generator, p_write: float):
        vals = torch.as_tensor(values).to(device=self.state.device,
                                          dtype=torch.bool)
        if generator is not None and p_write > 0.0:
            vals = vals ^ TransientBitFlips(p_write).bit_flips(
                generator, tuple(vals.shape)).to(vals.device)
        return vals

    def write_col(self, col: int, values,
                  generator: Optional[torch.Generator] = None,
                  p_write: float = 0.0) -> "Crossbar":
        vals = self._write_vals(values, generator, p_write)
        self.counter.tick(n_parallel=self.shape[0])
        state = self.state.clone()
        state[:, col] = vals
        return self._with(state)

    def write_row(self, row: int, values,
                  generator: Optional[torch.Generator] = None,
                  p_write: float = 0.0) -> "Crossbar":
        vals = self._write_vals(values, generator, p_write)
        self.counter.tick(n_parallel=self.shape[1])
        state = self.state.clone()
        state[row, :] = vals
        return self._with(state)

    def drift(self, generator: torch.Generator, dt: float = 1.0
              ) -> "Crossbar":
        """Retention/state drift + abrupt events over a time interval dt,
        drawn from the retention FaultModel (RetentionDrift by default)."""
        model = self.errors.retention_model()
        return self._with(model.corrupt_bits(self.state, generator, dt))


def _apply(gate: str, ins, generator, p_gate):
    fns: dict = {
        "not": lambda i, g: sl.g_not(i[0], g, p_gate),
        "nor": lambda i, g: sl.g_nor(i[0], i[1], g, p_gate),
        "or": lambda i, g: sl.g_or(i[0], i[1], g, p_gate),
        "nand": lambda i, g: sl.g_nand(i[0], i[1], g, p_gate),
        "and": lambda i, g: sl.g_and(i[0], i[1], g, p_gate),
        "min3": lambda i, g: sl.g_min3(i[0], i[1], i[2], g, p_gate),
        "maj3": lambda i, g: sl.g_maj3(i[0], i[1], i[2], g, p_gate),
        "xor": lambda i, g: sl.g_xor(i[0], i[1], g, p_gate),
    }
    if gate not in fns:
        raise ValueError(f"unknown gate {gate!r}")
    if generator is None or (not isinstance(p_gate, FaultModel)
                             and p_gate == 0.0):
        generator = None
    return fns[gate](ins, generator)
