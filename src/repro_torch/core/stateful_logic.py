"""Stateful-logic gate primitives (port of `repro.core.stateful_logic`).

A memristive stateful gate computes a Boolean function of the resistive
states of its input memristors and writes it into an output memristor, in a
single cycle, *in parallel across all rows (columns)* of a crossbar.  Gates
act on bool tensors; the tensor axis IS the row/column parallelism.

Error model (paper §II-B, "direct" soft errors): each gate evaluation
produces the wrong output with probability ``p_gate`` (independently per
row, per gate).  Every primitive takes an optional ``(generator, p_gate)``
pair where the reference takes ``(key, p_gate)``; a gate made of several
cycles draws its cycles' faults from the generator in order.  The
generator may be a `core.prng` key: the draws are then the reference's,
a gate of several cycles splitting its key as the reference does.
``p_gate`` may also be any `repro_torch.faults.FaultModel`.

Cycle accounting: each stateful gate is one crossbar cycle regardless of how
many rows it spans.  ``CycleCounter`` tracks latency (cycles) and
gate-evaluations (throughput/energy proxy).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..faults.models import FaultModel, TransientGateFaults
from . import prng

__all__ = [
    "CycleCounter",
    "maybe_flip",
    "g_not",
    "g_nor",
    "g_or",
    "g_nand",
    "g_and",
    "g_min3",
    "g_maj3",
    "g_xor",
    "GATE_COSTS",
]


@dataclasses.dataclass
class CycleCounter:
    """Latency/energy accounting for stateful-logic sequences.

    cycles:  crossbar cycles (latency) -- one per gate *issue*, independent
             of how many rows execute it in parallel.
    gate_evals: total gate evaluations (cycles x parallel rows) -- an
             energy/throughput proxy.
    """

    cycles: int = 0
    gate_evals: int = 0

    def tick(self, n_parallel: int = 1, cycles: int = 1) -> None:
        self.cycles += cycles
        self.gate_evals += cycles * n_parallel

    def __add__(self, other: "CycleCounter") -> "CycleCounter":
        return CycleCounter(self.cycles + other.cycles,
                            self.gate_evals + other.gate_evals)


def maybe_flip(out: torch.Tensor, generator: Optional[torch.Generator],
               p_gate) -> torch.Tensor:
    """Corrupt a gate output: p_gate is a float flip probability (each
    output bit flips independently) or a faults.FaultModel applied to the
    output."""
    if generator is None:
        return out
    model = p_gate if isinstance(p_gate, FaultModel) else \
        TransientGateFaults(float(p_gate))
    return model.corrupt_bits(out, generator)


# --- single-cycle stateful gates -------------------------------------------
# MAGIC natively provides NOR/NOT; FELIX adds OR, NAND and Minority3 in one
# cycle.  AND/XOR/MAJ are multi-cycle compositions; their cycle costs are in
# GATE_COSTS.

def g_not(a, generator=None, p_gate=0.0):
    return maybe_flip(~a, generator, p_gate)


def g_nor(a, b, generator=None, p_gate=0.0):
    return maybe_flip(~(a | b), generator, p_gate)


def g_or(a, b, generator=None, p_gate=0.0):  # FELIX single cycle
    return maybe_flip(a | b, generator, p_gate)


def g_nand(a, b, generator=None, p_gate=0.0):  # FELIX single cycle
    return maybe_flip(~(a & b), generator, p_gate)


def g_and(a, b, generator=None, p_gate=0.0):
    """AND = NOT(NAND): 2 cycles."""
    if generator is None:
        return a & b
    g1, g2 = prng.streams(generator, 2)
    return g_not(g_nand(a, b, g1, p_gate), g2, p_gate)


def g_min3(a, b, c, generator=None, p_gate=0.0):
    """Minority3 (FELIX, single cycle): NOT(majority(a,b,c)).

    This is the paper's voting gate.
    """
    maj = (a & b) | (b & c) | (a & c)
    return maybe_flip(~maj, generator, p_gate)


def g_maj3(a, b, c, generator=None, p_gate=0.0):
    """Majority = NOT(Minority3): 2 cycles (Min3 then NOT)."""
    if generator is None:
        return (a & b) | (b & c) | (a & c)
    g1, g2 = prng.streams(generator, 2)
    return g_not(g_min3(a, b, c, g1, p_gate), g2, p_gate)


def g_xor(a, b, generator=None, p_gate=0.0):
    """XOR via 5 NOR gates (NOR-only decomposition):

      x1 = NOR(a, b); x2 = NOR(a, x1); x3 = NOR(b, x1);
      x4 = NOR(x2, x3) = XNOR; out = NOT(x4).
    """
    if generator is None:
        return a ^ b
    g = prng.streams(generator, 5)
    x1 = g_nor(a, b, g[0], p_gate)
    x2 = g_nor(a, x1, g[1], p_gate)
    x3 = g_nor(b, x1, g[2], p_gate)
    x4 = g_nor(x2, x3, g[3], p_gate)
    return g_not(x4, g[4], p_gate)


#: crossbar cycles per logical op (FELIX gate set)
GATE_COSTS = {
    "not": 1,
    "nor": 1,
    "or": 1,
    "nand": 1,
    "min3": 1,
    "and": 2,
    "maj3": 2,
    "xor": 5,
}
