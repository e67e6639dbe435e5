"""Minority3-normalized gate netlists with fault injection (port of
`repro.core.netlist`).

The mMPU maps arithmetic functions to sequences of stateful gates (§III-B).
A function is a *netlist* of Minority3 gates (every FELIX/MAGIC gate is
Min3 with constant inputs: NOR(a,b)=Min3(a,b,1), NAND(a,b)=Min3(a,b,0),
NOT(a)=Min3(a,a,0)), executed sequentially -- exactly the "micro-code gate
requests" the paper's modified MultPIM simulator injects faults into
(§VI-A).  The netlist and its builder are host numpy, as in the reference,
and build the same arrays.

`execute` is the gate-serial reference, vectorized over trials (= crossbar
row parallelism).  Fault modes:

* iid          -- every gate output flips w.p. p_gate (direct soft errors)
* single-fault -- trial t flips exactly gate fault_gate[t]; with
                  fault_gate = arange(G) one pass measures logical masking
                  of every gate position exhaustively
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..faults.models import FaultModel, TransientGateFaults
from .bitops import unpack_trials

__all__ = ["Netlist", "NetlistBuilder", "execute", "full_adder",
           "gate_fault_model"]


@dataclasses.dataclass(frozen=True)
class Netlist:
    n_wires: int
    inputs: np.ndarray        # (n_in,) wire ids
    outputs: np.ndarray       # (n_out,) wire ids
    gates: np.ndarray         # (G, 4) int32: in1, in2, in3, out (all Min3)

    @property
    def n_gates(self) -> int:
        return int(self.gates.shape[0])


class NetlistBuilder:
    """Builds Min3 netlists with constant folding, duplicate-input
    simplification and structural-hash CSE (keeps the gate count honest vs.
    hand-mapped micro-code).

    CSE: Min3 is symmetric and every gate is pure SSA (each output is a
    fresh wire computed only from earlier wires), so two gates with the
    same *sorted* input triple always carry the same value — the second
    emission returns the first gate's output wire instead of a new gate.
    Pass cse=False to keep duplicates (e.g. to measure the reduction).
    """

    ZERO = 0
    ONE = 1

    def __init__(self, cse: bool = True):
        self._n = 2                    # wires 0/1 are constants
        self._gates: List[tuple] = []
        self._inputs: List[int] = []
        self._outputs: List[int] = []
        self._cse: Optional[Dict[Tuple[int, int, int], int]] = \
            {} if cse else None

    # -- wires ---------------------------------------------------------------
    def input_bits(self, n: int) -> List[int]:
        ws = list(range(self._n, self._n + n))
        self._n += n
        self._inputs.extend(ws)
        return ws

    def mark_outputs(self, wires: Sequence[int]) -> None:
        self._outputs.extend(int(w) for w in wires)

    def _emit(self, a: int, b: int, c: int) -> int:
        if self._cse is not None:
            key = tuple(sorted((a, b, c)))
            hit = self._cse.get(key)
            if hit is not None:
                return hit
        out = self._n
        self._n += 1
        self._gates.append((a, b, c, out))
        if self._cse is not None:
            self._cse[key] = out
        return out

    # -- primitive: Minority3 with folding -----------------------------------
    def min3(self, a: int, b: int, c: int) -> int:
        ins = sorted((a, b, c))
        consts = [w for w in ins if w in (self.ZERO, self.ONE)]
        # fully constant
        if len(consts) == 3:
            maj = sum(1 for w in ins if w == self.ONE) >= 2
            return self.ZERO if maj else self.ONE
        # two constants: result is const or NOT(x)
        if len(consts) == 2:
            x = next(w for w in ins if w not in (self.ZERO, self.ONE))
            ones = consts.count(self.ONE)
            if ones == 2:
                return self.ZERO            # maj = 1
            if ones == 0:
                return self.ONE             # maj = 0
            return self._emit(x, x, self.ZERO)  # maj = x -> NOT x
        # duplicate non-const input: Min3(a,a,c) = NOT a
        if a == b or a == c:
            return self._emit(a, a, self.ZERO)
        if b == c:
            return self._emit(b, b, self.ZERO)
        return self._emit(a, b, c)

    # -- derived gates -------------------------------------------------------
    def not_(self, a: int) -> int:
        if a == self.ZERO:
            return self.ONE
        if a == self.ONE:
            return self.ZERO
        return self.min3(a, a, self.ZERO)

    def nor(self, a: int, b: int) -> int:
        return self.min3(a, b, self.ONE)

    def nand(self, a: int, b: int) -> int:
        return self.min3(a, b, self.ZERO)

    def and_(self, a: int, b: int) -> int:
        if a == self.ZERO or b == self.ZERO:
            return self.ZERO
        if a == self.ONE:
            return b
        if b == self.ONE:
            return a
        return self.not_(self.nand(a, b))

    def or_(self, a: int, b: int) -> int:
        if a == self.ONE or b == self.ONE:
            return self.ONE
        if a == self.ZERO:
            return b
        if b == self.ZERO:
            return a
        return self.not_(self.nor(a, b))

    def xor(self, a: int, b: int) -> int:
        if a == self.ZERO:
            return b
        if b == self.ZERO:
            return a
        if a == self.ONE:
            return self.not_(b)
        if b == self.ONE:
            return self.not_(a)
        if a == b:
            return self.ZERO
        # 5-NOR decomposition
        x1 = self.nor(a, b)
        x2 = self.nor(a, x1)
        x3 = self.nor(b, x1)
        return self.not_(self.nor(x2, x3))

    def maj3(self, a: int, b: int, c: int) -> int:
        if a == self.ZERO:
            return self.and_(b, c)
        if b == self.ZERO:
            return self.and_(a, c)
        if c == self.ZERO:
            return self.and_(a, b)
        if a == self.ONE:
            return self.or_(b, c)
        if b == self.ONE:
            return self.or_(a, c)
        if c == self.ONE:
            return self.or_(a, b)
        return self.not_(self.min3(a, b, c))

    def build(self) -> Netlist:
        return Netlist(
            n_wires=self._n,
            inputs=np.asarray(self._inputs, np.int32),
            outputs=np.asarray(self._outputs, np.int32),
            gates=np.asarray(self._gates, np.int32).reshape(-1, 4),
        )


def full_adder(bld: NetlistBuilder, a: int, b: int, c: int):
    """sum = a^b^c (10 gates), carry = Maj3 (2 gates); folds to a half adder
    when any input is constant."""
    s = bld.xor(bld.xor(a, b), c)
    cout = bld.maj3(a, b, c)
    return s, cout


def gate_fault_model(generator: Optional[torch.Generator],
                     p_gate) -> Optional[FaultModel]:
    """The iid gate-fault model a call asks for, or None: a float p_gate
    means TransientGateFaults(p_gate); no generator means no faults."""
    if generator is None:
        return None
    if isinstance(p_gate, FaultModel):
        return p_gate
    return TransientGateFaults(float(p_gate)) if p_gate > 0.0 else None


def execute(nl: Netlist, inputs: torch.Tensor,
            generator: Optional[torch.Generator] = None, p_gate=0.0,
            fault_gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the netlist on a batch of input vectors, one gate at a time (the
    reference's lax.scan path), on the inputs' device.

    inputs:     bool (trials, n_in)
    generator/p_gate: iid per-gate fault injection; p_gate may also be any
                faults.FaultModel; all gates' faults are one draw of its
                `gate_lane_masks`, as in the levelized engines
    fault_gate: int (trials,) -- trial t flips exactly gate fault_gate[t]
                (exhaustive single-fault analysis); -1 disables for a trial.

    Returns bool (trials, n_out).  The levelized engines (core/scheduler.py,
    kernels/netlist_exec) are bit-exact against this path, fault streams
    included.
    """
    trials, dev = inputs.shape[0], inputs.device
    state = torch.zeros((trials, nl.n_wires), dtype=torch.bool, device=dev)
    state[:, 1] = True
    state[:, torch.as_tensor(nl.inputs, device=dev).long()] = inputs
    model = gate_fault_model(generator, p_gate)
    if model is not None:
        keep, flip = (unpack_trials(m.to(dev).T, trials) for m in
                      model.gate_lane_masks(generator, nl.n_gates, trials))
    if fault_gate is not None:
        fault_gate = fault_gate.to(dev)
    for gid, (i1, i2, i3, out) in enumerate(nl.gates.tolist()):
        a, b, c = state[:, i1], state[:, i2], state[:, i3]
        val = ~((a & b) | (b & c) | (a & c))
        if model is not None:
            val = (val & keep[:, gid]) ^ flip[:, gid]
        if fault_gate is not None:
            val = val ^ (fault_gate == gid)
        state[:, out] = val
    return state[:, torch.as_tensor(nl.outputs, device=dev).long()]
