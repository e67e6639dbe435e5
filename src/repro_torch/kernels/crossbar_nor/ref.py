"""Plain versions: the gate-serial interpreter over packed words, of the
kernel's own signature, and the gate-serial netlist executor of the core
library (core/netlist.execute, fault-free)."""
from __future__ import annotations

import torch

from ...core.netlist import Netlist, execute


def crossbar_nor_ref(gates: torch.Tensor, state: torch.Tensor
                     ) -> torch.Tensor:
    """gates: (G, 4) int32 Min3 netlist; state: (tw, n_wires) int32 packed
    trials.  Returns the final wire state (a new tensor)."""
    state = state.clone()
    for i1, i2, i3, out in gates.tolist():
        a, b, c = state[:, i1], state[:, i2], state[:, i3]
        state[:, out] = ~((a & b) | (b & c) | (a & c))
    return state


def execute_netlist_ref(nl: Netlist, inputs: torch.Tensor) -> torch.Tensor:
    """inputs: bool (trials, n_in) -> bool (trials, n_out), fault-free."""
    return execute(nl, inputs)
