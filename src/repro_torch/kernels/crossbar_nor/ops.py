"""Public gate-serial netlist ops.

`crossbar_nor` is the TPU kernel's function: Minority3 gates in list order
over a (tw, n_wires) trial-packed state, fault-free.  `execute_netlist`
packs bool trials into 32-bit lane words (core/bitops.pack_trials layout),
loads the constant and input wires, runs it and unpacks the outputs.  The
levelized kernels/netlist_exec engine carries the fault experiments; this
one is the gate-serial golden run.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from .. import _build
from ...core.bitops import PACK, pack_trials, unpack_trials
from ...core.netlist import Netlist
from . import kernel
from .ref import crossbar_nor_ref

__all__ = ["crossbar_nor", "execute_netlist"]


def crossbar_nor(gates: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """gates: (G, 4) int32 (in1, in2, in3, out) wire ids; state: (tw,
    n_wires) int32 packed trials.  Returns the final wire state (a new
    tensor)."""
    if (gates.dtype != torch.int32 or gates.ndim != 2
            or gates.shape[1] != 4 or not gates.is_contiguous()):
        raise ValueError(f"crossbar_nor: gates must be a contiguous int32 "
                         f"(G, 4), got {gates.dtype} {tuple(gates.shape)}")
    if (state.dtype != torch.int32 or state.ndim != 2
            or not state.is_contiguous() or gates.device != state.device):
        raise ValueError(f"crossbar_nor: state must be a contiguous int32 "
                         f"(tw, n_wires) on {gates.device}, got "
                         f"{state.dtype} {tuple(state.shape)} on "
                         f"{state.device}")
    n_wires = state.shape[1]
    if gates.numel() and bool(((gates < 0) | (gates >= n_wires)).any()):
        raise ValueError(f"crossbar_nor: a gate names a wire outside "
                         f"[0, {n_wires})")
    if state.device.type == "cpu":
        return crossbar_nor_ref(gates, state)
    if state.device.type != "cuda":
        raise ValueError(f"unsupported device {state.device}")
    if n_wires > kernel.max_wires():
        raise ValueError(f"crossbar_nor: {n_wires} wires exceed one block's "
                         f"shared memory ({kernel.max_wires()} words)")
    if gates.data_ptr() % 16:
        gates = gates.clone()       # the kernel reads a gate as 16 bytes
    out = torch.empty_like(state)
    kernel.crossbar_nor(gates, state, out)
    _build.count_launch("crossbar_nor")
    return out


def execute_netlist(nl: Netlist, inputs: torch.Tensor) -> torch.Tensor:
    """inputs: bool (trials, n_in) -> bool (trials, n_out), fault-free, on
    the inputs' device."""
    trials, dev = inputs.shape[0], inputs.device
    tw = -(-trials // PACK)
    state = torch.zeros((tw, nl.n_wires), dtype=torch.int32, device=dev)
    state[:, 1] = -1                                  # const ONE wire
    state[:, torch.as_tensor(nl.inputs, device=dev).long()] = \
        pack_trials(inputs)
    out = crossbar_nor(torch.as_tensor(nl.gates, device=dev), state)
    return unpack_trials(
        out[:, torch.as_tensor(nl.outputs, device=dev).long()], trials)
