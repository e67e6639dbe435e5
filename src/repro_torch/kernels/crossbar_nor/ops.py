"""Public gate-serial netlist ops.

`crossbar_nor` is the TPU kernel's function: Minority3 gates in list order
over a (tw, n_wires) trial-packed state, fault-free, for any gate list (a
wire may be written several times, a gate may read the wire it writes).
`execute_netlist` packs bool trials into 32-bit lane words
(core/bitops.pack_trials layout), loads the constant and input wires, runs
it and unpacks the outputs.  The kernels/netlist_exec engine carries the
fault experiments; this one is the fault-free golden run.

The kernel runs from a plan of the gate list made on the host (plan.py,
found by the list's exact bytes), so the op copies a CUDA gate list to the
host, a sync, each call; `execute_netlist` holds the list on the host
already and launches from it (`launch`).  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ...core.bitops import PACK, pack_trials, unpack_trials
from ...core.netlist import Netlist
from ..netlist_exec.plan import launch_tile
from . import kernel
from . import plan as _plan
from .ref import crossbar_nor_ref

__all__ = ["crossbar_nor", "execute_netlist", "launch"]


def crossbar_nor(gates: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """gates: (G, 4) int32 (in1, in2, in3, out) wire ids; state: (tw,
    n_wires) int32 packed trials.  Returns the final wire state (a new
    tensor).  On a CUDA tensor, raises ValueError where the versions live
    at once do not fit a CTA's shared memory even at one trial word
    (plan.Plan.tile)."""
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
    if state.device.type == "cpu":
        _plan.check_wires(gates.numpy(), state.shape[1])
        return crossbar_nor_ref(gates, state)
    if state.device.type != "cuda":
        raise ValueError(f"unsupported device {state.device}")
    return launch(gates.cpu().numpy(), state)


def launch(gates: np.ndarray, state: torch.Tensor) -> torch.Tensor:
    """The kernel over a CUDA `state` (contiguous int32 (tw, n_wires)) from
    a host gate list ((G, 4) wire ids): its plan, then one launch.  Raises
    ValueError on a wire out of range or live versions over the budget."""
    tw, n_wires = state.shape
    plan = _plan.plan(gates, n_wires)                  # checks the wires
    tile = launch_tile(plan.tile(), tw, torch.cuda.get_device_properties(
        state.device).multi_processor_count)
    out = torch.empty_like(state)
    kernel.crossbar_nor(plan, tile, state, out)
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
    if dev.type == "cuda":
        out = launch(nl.gates, state)                 # no copy back to host
    else:
        out = crossbar_nor(torch.as_tensor(nl.gates, device=dev), state)
    return unpack_trials(
        out[:, torch.as_tensor(nl.outputs, device=dev).long()], trials)
