"""Public levelized netlist-execution ops.

`netlist_exec` is the TPU kernel's function: the whole levelized netlist
over a trial-packed state, in one launch and in place.  `execute_packed`
has the contract of core/netlist.execute (iid p_gate or FaultModel drawn
from a generator, single-fault planes, bool (trials, n_in) in, bool
(trials, n_out) out): scheduling and fault masks are core/scheduler.py's,
shared with the plain levelized path, and only the level loop differs.

Both check the schedule through its shared-memory plan (plan.py, cached by
the exact bytes of rows_in, which a CUDA rows_in is copied to the host
for); a CPU tensor then takes the plain version, a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from ...core import scheduler
from ...core.netlist import Netlist
from . import kernel
from . import plan as _plan
from .ref import netlist_exec_ref

__all__ = ["netlist_exec", "execute_packed"]


def _check(name, t, shape, device):
    if (t.dtype != torch.int32 or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"netlist_exec: {name} must be a contiguous int32 "
                         f"{tuple(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def netlist_exec(rows_in: torch.Tensor, state: torch.Tensor,
                 keep: Optional[torch.Tensor] = None,
                 flip: Optional[torch.Tensor] = None, *,
                 base: int) -> torch.Tensor:
    """rows_in: (L, W, 3) int32 input rows per level (level l may read only
    rows below base + l*W); state: (base + L*W, tw) int32 trial-packed wire
    state, updated in place; keep/flip: optional (L, W, tw) int32
    corruption masks, ``(val & keep) ^ flip`` (flip without keep: a pure
    XOR).  The kernel takes the widest trial tile whose live rows fit a
    CTA's shared memory, narrowed for a small tw (plan.launch_tile).
    Returns `state`."""
    if rows_in.ndim != 3 or rows_in.shape[2] != 3:
        raise ValueError(f"netlist_exec: rows_in must be (L, W, 3), got "
                         f"{tuple(rows_in.shape)}")
    L, W, _ = rows_in.shape
    dev = state.device
    if state.ndim != 2:
        raise ValueError(f"netlist_exec: state must be 2-D, got "
                         f"{tuple(state.shape)}")
    _check("state", state, (base + L * W, state.shape[1]), dev)
    _check("rows_in", rows_in, (L, W, 3), dev)
    if keep is not None and flip is None:
        raise ValueError("netlist_exec: keep needs flip")
    for name, m in (("keep", keep), ("flip", flip)):
        if m is not None:
            _check(name, m, (L, W, state.shape[1]), dev)
    if L == 0:
        return state
    plan = _plan.plan(rows_in.cpu().numpy(), base)     # validates rows_in
    if dev.type == "cpu":
        return netlist_exec_ref(rows_in, state, keep, flip, base=base)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    tw = state.shape[1]
    tile = _plan.launch_tile(
        plan.tile((flip is not None) + (keep is not None)), tw,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    kernel.netlist_exec(plan, tile, state, keep, flip)
    mode = "none" if flip is None else "xor" if keep is None else "keep+xor"
    _build.count_launch("netlist_exec", f"{mode}, tw {tw}")
    return state


def execute_packed(nl: Netlist, inputs: torch.Tensor,
                   generator: Optional[torch.Generator] = None, p_gate=0.0,
                   fault_gate: Optional[torch.Tensor] = None,
                   max_width: Optional[int] = None) -> torch.Tensor:
    """Execute `nl` on bool (trials, n_in) inputs in one kernel launch, on
    the inputs' device."""
    return scheduler.execute_schedule(nl, inputs, generator, p_gate,
                                      fault_gate, max_width, netlist_exec)
