"""ctypes binding of the levelized netlist CUDA kernel
(csrc/netlist_exec.cu), the Hopper counterpart of the TPU
`netlist_exec_kernel`.  Callers pass validated CUDA tensors and the
schedule's shared-memory plan (ops.py)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from .plan import Plan

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_DECLARED = False

#: mask modes of the kernel template
NONE, XOR, KEEP_XOR = 0, 1, 2


def _lib() -> ctypes.CDLL:
    global _DECLARED
    lib = _build.library("netlist_exec")
    if not _DECLARED:
        lib.netlist_exec.argtypes = [_P, _P, _I, _I, _P, _P, _P, _I, _I, _I,
                                     _LL, _I, _P]
        lib.netlist_exec.restype = _I
        _DECLARED = True
    return lib


def netlist_exec(plan: Plan, tile: int, state: torch.Tensor,
                 keep: Optional[torch.Tensor],
                 flip: Optional[torch.Tensor]) -> None:
    mode = NONE if flip is None else XOR if keep is None else KEEP_XOR
    desc, base_slot = plan.on(state.device)
    lib = _lib()
    code = lib.netlist_exec(
        desc.data_ptr(), base_slot.data_ptr(), plan.n_slots, tile,
        state.data_ptr(), keep.data_ptr() if keep is not None else None,
        flip.data_ptr() if flip is not None else None, plan.L, plan.W,
        plan.base, state.shape[1], mode,
        torch.cuda.current_stream(state.device).cuda_stream)
    _build.check(lib, code, "netlist_exec")
