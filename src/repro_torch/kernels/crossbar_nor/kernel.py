"""ctypes binding of the levelized netlist CUDA kernel
(csrc/crossbar_nor.cu), the Hopper counterpart of the TPU
`netlist_kernel`.  Callers pass validated CUDA tensors and the gate list's
shared-memory plan (ops.py)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .plan import Plan

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_DECLARED = False


def _lib() -> ctypes.CDLL:
    global _DECLARED
    lib = _build.library("crossbar_nor")
    if not _DECLARED:
        lib.crossbar_nor.argtypes = [_P, _I, _I, _P, _I, _P, _I, _I, _I, _P,
                                     _P, _LL, _I, _P]
        lib.crossbar_nor.restype = _I
        _DECLARED = True
    return lib


def crossbar_nor(plan: Plan, tile: int, state: torch.Tensor,
                 out: torch.Tensor) -> None:
    gd, base, copy_wire = plan.on(state.device)
    lib = _lib()
    code = lib.crossbar_nor(
        gd.data_ptr(), plan.L, plan.W, base.data_ptr(), base.shape[1],
        copy_wire.data_ptr(), copy_wire.numel(), plan.n_slots, tile,
        state.data_ptr(), out.data_ptr(), state.shape[0], state.shape[1],
        torch.cuda.current_stream(state.device).cuda_stream)
    _build.check(lib, code, "crossbar_nor")
