"""ctypes binding of the gate-serial netlist CUDA kernel
(csrc/crossbar_nor.cu), the Hopper counterpart of the TPU
`netlist_kernel`.  Callers pass validated CUDA tensors (ops.py)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_DECLARED = False


def _lib() -> ctypes.CDLL:
    global _DECLARED
    lib = _build.library("crossbar_nor")
    if not _DECLARED:
        lib.crossbar_nor.argtypes = [_P, _I, _P, _P, _LL, _I, _P]
        lib.crossbar_nor.restype = _I
        lib.crossbar_nor_max_wires.argtypes = []
        lib.crossbar_nor_max_wires.restype = _I
        _DECLARED = True
    return lib


def max_wires() -> int:
    """The most wires a trial word's state may have (one block's shared
    memory on this card)."""
    return _lib().crossbar_nor_max_wires()


def crossbar_nor(gates: torch.Tensor, state: torch.Tensor,
                 out: torch.Tensor) -> None:
    lib = _lib()
    code = lib.crossbar_nor(
        gates.data_ptr(), gates.shape[0], state.data_ptr(), out.data_ptr(),
        state.shape[0], state.shape[1],
        torch.cuda.current_stream(state.device).cuda_stream)
    _build.check(lib, code, "crossbar_nor")
