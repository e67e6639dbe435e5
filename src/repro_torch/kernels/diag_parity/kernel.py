"""ctypes binding of the diagonal-parity CUDA kernels (csrc/diag_parity.cu),
the Hopper counterparts of the TPU `encode_parity_kernel` and
`scrub_kernel`.  Callers pass validated CUDA tensors (ops.py)."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_DECLARED = False


def _lib() -> ctypes.CDLL:
    global _DECLARED
    lib = _build.library("diag_parity")
    if not _DECLARED:
        lib.diag_parity_encode.argtypes = [_P, _LL, _P, _P, _I, _P]
        lib.diag_parity_encode.restype = _I
        lib.diag_parity_scrub.argtypes = [_P, _LL, _P, _LL, _P, _I, _P, _I,
                                          _I, _I, _P, _P]
        lib.diag_parity_scrub.restype = _I
        _DECLARED = True
    return lib


def _slopes(slopes: Tuple[int, ...]):
    return (ctypes.c_int * len(slopes))(*slopes)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def encode(words: torch.Tensor, parity: torch.Tensor,
           slopes: Tuple[int, ...]) -> None:
    lib = _lib()
    code = lib.diag_parity_encode(words.data_ptr(), words.numel() // 32,
                                  parity.data_ptr(), _slopes(slopes),
                                  len(slopes), _stream(words))
    _build.check(lib, code, "diag_parity_encode")


def scrub(words: torch.Tensor, parity: torch.Tensor,
          parity_out: Optional[torch.Tensor], out_all: bool,
          slopes: Tuple[int, ...], counts: torch.Tensor) -> None:
    lib = _lib()
    code = lib.diag_parity_scrub(
        words.data_ptr(), words.numel() // 32, parity.data_ptr(),
        parity.shape[0],
        parity_out.data_ptr() if parity_out is not None else None,
        int(out_all), _slopes(slopes), len(slopes), slopes.index(1),
        slopes.index(2), counts.data_ptr(), _stream(words))
    _build.check(lib, code, "diag_parity_scrub")
