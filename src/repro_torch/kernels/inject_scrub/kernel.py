"""ctypes binding of the fused inject+scrub CUDA kernel
(csrc/inject_scrub.cu), the Hopper counterpart of the TPU
`inject_scrub_kernel`.  Callers pass validated CUDA tensors (ops.py)."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_DECLARED = False


def _lib() -> ctypes.CDLL:
    global _DECLARED
    lib = _build.library("inject_scrub")
    if not _DECLARED:
        lib.inject_scrub.argtypes = [_P, _P, _LL, _P, _LL, _P, _I, _P, _I,
                                     _I, _I, _P, _P]
        lib.inject_scrub.restype = _I
        _DECLARED = True
    return lib


def inject_scrub(words: torch.Tensor, mask: torch.Tensor,
                 parity: torch.Tensor, parity_out: Optional[torch.Tensor],
                 out_all: bool, slopes: Tuple[int, ...],
                 counts: torch.Tensor) -> None:
    lib = _lib()
    code = lib.inject_scrub(
        words.data_ptr(), mask.data_ptr(), words.numel() // 32,
        parity.data_ptr(), parity.shape[0],
        parity_out.data_ptr() if parity_out is not None else None,
        int(out_all), (ctypes.c_int * len(slopes))(*slopes), len(slopes),
        slopes.index(1), slopes.index(2), counts.data_ptr(),
        torch.cuda.current_stream(words.device).cuda_stream)
    _build.check(lib, code, "inject_scrub")
