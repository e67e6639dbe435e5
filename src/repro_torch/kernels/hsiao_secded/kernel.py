"""ctypes binding of the Hsiao SEC-DED CUDA kernels (csrc/hsiao_secded.cu),
the Hopper counterparts of the TPU `encode_hsiao_kernel` and
`scrub_hsiao_kernel`.  Callers pass validated CUDA tensors (ops.py)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from .code import CHECK_MASKS, DATA_COLUMNS

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_DECLARED = False
_MASKS = (ctypes.c_uint32 * len(CHECK_MASKS))(*CHECK_MASKS)
_COLUMNS = (ctypes.c_int * len(DATA_COLUMNS))(*DATA_COLUMNS)


def _lib() -> ctypes.CDLL:
    global _DECLARED
    lib = _build.library("hsiao_secded")
    if not _DECLARED:
        lib.hsiao_encode.argtypes = [_P, _LL, _P, _P, _P, _P]
        lib.hsiao_encode.restype = _I
        lib.hsiao_scrub.argtypes = [_P, _LL, _P, _LL, _P, _I, _P, _P, _P,
                                    _P]
        lib.hsiao_scrub.restype = _I
        _DECLARED = True
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def encode(words: torch.Tensor, parity: torch.Tensor) -> None:
    lib = _lib()
    code = lib.hsiao_encode(words.data_ptr(), words.numel() // 32,
                            parity.data_ptr(), _MASKS, _COLUMNS,
                            _stream(words))
    _build.check(lib, code, "hsiao_encode")


def scrub(words: torch.Tensor, parity: torch.Tensor,
          parity_out: Optional[torch.Tensor], out_all: bool,
          counts: torch.Tensor) -> None:
    lib = _lib()
    code = lib.hsiao_scrub(
        words.data_ptr(), words.numel() // 32, parity.data_ptr(),
        parity.shape[0],
        parity_out.data_ptr() if parity_out is not None else None,
        int(out_all), _MASKS, _COLUMNS, counts.data_ptr(), _stream(words))
    _build.check(lib, code, "hsiao_scrub")
