"""ctypes binding of the TMR vote CUDA kernel (csrc/tmr_vote.cu), the
Hopper counterpart of the TPU `vote_kernel`."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_DECLARED = False


def _lib() -> ctypes.CDLL:
    global _DECLARED
    lib = _build.library("tmr_vote")
    if not _DECLARED:
        lib.tmr_vote.argtypes = [_P, _P, _P, _P, _LL, _I, _P]
        lib.tmr_vote.restype = _I
        _DECLARED = True
    return lib


def vote(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
         out: torch.Tensor) -> None:
    """Majority of the raw bytes of four same-size contiguous tensors."""
    ptrs = [t.data_ptr() for t in (a, b, c, out)]
    n_bytes = a.numel() * a.element_size()
    width = next(w for w in (16, 4, 1) if all(p % w == 0 for p in ptrs))
    lib = _lib()
    code = lib.tmr_vote(*ptrs, n_bytes, width,
                        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, code, "tmr_vote")
