"""ctypes binding of the flash-attention CUDA kernel
(csrc/flash_attention.cu), the Hopper counterpart of the TPU
`flash_attention_kernel`."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DECLARED = False


def _lib() -> ctypes.CDLL:
    global _DECLARED
    lib = _build.library("flash_attention")
    if not _DECLARED:
        lib.flash_attention_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                            _I, _I, _I, _P, _F, _I, _I, _P]
        lib.flash_attention_fwd.restype = _I
        _DECLARED = True
    return lib


def forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, causal: bool, window: int) -> None:
    """q/out (B, Sq, H, hd), k/v (B, Sk, KV, hd); unit stride on hd."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    lib = _lib()
    code = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], B, H, KV, Sq, Sk, hd,
        (ctypes.c_longlong * 12)(*strides), 1.0 / hd ** 0.5, int(causal),
        int(window), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "flash_attention_fwd")
