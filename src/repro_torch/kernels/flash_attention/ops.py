"""Public flash-attention op in the model stack's (B, S, H, hd) layout.

The CUDA kernel addresses q, k, v and the output through their strides, so
no head-major transpose is made (the reference transposes around its TPU
kernel).  A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises."""
from __future__ import annotations

import torch

from .. import _build
from . import kernel
from .ref import flash_attention_ref

__all__ = ["flash_attention"]

HEAD_DIM_MAX = 256


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) -> (B, Sq, H, hd).

    Full-sequence attention only (q_offset == 0), as the reference's kernel
    path.  The CUDA kernel has its own fixed tiles (the config's q_block /
    kv_block size the TPU kernel and the blocked path): bfloat16 runs on
    the tensor cores (`wgmma`, P rounded to bfloat16 before P.V), float32
    on CUDA cores."""
    if q_offset != 0:
        raise ValueError("flash_attention covers full-sequence attention "
                         "(q_offset must be 0)")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,Sq,H,hd), k/v (B,Sk,KV,hd); got "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"incompatible q {tuple(q.shape)} / k "
                         f"{tuple(k.shape)}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 "
                         f"q/k/v of one dtype, got {q.dtype} {k.dtype} "
                         f"{v.dtype}")
    if hd > HEAD_DIM_MAX or B * H > 65535:
        raise ValueError(f"flash_attention kernel takes head_dim <= "
                         f"{HEAD_DIM_MAX} and B*H <= 65535, got hd={hd} "
                         f"B*H={B * H}")
    if any(t.stride(3) != 1 for t in (q, k, v)) or \
            k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention kernel needs unit stride along "
                         "head_dim and all operands on one device")
    if q.dtype == torch.bfloat16 and (
            hd % 8 or any(s % 8 for t in (q, k, v) for s in t.stride()[:3])
            or any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError("the bfloat16 flash_attention kernel stages rows by "
                         "16-byte copies: head_dim and the batch, sequence "
                         "and head strides must be multiples of 8, the "
                         "pointers 16-byte aligned")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    kernel.forward(q, k, v, out, causal, window)
    _build.count_launch("flash_attention",
                        f"B={B} Sq={Sq} Sk={k.shape[1]} H={H} KV={KV} hd={hd} "
                        f"{'causal' if causal else 'full'} window={window} "
                        f"{str(q.dtype)[6:]}")
    return out
