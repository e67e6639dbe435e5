"""Neural-net pieces of the dense family (port of `repro.models.nn`):
RMSNorm, RoPE, the SwiGLU MLP, the embedding specs and the cross
entropy."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import Spec

__all__ = ["rms_norm", "rope", "mlp_specs", "mlp_apply", "embed_specs",
           "softmax_xent"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + scale), the mean taken in fp32
    of the squares in x's dtype, as the reference."""
    dt = x.dtype
    ms = x.square().float().mean(-1, keepdim=True)
    inv = torch.rsqrt(ms + eps)
    return x * inv.to(dt) * (1.0 + scale).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., seq, heads, head_dim); positions:
    (..., seq)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[..., None] * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    gated = cfg.act in ("swiglu", "geglu")
    return {"w_up": Spec((d, 2 * f if gated else f), ("model_dim", "ff")),
            "w_down": Spec((f, d), ("ff", "model_dim"))}


def mlp_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
              d_ff: Optional[int] = None) -> torch.Tensor:
    if cfg.act != "swiglu":
        raise NotImplementedError(f"activation {cfg.act!r} is not ported")
    f = d_ff or cfg.d_ff
    dt = x.dtype
    h = x @ p["w_up"].to(dt)
    h = h[..., :f] * F.silu(h[..., f:])
    return h @ p["w_down"].to(dt)


def embed_specs(cfg: ModelConfig) -> dict:
    v = cfg.padded_vocab
    specs = {"tok": Spec((v, cfg.d_model), ("vocab_in", "model_dim"),
                         "normal", 0.02)}
    if not cfg.tie_embeddings:
        specs["head"] = Spec((cfg.d_model, v), ("model_dim", "vocab"))
    return specs


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy over logits (..., V) in fp32; with a
    mask, the masked mean."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
