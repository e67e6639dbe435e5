"""Neural-net pieces (port of `repro.models.nn`): RMSNorm, LayerNorm, RoPE,
the activations, the MLP (swiglu, geglu, relu2, gelu), the embedding specs
and the cross entropy.

GELU is the tanh approximation, as `jax.nn.gelu`'s default is
(``approximate=True``); PyTorch's default is the exact erf form."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..pshard import (local_split, model_columns, model_sum, realign,
                      split_of)
from .config import ModelConfig
from .params import Spec

__all__ = ["rms_norm", "layer_norm", "rope", "act_fn", "gelu", "mlp_specs",
           "mlp_apply", "ff_columns", "row_parallel", "embed_specs",
           "softmax_xent"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + scale), the mean taken in fp32
    of the squares in x's dtype, as the reference."""
    dt = x.dtype
    ms = x.square().float().mean(-1, keepdim=True)
    inv = torch.rsqrt(ms + eps)
    return x * inv.to(dt) * (1.0 + scale).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * scale + bias over the last axis, in
    fp32, returned in x's dtype (exported by the reference, used by no
    model there)."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dt)


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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu` at its default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def act_fn(name: str, x: torch.Tensor) -> torch.Tensor:
    """The ungated activation of `name`: relu2 (nemotron's squared ReLU),
    gelu, else silu (the swiglu/geglu gate is applied by the caller)."""
    if name == "relu2":
        r = F.relu(x)
        return r * r
    if name == "gelu":
        return gelu(x)
    return F.silu(x)


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    gated = cfg.act in ("swiglu", "geglu")
    return {"w_up": Spec((d, 2 * f if gated else f), ("model_dim", "ff")),
            "w_down": Spec((f, d), ("ff", "model_dim"))}


def ff_columns(h: torch.Tensor, up: tuple, down_whole: tuple,
               down_logical: tuple, down_dim: int, segments: int):
    """The up projection's output `h` made what the down projection
    reads, when the up projection's ``ff`` columns are this rank's slice
    (`up`, its `pshard.local_split`): where the down projection's ``ff``
    rows (dimension `down_dim` of `down_whole`) are split over the same
    axes, this rank's slice of each of the `segments` packed parts
    (``[u | g]``: `pshard.realign`), else the whole columns.  Returns (h,
    the axes the down projection's partial products are summed over)."""
    axes = up[0]
    if not axes:
        return h, ()
    if split_of(down_whole, down_logical, down_dim)[0] == axes:
        return realign(h, axes, segments), axes
    return model_columns(h, axes), ()


def mlp_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """The MLP of x (..., D).  Where a serving rank's ``w_up`` holds its
    slice of the ``ff`` columns (`launch.placement.local_dims`), it is a
    column-parallel product, the gated halves re-aligned (`ff_columns`),
    then a row-parallel ``w_down`` and the ordered sum over the ranks
    (`row_parallel`)."""
    f = d_ff or cfg.d_ff
    dt = x.dtype
    gated = cfg.act in ("swiglu", "geglu")
    w_up = p["w_up"]
    up = local_split(w_up, (cfg.d_model, 2 * f if gated else f),
                     ("model_dim", "ff"), 1)
    h = x @ w_up.to(dt)
    del w_up
    h, down = ff_columns(h, up, (f, cfg.d_model), ("ff", "model_dim"), 0,
                         2 if gated else 1)
    if gated:
        act = F.silu if cfg.act == "swiglu" else gelu
        half = h.shape[-1] // 2
        h = h[..., :half] * act(h[..., half:])
    else:
        h = act_fn(cfg.act, h)
    return row_parallel(h, p["w_down"], down)


def row_parallel(h: torch.Tensor, w: torch.Tensor, axes) -> torch.Tensor:
    """h @ w in h's dtype; over `axes` (w holds this rank's rows) the sum
    of every rank's partial product, added in rank order in fp32 and
    rounded once (`pshard.model_sum`)."""
    return model_sum(h @ w.to(h.dtype), axes)


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
