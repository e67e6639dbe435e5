"""RG-LRU recurrent block (port of `repro.models.rglru`; RecurrentGemma /
Griffin, arXiv:2402.19427).

Real-gated linear recurrent unit:
    r_t = sigmoid(W_a x_t)            (recurrence gate)
    i_t = sigmoid(W_x x_t)            (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The temporal block is conv1d (width 4) -> RG-LRU, gated by a GeLU branch.
The reference's `jax.lax.associative_scan` over the sequence becomes
`linear_scan`, a log-depth doubling scan in plain PyTorch (ceil(log2 S)
elementwise steps, where a loop over S would launch S times as many
kernels); its fp32 sums run in another order than XLA's, so the two agree
within a tolerance.  Decode is a single-step update, in place on the
cache's conv tail and fp32 state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .nn import gelu, rms_norm
from .params import Spec

__all__ = ["rglru_specs", "rglru_forward", "rglru_decode_step",
           "rglru_cache_specs", "linear_scan"]

_C = 8.0


def _blocks(cfg: ModelConfig) -> int:
    w = cfg.lru_width or cfg.d_model
    nb = cfg.lru_blocks
    while w % nb:
        nb //= 2
    return max(nb, 1)


def rglru_specs(cfg: ModelConfig) -> dict:
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    nb = _blocks(cfg)
    bw = w // nb
    return {
        "ln": Spec((d,), ("model_dim",), "zeros"),
        "w_x": Spec((d, w), ("model_dim", "ff"), "scaled"),       # x branch
        "w_g": Spec((d, w), ("model_dim", "ff"), "scaled"),       # gate branch
        "conv_w": Spec((cfg.conv_width, w), (None, "ff"), "scaled"),
        "conv_b": Spec((w,), ("ff",), "zeros"),
        # Griffin's block-diagonal recurrence and input gates
        "wa": Spec((nb, bw, bw), ("ff", None, None), "scaled"),
        "wi": Spec((nb, bw, bw), ("ff", None, None), "scaled"),
        "lam": Spec((w,), (None,), "ones"),                       # Lambda
        "w_out": Spec((w, d), ("ff", "model_dim"), "scaled"),
    }


def _gates(p, xc: torch.Tensor, cfg: ModelConfig):
    """(a, gated input b) of the recurrence, fp32, from block-diagonal
    gates: block k of the width multiplies only its own (bw, bw) matrix."""
    nb, bw = p["wa"].shape[0], p["wa"].shape[1]
    shape = xc.shape
    xb = xc.float().reshape(shape[:-1] + (nb, bw))
    r = torch.sigmoid(torch.einsum("...kb,kbc->...kc", xb,
                                   p["wa"].float())).reshape(shape)
    i = torch.sigmoid(torch.einsum("...kb,kbc->...kc", xb,
                                   p["wi"].float())).reshape(shape)
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xc.float())
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, for every t:
    each doubling step combines (a, b) with itself shifted by d, so after
    ceil(log2 S) steps position t holds the composition over [0, t]."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_forward(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """Full-sequence forward. x: (B,S,D) -> (out, (conv_tail, h_last))."""
    S = x.shape[1]
    dt = x.dtype
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    xb = h @ p["w_x"].to(dt)                                      # (B,S,W)
    gb = h @ p["w_g"].to(dt)
    W = cfg.conv_width
    conv_tail = xb[:, -(W - 1):, :]
    pad = F.pad(xb, (0, 0, W - 1, 0))                             # causal
    xc = torch.zeros(xb.shape, dtype=torch.float32, device=x.device)
    for t in range(W):
        xc = xc + pad[:, t:t + S].float() * p["conv_w"][t].float()
    xc = (xc + p["conv_b"].float()).to(dt)
    a, b = _gates(p, xc, cfg)                                     # (B,S,W)
    hs = linear_scan(a, b)
    y = hs * gelu(gb.float())
    return y.to(dt) @ p["w_out"].to(dt), (conv_tail, hs[:, -1, :])


def rglru_cache_specs(cfg: ModelConfig, batch: int) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {
        "conv": Spec((batch, cfg.conv_width - 1, w), ("batch", None, "ff"),
                     "zeros"),
        "h": Spec((batch, w), ("batch", "ff"), "zeros", dtype="float32"),
    }


def rglru_decode_step(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      cache: dict):
    """x: (B,1,D); cache {conv (B,W-1,Wd), h (B,Wd) fp32}, both updated in
    place.  Returns (out (B,1,D), cache)."""
    dt = x.dtype
    hin = rms_norm(x, p["ln"], cfg.norm_eps)
    xb = hin @ p["w_x"].to(dt)                                    # (B,1,W)
    gb = hin @ p["w_g"].to(dt)
    window = torch.cat([cache["conv"], xb.to(cache["conv"].dtype)], dim=1)
    xc = (window.float() * p["conv_w"].float()[None]).sum(1) \
        + p["conv_b"].float()                                     # (B,Wd)
    a, b = _gates(p, xc.to(dt), cfg)
    h = cache["h"]
    h.mul_(a).add_(b)
    y = h * gelu(gb[:, 0].float())
    cache["conv"].copy_(window[:, 1:])
    return (y.to(dt) @ p["w_out"].to(dt))[:, None, :], cache
