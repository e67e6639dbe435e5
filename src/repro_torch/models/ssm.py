"""Mamba-2 block (port of `repro.models.ssm`; SSD, state-space duality,
arXiv:2405.21060).

Training and prefill use the chunked SSD algorithm: attention-like
products within chunks and a linear recurrence over the chunk states.
Decode is the pure recurrence on a (B, H, P, N) fp32 state.

The reference's three-operand einsums are written here as two-operand
products in a fixed order (the chip machine has no `opt_einsum`, and an
order that formed (B, c, T, T, H, P) would take 51 GB at batch 16 x 2048);
its inter-chunk `lax.scan` is a loop over the chunks.  The fp32 sums run
in another order than XLA's, so results agree within a tolerance, not bit
for bit.  `mamba_decode_step` updates the cache's conv tail and state in
place, as the KV decode does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .nn import rms_norm
from .params import Spec

__all__ = ["mamba_specs", "mamba_forward", "mamba_decode_step",
           "mamba_cache_specs"]


def mamba_specs(cfg: ModelConfig) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    return {
        "ln": Spec((d,), ("model_dim",), "zeros"),
        # order: [z (di) | x (di) | B (n) | C (n) | dt (h)]
        "in_proj": Spec((d, 2 * di + 2 * n + h), ("model_dim", "ff"),
                        "scaled"),
        "conv_w": Spec((cfg.conv_width, conv_dim), (None, "ff"), "scaled"),
        "conv_b": Spec((conv_dim,), ("ff",), "zeros"),
        "A_log": Spec((h,), (None,), "ones"),
        "D": Spec((h,), (None,), "ones"),
        "dt_bias": Spec((h,), (None,), "zeros"),
        "norm": Spec((di,), ("ff",), "zeros"),
        "out_proj": Spec((di, d), ("ff", "model_dim"), "scaled"),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, n = cfg.d_inner, cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq, then SiLU.  xbc: (B,S,C); w: (W,C)."""
    W, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for t in range(W):
        out = out + pad[:, t:t + S].float() * w[t].float()
    return F.silu(out + b.float()).to(xbc.dtype)


def _ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """SSD scan.  x: (B,S,H,P); dt: (B,S,H) (post-softplus); A: (H,)
    negative; Bm/Cm: (B,S,N) (single group).  Returns (B,S,H,P) fp32 and
    the final state (B,H,P,N) fp32."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    S_orig = S
    pad = (-S) % chunk
    if pad:
        # identity padding: dt = 0 gives no input and a unit decay, so the
        # final state is exact and the padded outputs are dropped
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S += pad
    c = S // chunk
    xd = (x.float() * dt.float()[..., None]).reshape(Bsz, c, chunk, H, P)
    a = (dt.float() * A.float()).reshape(Bsz, c, chunk, H)      # log-decay
    B_ = Bm.float().reshape(Bsz, c, chunk, N)
    C_ = Cm.float().reshape(Bsz, c, chunk, N)

    a_cum = torch.cumsum(a, dim=2)                               # (B,c,T,H)
    # intra-chunk: L[i,j] = exp(a_cum[i] - a_cum[j]) for j <= i, masked
    # before the exp (the j > i entries are positive and overflow)
    seg = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]      # (B,c,T,T,H)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()[None, None, :, :, None]
    L = torch.exp(torch.where(causal, seg, -1e30))
    scores = C_ @ B_.transpose(-1, -2)                           # (B,c,T,T)
    # y_diag[i] = sum_j (scores[i,j] L[i,j,h]) xd[j,h]: the elementwise
    # product, then one batched product over j per (b, c, h)
    M = (scores[..., None] * L).permute(0, 1, 4, 2, 3)           # (B,c,H,T,T)
    y_diag = (M @ xd.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)
    del seg, L, M

    # chunk summary states: sum_j exp(a_cum[last] - a_cum[j]) B_j x_j
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)        # (B,c,T,H)
    xs = (decay_states[..., None] * xd).permute(0, 1, 3, 4, 2)   # (B,c,H,P,T)
    chunk_states = xs @ B_[:, :, None]                           # (B,c,H,P,N)

    # inter-chunk linear recurrence; each chunk reads the state before it
    total_decay = torch.exp(a_cum[:, :, -1, :])                  # (B,c,H)
    s = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    prev = []
    for ci in range(c):
        prev.append(s)
        s = s * total_decay[:, ci, :, None, None] + chunk_states[:, ci]
    prev_states = torch.stack(prev, dim=1)                       # (B,c,H,P,N)

    # inter-chunk contribution: (C_i . state) exp(a_cum[i])
    y_off = (prev_states @ C_.transpose(-1, -2)[:, :, None])     # (B,c,H,P,T)
    y_off = y_off.permute(0, 1, 4, 2, 3) * torch.exp(a_cum)[..., None]

    y = (y_diag + y_off).reshape(Bsz, S, H, P)[:, :S_orig]
    return y, s


def mamba_forward(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """Full-sequence forward (train / prefill): (out, (conv_tail, state))."""
    B, S, _ = x.shape
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dt_ = x.dtype
    hin = rms_norm(x, p["ln"], cfg.norm_eps)
    zxbcdt = hin @ p["in_proj"].to(dt_)
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    conv_tail = xbc[:, -(cfg.conv_width - 1):, :]                # decode cache
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xin = xbc[..., :di].reshape(B, S, h, cfg.ssm_headdim)
    Bm = xbc[..., di:di + n]
    Cm = xbc[..., di + n:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y, state = _ssd_chunked(xin, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + xin.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(B, S, di)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = y * F.silu(z.float())
    y = rms_norm(y.to(dt_), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(dt_), (conv_tail, state)


def mamba_cache_specs(cfg: ModelConfig, batch: int) -> dict:
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    return {
        "conv": Spec((batch, cfg.conv_width - 1, conv_dim),
                     ("batch", None, "ff"), "zeros"),
        "state": Spec((batch, h, cfg.ssm_headdim, n),
                      ("batch", None, None, None), "zeros", dtype="float32"),
    }


def mamba_decode_step(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      cache: dict):
    """Single-token recurrence.  x: (B,1,D); cache {conv (B,W-1,C), state
    (B,H,P,N) fp32}, both updated in place.  Returns (out, cache)."""
    B = x.shape[0]
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dt_ = x.dtype
    hin = rms_norm(x, p["ln"], cfg.norm_eps)
    zxbcdt = hin @ p["in_proj"].to(dt_)
    z, xbc_t, dt_raw = _split_proj(cfg, zxbcdt)                  # (B,1,*)
    window = torch.cat([cache["conv"], xbc_t.to(cache["conv"].dtype)], 1)
    conv_out = (window.float() * p["conv_w"].float()[None]).sum(
        1, keepdim=True) + p["conv_b"].float()
    xbc = F.silu(conv_out).to(dt_)                               # (B,1,C)
    xin = xbc[..., :di].reshape(B, h, cfg.ssm_headdim).float()
    Bm = xbc[:, 0, di:di + n].float()                            # (B,N)
    Cm = xbc[:, 0, di + n:].float()
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"].float())  # (B,H)
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * A[None, :])                           # (B,H)
    s = cache["state"]                                           # (B,H,P,N)
    upd = (dt[:, :, None] * xin)[..., None] * Bm[:, None, None, :]
    s.mul_(decay[..., None, None]).add_(upd)
    y = (s @ Cm[:, None, :, None])[..., 0]                       # (B,H,P)
    y = y + xin * p["D"].float()[None, :, None]
    y = y.reshape(B, 1, di) * F.silu(z.float())
    y = rms_norm(y.to(dt_), p["norm"], cfg.norm_eps)
    cache["conv"].copy_(window[:, 1:])
    return y @ p["out_proj"].to(dt_), cache
