"""Attention (port of `repro.models.attention`): GQA self-attention with
RoPE and gated cross-attention to a memory (image patches, encoder
states) -- full-matrix (`naive_attention`), blocked
online-softmax (`blocked_attention`) and the hand-written
CUDA flash kernel (``attention_impl="pallas"``, the reference's name, forward
only as the reference's Pallas kernel is) -- plus single-token decode
against a KV cache.  `blocked_attention` carries the reference's recompute
backward as a `torch.autograd.Function`, in plain PyTorch as the
reference's is in `jnp`.

Self-attention on a serving rank whose store keeps the head columns
local (`launch.placement.local_dims`) runs its own heads: ``wq`` / ``wkv``
column-parallel (``[k | v]`` re-aligned), the rank's KV cache holding its
KV heads, ``wo`` row-parallel and the ordered sum (`_project_qkv`,
`_out`).  Cross-attention reads its leaves gathered whole."""
from __future__ import annotations

from typing import Optional

import torch

from ..pshard import local_split, model_columns, realign, split_of
from .config import ModelConfig
from .nn import rms_norm, rope, row_parallel
from .params import Spec

__all__ = ["attn_specs", "attention", "self_attention", "head_split",
           "decode_self_attention", "cross_attn_specs", "cross_attention",
           "blocked_attention", "naive_attention", "NEG_INF"]

NEG_INF = -1e30


def _mask(q_start: int, k_start: int, nq: int, nk: int, causal: bool,
          window: int, device) -> torch.Tensor:
    qpos = q_start + torch.arange(nq, device=device)[:, None]
    kpos = k_start + torch.arange(nk, device=device)[None, :]
    mask = torch.ones((nq, nk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= kpos > qpos - window
    return mask


def naive_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Full score matrix.  q (B,Sq,H,hd); k,v (B,Sk,KV,hd)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / hd ** 0.5
    mask = _mask(q_offset, 0, Sq, k.shape[1], causal, window, q.device)
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _fit(block: int, S: int) -> int:
    block = min(block, S)
    while S % block:
        block //= 2
    return max(block, 1)


def _skip(q_start: int, k_start: int, qb: int, kb: int, causal: bool,
          window: int) -> bool:
    """Does the (q, kv) block pair have no unmasked entry?"""
    if causal and not k_start < q_start + qb:
        return True
    return bool(window) and not k_start + kb > q_start - window + 1


def _blocked_fwd(q, k, v, causal, window, q_offset, qb, kb):
    """Online-softmax forward: out (B,Sq,H,hd) in q's dtype and the fp32
    log-sum-exp (B,KV,G,Sq) the backward recomputes p from."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / hd ** 0.5
    out = torch.empty_like(q)
    lse = torch.empty((B, KV, G, Sq), device=q.device)
    for q0 in range(0, Sq, qb):
        qi = q[:, q0:q0 + qb].float().reshape(B, qb, KV, G, hd) * scale
        q_start = q_offset + q0
        m = torch.full((B, KV, G, qb), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, G, qb), device=q.device)
        acc = torch.zeros((B, KV, G, qb, hd), device=q.device)
        for k0 in range(0, Sk, kb):
            if _skip(q_start, k0, qb, kb, causal, window):
                continue
            ki, vi = k[:, k0:k0 + kb].float(), v[:, k0:k0 + kb].float()
            s = torch.einsum("bqkgd,bskd->bkgqs", qi, ki)
            s = torch.where(_mask(q_start, k0, qb, kb, causal, window,
                                  q.device), s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd",
                                                       p, vi)
            m = m_new
        l = torch.clamp(l, min=1e-30)
        o = acc / l[..., None]                              # (B,KV,G,qb,hd)
        out[:, q0:q0 + qb] = o.permute(0, 3, 1, 2, 4).reshape(
            B, qb, H, hd).to(q.dtype)
        lse[..., q0:q0 + qb] = m + torch.log(l)
    return out, lse


def _blocked_bwd(q, k, v, out, lse, dout, causal, window, q_offset, qb, kb):
    """Flash-style backward: p recomputed per block pair from (q, k, lse);
    the (Sq, Sk) probabilities are never stored."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / hd ** 0.5
    # delta[b, kv, g, s] = sum_d dout * out
    delta = (dout.float() * out.float()).sum(-1)                # (B,Sq,H)
    delta = delta.reshape(B, Sq, KV, G).permute(0, 2, 3, 1)
    dq = torch.empty((B, Sq, H, hd), device=q.device)
    dk = torch.zeros((B, Sk, KV, hd), device=q.device)
    dv = torch.zeros((B, Sk, KV, hd), device=q.device)
    for q0 in range(0, Sq, qb):
        qi = q[:, q0:q0 + qb].float().reshape(B, qb, KV, G, hd) * scale
        doi = dout[:, q0:q0 + qb].float().reshape(B, qb, KV, G, hd)
        lse_i = lse[..., q0:q0 + qb, None]
        delta_i = delta[..., q0:q0 + qb, None]
        q_start = q_offset + q0
        dq_b = torch.zeros((B, qb, KV, G, hd), device=q.device)
        for k0 in range(0, Sk, kb):
            if _skip(q_start, k0, qb, kb, causal, window):
                continue
            ki, vi = k[:, k0:k0 + kb].float(), v[:, k0:k0 + kb].float()
            s = torch.einsum("bqkgd,bskd->bkgqs", qi, ki)
            s = torch.where(_mask(q_start, k0, qb, kb, causal, window,
                                  q.device), s, NEG_INF)
            p = torch.exp(s - lse_i)                        # (B,KV,G,qb,kb)
            dv[:, k0:k0 + kb] += torch.einsum("bkgqs,bqkgd->bskd", p, doi)
            dp = torch.einsum("bqkgd,bskd->bkgqs", doi, vi)
            ds = p * (dp - delta_i)
            dq_b += torch.einsum("bkgqs,bskd->bqkgd", ds, ki) * scale
            dk[:, k0:k0 + kb] += torch.einsum("bkgqs,bqkgd->bskd", ds, qi)
        dq[:, q0:q0 + qb] = dq_b.reshape(B, qb, H, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _BlockedAttention(torch.autograd.Function):
    """`blocked_attention` with the recompute backward (the reference's
    `blocked_attention_core` and its custom VJP): the forward saves q, k,
    v, the output and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, qb, kb):
        out, lse = _blocked_fwd(q, k, v, causal, window, q_offset, qb, kb)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (causal, window, q_offset, qb, kb)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _blocked_bwd(q, k, v, out, lse, dout, *ctx.blocks)
        return dq, dk, dv, None, None, None, None, None


def blocked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      q_block=512, kv_block=1024):
    """Online-softmax blocked attention with a recompute backward.  Block
    pairs with no unmasked entry are skipped in both directions, so causal
    work stays ~triangular."""
    qb, kb = _fit(q_block, q.shape[1]), _fit(kv_block, k.shape[1])
    if not torch.is_grad_enabled() or not (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return _blocked_fwd(q, k, v, causal, window, q_offset, qb, kb)[0]
    return _BlockedAttention.apply(q, k, v, causal, window, q_offset, qb, kb)


def attention(q, k, v, cfg: ModelConfig, *, causal=True, window=0,
              q_offset=0):
    if cfg.attention_impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    if cfg.attention_impl == "pallas":
        from ..kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset)
    return blocked_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, q_block=cfg.q_block,
                             kv_block=cfg.kv_block)


def attn_specs(cfg: ModelConfig) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    specs = {
        "ln": Spec((d,), ("model_dim",), "zeros"),
        "wq": Spec((d, H * hd), ("model_dim", "heads"), "scaled"),
        "wkv": Spec((d, 2 * KV * hd), ("model_dim", "kv_heads"), "scaled"),
        "wo": Spec((H * hd, d), ("heads", "model_dim"), "scaled"),
    }
    if cfg.qkv_bias:
        specs["bq"] = Spec((H * hd,), ("heads",), "zeros")
        specs["bkv"] = Spec((2 * KV * hd,), ("kv_heads",), "zeros")
    return specs


def head_split(cfg: ModelConfig) -> int:
    """Into how many ranks' heads a serving rank's self-attention splits
    on the ambient mesh and rules where its store keeps the head columns
    local (`_project_qkv`): the ranks of the ``heads`` axes, when
    ``kv_heads`` is split over the same axes and both head counts divide;
    else 1, every rank running every head."""
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    axes, n, _ = split_of((cfg.d_model, H * hd), ("model_dim", "heads"), 1)
    kv_axes = split_of((cfg.d_model, 2 * KV * hd),
                       ("model_dim", "kv_heads"), 1)[0]
    ok = axes and kv_axes == axes and H % n == 0 and KV % n == 0
    return n if ok else 1


def _project_qkv(p, cfg: ModelConfig, x, positions):
    """q (B,S,H',hd), k and v (B,S,KV',hd) after RoPE: every head (H' =
    H, KV' = KV), or this rank's where ``wq`` / ``wkv`` hold its slice of
    the head columns over n ranks and n divides H and KV (H' = H / n, KV'
    = KV / n; `wkv`'s packed ``[k | v]`` re-aligned by `pshard.realign`).
    Where the slices fall elsewhere, the projections are still computed
    in place and their columns gathered whole."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    dt = x.dtype
    wq = p["wq"]
    qs = local_split(wq, (cfg.d_model, H * hd), ("model_dim", "heads"), 1)
    q = x @ wq.to(dt)
    del wq
    wkv = p["wkv"]
    kvs = local_split(wkv, (cfg.d_model, 2 * KV * hd),
                      ("model_dim", "kv_heads"), 1)
    kv = x @ wkv.to(dt)
    del wkv
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        kv = kv + p["bkv"].to(dt)
    n = head_split(cfg) if qs[0] and kvs[0] else 1
    if n > 1:
        kv = realign(kv, kvs[0], 2)
        H, KV = H // n, KV // n
    else:
        q, kv = model_columns(q, qs[0]), model_columns(kv, kvs[0])
    q = rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = rope(kv[..., :KV * hd].reshape(B, S, KV, hd), positions,
             cfg.rope_theta)
    v = kv[..., KV * hd:].reshape(B, S, KV, hd)
    return q, k, v


def self_attention(p, cfg: ModelConfig, x, *, causal=True, window=0):
    """Prefill self-attention (pre-norm, pre-residual); returns (output,
    (k, v)) for the cache."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    B, S, _ = h.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, h, positions)
    o = attention(q, k, v, cfg, causal=causal, window=window)
    return _out(p, cfg, o.reshape(B, S, -1)), (k, v)


def _out(p, cfg: ModelConfig, o):
    """o (B,S,H'·hd) @ ``wo``: where ``wo`` holds this rank's slice of the
    head rows, a row-parallel product (o's columns of those rows, when o
    holds every head) and the ordered sum over the ranks
    (`nn.row_parallel`)."""
    wo = p["wo"]
    axes, _, k = local_split(wo, (cfg.n_heads * cfg.head_dim, cfg.d_model),
                             ("heads", "model_dim"), 0)
    rows = wo.shape[0]
    if axes and o.shape[-1] != rows:
        o = o[..., k * rows:(k + 1) * rows]
    return row_parallel(o, wo, axes)


def decode_self_attention(p, cfg: ModelConfig, x, cache_k, cache_v, pos, *,
                          window=0):
    """Single-token decode.  x: (B,1,D); cache_k/v: (B,S,KV,hd); pos: int32
    0-d tensor, the number of tokens already cached (the slot to write), or
    a (B,) int32 vector of per-row positions for continuous batching, where
    each batch row decodes at its own depth (linear cache only).

    The new k/v are written into the caches in place (the reference
    returns updated copies); with a sliding window the cache is a ring
    buffer (scalar `pos` only).  Returns (output, cache_k, cache_v)."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    B = h.shape[0]
    hd = cfg.head_dim
    S = cache_k.shape[1]
    per_row = pos.ndim == 1
    if per_row and window:
        raise NotImplementedError(
            "per-row decode positions do not support sliding-window ring "
            "caches (continuous batching is linear-cache only)")
    q, k, v = _project_qkv(p, cfg, h,
                           pos[:, None] if per_row else pos.reshape(1, 1))
    if per_row:
        # the reference's dynamic_update_slice clamps the write index into
        # the cache (a stale position of an empty slot can run past it)
        rows = torch.arange(B, device=x.device)
        at = pos.long().clamp(0, S - 1)
        cache_k[rows, at] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, at] = v[:, 0].to(cache_v.dtype)
        # per-row validity; slots past a row's position may alias the
        # shared scratch page of a paged pool, so their K/V are zeroed
        # outright -- masking the scores alone would still carry NaN/Inf
        # garbage through 0 * NaN in the value product
        valid = torch.arange(S, device=x.device)[None, :] <= pos[:, None]
        kc = torch.where(valid[:, :, None, None], cache_k, 0)
        vc = torch.where(valid[:, :, None, None], cache_v, 0)
        vmask = valid[:, None, None, None, :]
    else:
        slot = (pos % S if window else pos).reshape(1).long()
        cache_k.index_copy_(1, slot, k.to(cache_k.dtype))
        cache_v.index_copy_(1, slot, v.to(cache_v.dtype))
        kc, vc = cache_k, cache_v
        vmask = torch.arange(S, device=x.device) <= pos
    H, KV = q.shape[2], k.shape[2]      # this rank's heads
    qg = q.reshape(B, 1, KV, H // KV, hd).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, kc.float()) / hd ** 0.5
    scores = torch.where(vmask, scores, NEG_INF)
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = e / e.sum(-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bqkgd", probs, vc.float())
    o = o.reshape(B, 1, H * hd).to(x.dtype)
    return _out(p, cfg, o), cache_k, cache_v


def cross_attn_specs(cfg: ModelConfig, mem_dim: Optional[int] = None) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    md = mem_dim or cfg.d_model
    return {
        "ln": Spec((d,), ("model_dim",), "zeros"),
        "wq": Spec((d, H * hd), ("model_dim", "heads"), "scaled"),
        "wkv": Spec((md, 2 * KV * hd), ("model_dim", "kv_heads"), "scaled"),
        "wo": Spec((H * hd, d), ("heads", "model_dim"), "scaled"),
        "gate": Spec((), (), "zeros"),
    }


def cross_attention(p, cfg: ModelConfig, x, memory):
    """Cross-attention of x (B,S,D) to a (B,M,mem_dim) memory (vision
    patches, encoder states), without RoPE or a mask, gated by
    tanh(gate) as Llama-3.2 vision's cross-attention layers are."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    B, S, _ = h.shape
    M = memory.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    dt = x.dtype
    q = (h @ p["wq"].to(dt)).reshape(B, S, H, hd)
    kv = memory.to(dt) @ p["wkv"].to(dt)
    k = kv[..., :KV * hd].reshape(B, M, KV, hd)
    v = kv[..., KV * hd:].reshape(B, M, KV, hd)
    o = attention(q, k, v, cfg, causal=False)
    out = o.reshape(B, S, -1) @ p["wo"].to(dt)
    return torch.tanh(p["gate"].float()).to(dt) * out
