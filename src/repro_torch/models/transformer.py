"""Model assembly for every family (port of `repro.models.transformer`):
`model_specs`, `forward`, `cache_specs`, `prefill` and `decode_step`.

  dense   : L x [self-attn, MLP]
  moe     : L x [self-attn, MoE (+ optional shared expert)]; with
            ``moe_every`` > 1, each MoE layer follows ``moe_every - 1``
            dense layers (``dense_layers`` stacked (n_moe, moe_every - 1,
            ...)), the Llama-4 interleave
  ssm     : L x [Mamba-2 SSD block]
  hybrid  : cfg.layer_pattern tiled over L, e.g. (R, R, A), the remainder
            a prefix of the pattern -- RG-LRU blocks (``r_layers``) and
            local sliding-window attention blocks (``a_layers``), each
            followed by an MLP
  vlm     : L / every blocks of [1 gated cross-attn layer (``x_layers``) +
            (every - 1) self layers (``self_layers`` stacked (blocks,
            every - 1, ...))] over stub image-patch embeddings
  encdec  : enc_layers x [bidirectional self-attn, MLP] + L x [causal
            self-attn, cross-attn, MLP] over stub frame embeddings

The reference's `lax.scan` over stacked layers becomes a Python loop over
per-layer views of the stacked leaves; a stack of `STACKED` may also be a
list of per-layer trees (a list of lists for the two-level stacks), the
training step's per-layer leaves (`steps.make_train_step`).  `forward`
remats every layer as the reference's scans do (`torch.utils.checkpoint`,
non-reentrant).  `decode_step` writes the new K/V and recurrent states
into the given cache's tensors in place.

One departure: the hybrid's prefill keeps a ring of ``min(cache_len,
local_window)`` slots, as `cache_specs` declares, also when the prompt is
shorter than that (the reference then keeps only the prompt's S slots, so
its decode's ring of S overwrites keys the window still covers).

Logits are not produced here; `steps.py` applies the head."""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core import tree as T
from .attention import (attn_specs, cross_attention, cross_attn_specs,
                        decode_self_attention, self_attention)
from .config import ModelConfig
from .moe import moe_apply, moe_specs
from .nn import embed_specs, mlp_apply, mlp_specs, rms_norm
from .params import Spec
from ..pshard import capture
from .rglru import (rglru_cache_specs, rglru_decode_step, rglru_forward,
                    rglru_specs)
from .ssm import (mamba_cache_specs, mamba_decode_step, mamba_forward,
                  mamba_specs)

__all__ = ["model_specs", "forward", "cache_specs", "prefill", "decode_step",
           "stack_specs", "hybrid_counts", "STACKED"]

#: the stacked layer keys of a params tree and how many leading layer
#: dims each carries
STACKED = {"layers": 1, "r_layers": 1, "a_layers": 1, "x_layers": 1,
           "enc_layers": 1, "dec_layers": 1, "dense_layers": 2,
           "self_layers": 2}


def stack_specs(tree: Any, n: int, extra_axes: Tuple[int, ...] = ()) -> Any:
    """Prepend stacked layer dims (n, *extra_axes) to every Spec in the
    tree."""
    dims = (n,) + tuple(extra_axes)
    return T.map_tree(lambda s: Spec(dims + s.shape,
                                     (None,) * len(dims) + s.axes,
                                     s.init, s.scale, s.dtype), tree)


def hybrid_counts(cfg: ModelConfig):
    """(tiles, remainder pattern, R layers, A layers) of the hybrid."""
    pat = cfg.layer_pattern
    tiles = cfg.n_layers // len(pat)
    rem = pat[:cfg.n_layers % len(pat)]
    n_r = tiles * pat.count("R") + rem.count("R")
    n_a = tiles * pat.count("A") + rem.count("A")
    return tiles, rem, n_r, n_a


def _mlp_specs(cfg: ModelConfig) -> dict:
    return {"ln": Spec((cfg.d_model,), ("model_dim",), "zeros"),
            **mlp_specs(cfg)}


def _dense_layer_specs(cfg: ModelConfig) -> dict:
    return {"attn": attn_specs(cfg), "mlp": _mlp_specs(cfg)}


def _moe_layer_specs(cfg: ModelConfig) -> dict:
    return {"attn": attn_specs(cfg),
            "moe": {"ln": Spec((cfg.d_model,), ("model_dim",), "zeros"),
                    **moe_specs(cfg)}}


def model_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    specs: Dict[str, Any] = {"embed": embed_specs(cfg),
                             "final_ln": Spec((d,), ("model_dim",), "zeros")}
    if cfg.family == "dense":
        specs["layers"] = stack_specs(_dense_layer_specs(cfg), cfg.n_layers)
    elif cfg.family == "moe":
        n_moe = cfg.n_layers // cfg.moe_every
        specs["layers"] = stack_specs(_moe_layer_specs(cfg), n_moe)
        if cfg.moe_every > 1:   # interleaved: (moe_every-1) dense per MoE
            specs["dense_layers"] = stack_specs(_dense_layer_specs(cfg),
                                                n_moe, (cfg.moe_every - 1,))
    elif cfg.family == "ssm":
        specs["layers"] = stack_specs(mamba_specs(cfg), cfg.n_layers)
    elif cfg.family == "hybrid":
        _, _, n_r, n_a = hybrid_counts(cfg)
        specs["r_layers"] = stack_specs(
            {"temporal": rglru_specs(cfg), "mlp": _mlp_specs(cfg)}, n_r)
        specs["a_layers"] = stack_specs(_dense_layer_specs(cfg), n_a)
    elif cfg.family == "vlm":
        every = cfg.cross_attn_every
        nb = cfg.n_layers // every
        specs["x_layers"] = stack_specs(
            {"xattn": cross_attn_specs(cfg, cfg.vis_dim),
             "mlp": _mlp_specs(cfg), "gate_mlp": Spec((), (), "zeros")}, nb)
        specs["self_layers"] = stack_specs(_dense_layer_specs(cfg), nb,
                                           (every - 1,))
    elif cfg.family == "encdec":
        specs["enc_layers"] = stack_specs(_dense_layer_specs(cfg),
                                          cfg.enc_layers)
        specs["dec_layers"] = stack_specs(
            {"attn": attn_specs(cfg), "xattn": cross_attn_specs(cfg),
             "mlp": _mlp_specs(cfg)}, cfg.n_layers)
        specs["enc_final_ln"] = Spec((d,), ("model_dim",), "zeros")
        if cfg.audio_frontend:
            specs["audio_proj"] = Spec((cfg.d_model, d), (None, "model_dim"),
                                       "scaled")
    else:
        raise ValueError(cfg.family)
    return specs


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int,
                mem_len: int = 0, heads: Optional[int] = None) -> dict:
    """Decode-cache Spec tree.  mem_len: the cross-attention memory's
    length (image tokens, encoder frames) for vlm and encdec; heads: the
    self-attention KV heads the cache holds (default all; a serving
    rank's own, `attention.head_split`)."""
    KV, hd = cfg.n_kv, cfg.head_dim
    kv_axes = (None, "batch", "kv_seq", "kv_heads", None)

    def kv(n_layers, length, names=("k", "v")):
        n_kv = (heads or KV) if names == ("k", "v") else KV
        return {n: Spec((n_layers, batch, length, n_kv, hd), kv_axes,
                        "zeros") for n in names}

    specs: Dict[str, Any] = {"pos": Spec((), (), "zeros", dtype="int32")}
    if cfg.family in ("dense", "moe"):
        specs.update(kv(cfg.n_layers, cache_len))
    elif cfg.family == "ssm":
        specs["ssm"] = stack_specs(mamba_cache_specs(cfg, batch),
                                   cfg.n_layers)
    elif cfg.family == "hybrid":
        _, _, n_r, n_a = hybrid_counts(cfg)
        specs.update(kv(n_a, _ring_len(cfg, cache_len)))
        specs["rg"] = stack_specs(rglru_cache_specs(cfg, batch), n_r)
    elif cfg.family == "vlm":
        every = cfg.cross_attn_every
        nb = cfg.n_layers // every
        specs.update(kv(nb * (every - 1), cache_len))
        # precomputed cross K/V over the image memory
        specs.update(kv(nb, mem_len or cfg.vis_tokens, ("xk", "xv")))
    elif cfg.family == "encdec":
        specs.update(kv(cfg.n_layers, cache_len))
        specs.update(kv(cfg.n_layers, mem_len or 1, ("xk", "xv")))
    else:
        raise ValueError(cfg.family)
    return specs


def _ring_len(cfg: ModelConfig, cache_len: int) -> int:
    return min(cache_len, cfg.local_window) if cfg.local_window \
        else cache_len


def _layer(stacked: Any, i: int, j: Optional[int] = None) -> Any:
    """Layer i (or (i, j) of a two-level stack): a view of the stacked
    leaves, or the entry of a list of per-layer trees."""
    if isinstance(stacked, (list, tuple)):
        return stacked[i] if j is None else stacked[i][j]
    if j is None:
        return T.map_tree(lambda w: w[i], stacked)
    return T.map_tree(lambda w: w[i, j], stacked)


def _schedule(params, cfg: ModelConfig) -> List[Tuple[Any, bool]]:
    """Dense and MoE: (layer weights, is_moe) in execution order; entry l
    writes cache layer l.  MoE with ``moe_every`` > 1 runs pair i as dense
    layers (i, 0 .. moe_every - 2) then MoE layer i."""
    if cfg.family == "dense":
        return [(_layer(params["layers"], i), False)
                for i in range(cfg.n_layers)]
    n_moe = cfg.n_layers // cfg.moe_every
    out = []
    for i in range(n_moe):
        for j in range(cfg.moe_every - 1):
            out.append((_layer(params["dense_layers"], i, j), False))
        out.append((_layer(params["layers"], i), True))
    return out


def _hybrid_schedule(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """(kind, index in its stack) of each hybrid layer in execution order:
    the pattern tiled, then its prefix as the remainder."""
    pat, seen, out = cfg.layer_pattern, {"R": 0, "A": 0}, []
    for li in range(cfg.n_layers):
        kind = pat[li % len(pat)]
        out.append((kind, seen[kind]))
        seen[kind] += 1
    return out


class _EmbedLookup(torch.autograd.Function):
    """Rows of a narrower table, in the compute dtype.  Forward: gather,
    then convert (the values of the reference's convert-then-gather
    without converting the whole table).  Backward: the reference's, the
    token grads scatter-added into the table in the compute dtype and
    rounded to the table's once (a gather in bf16 would add them in
    bf16)."""

    @staticmethod
    def forward(ctx, table, idx, dtype):
        ctx.save_for_backward(idx)
        ctx.shape, ctx.table_dtype = table.shape, table.dtype
        return table[idx].to(dtype)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        out = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        out.index_put_((idx,), g, accumulate=True)
        return out.to(ctx.table_dtype), None, None


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    table, idx = params["embed"]["tok"], tokens.long()
    if table.dtype != cfg.cdtype and table.requires_grad \
            and torch.is_grad_enabled():
        return _EmbedLookup.apply(table, idx, cfg.cdtype)
    # gather, then convert: the same values as the reference's
    # convert-then-gather without converting the whole table
    return table[idx].to(cfg.cdtype)


def _mlp_res(cfg: ModelConfig, x, wl):
    return x + mlp_apply(wl["mlp"], cfg, rms_norm(x, wl["mlp"]["ln"],
                                                  cfg.norm_eps))


def _moe_res(cfg: ModelConfig, x, wl):
    mo, aux = moe_apply(wl["moe"], cfg, rms_norm(x, wl["moe"]["ln"],
                                                 cfg.norm_eps))
    return x + mo, aux


def _dense_body(cfg: ModelConfig, x, wl, causal=True, window=0):
    a, _ = self_attention(wl["attn"], cfg, x, causal=causal, window=window)
    return _mlp_res(cfg, x + a, wl)


def _moe_body(cfg: ModelConfig, x, wl):
    a, _ = self_attention(wl["attn"], cfg, x)
    return _moe_res(cfg, x + a, wl)


def _ssm_body(cfg: ModelConfig, x, wl):
    return x + mamba_forward(wl, cfg, x)[0]


def _rg_body(cfg: ModelConfig, x, wl):
    return _mlp_res(cfg, x + rglru_forward(wl["temporal"], cfg, x)[0], wl)


def _gated_mlp_res(cfg: ModelConfig, x, wl):
    h = rms_norm(x, wl["mlp"]["ln"], cfg.norm_eps)
    gate = torch.tanh(wl["gate_mlp"].float()).to(x.dtype)
    return x + gate * mlp_apply(wl["mlp"], cfg, h)


def _xattn_body(cfg: ModelConfig, x, wl, memory):
    x = x + cross_attention(wl["xattn"], cfg, x, memory)
    return _gated_mlp_res(cfg, x, wl)


def _decdec_body(cfg: ModelConfig, x, wl, memory):
    a, _ = self_attention(wl["attn"], cfg, x, causal=True)
    x = x + a
    x = x + cross_attention(wl["xattn"], cfg, x, memory)
    return _mlp_res(cfg, x, wl)


def _encode(params, cfg: ModelConfig, enc_emb, remat: bool):
    """The encoder over the stub frame embeddings: bidirectional layers,
    then the final norm."""
    mem = enc_emb.to(cfg.cdtype)
    for i in range(cfg.enc_layers):
        mem = _run(functools.partial(_dense_body, causal=False), cfg, mem,
                   _layer(params["enc_layers"], i), remat=remat)
    return rms_norm(mem, params["enc_final_ln"], cfg.norm_eps)


def _run(body, cfg, x, wl, *extra, remat: bool):
    if not remat:
        return body(cfg, x, wl, *extra)
    # the recompute re-enters the ambient mesh context of this forward
    # (autograd runs a CUDA backward on its own thread)
    ctx = capture()

    def run(*args):
        with ctx():
            return body(*args)

    return checkpoint(run, cfg, x, wl, *extra, use_reentrant=False)


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Full-sequence forward to the final hidden states: (hidden (B,S,D),
    aux loss (0-d fp32: the mean over MoE layers of the router's
    load-balance loss, zero for the other families)).  batch: tokens
    (B,S) (the decoder's); vlm: vis_emb (B,M,vis_dim); encdec: enc_emb
    (B,M,d_model).  With grad enabled each layer is rematerialized in the
    backward, so only the layer inputs stay resident."""
    remat = torch.is_grad_enabled()
    x = _embed(params, cfg, batch["tokens"])
    auxs = []
    if cfg.family in ("dense", "moe"):
        for wl, is_moe in _schedule(params, cfg):
            if is_moe:
                x, aux = _run(_moe_body, cfg, x, wl, remat=remat)
                auxs.append(aux)
            else:
                x = _run(_dense_body, cfg, x, wl, remat=remat)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x = _run(_ssm_body, cfg, x, _layer(params["layers"], i),
                     remat=remat)
    elif cfg.family == "hybrid":
        attn = functools.partial(_dense_body, window=cfg.local_window)
        for kind, i in _hybrid_schedule(cfg):
            if kind == "R":
                x = _run(_rg_body, cfg, x, _layer(params["r_layers"], i),
                         remat=remat)
            else:
                x = _run(attn, cfg, x, _layer(params["a_layers"], i),
                         remat=remat)
    elif cfg.family == "vlm":
        mem = batch["vis_emb"]
        for bi in range(cfg.n_layers // cfg.cross_attn_every):
            x = _run(_xattn_body, cfg, x, _layer(params["x_layers"], bi), mem,
                     remat=remat)
            for si in range(cfg.cross_attn_every - 1):
                x = _run(_dense_body, cfg, x,
                         _layer(params["self_layers"], bi, si), remat=remat)
    elif cfg.family == "encdec":
        mem = _encode(params, cfg, batch["enc_emb"], remat)
        for i in range(cfg.n_layers):
            x = _run(_decdec_body, cfg, x, _layer(params["dec_layers"], i),
                     mem, remat=remat)
    else:
        raise ValueError(cfg.family)
    aux = (torch.stack(auxs).mean() if auxs else
           torch.zeros((), dtype=torch.float32, device=x.device))
    return rms_norm(x, params["final_ln"], cfg.norm_eps), aux


def _precompute_cross_kv(p, cfg: ModelConfig, memory):
    """The cross-attention K/V of a (B,M,mem_dim) memory, (B,M,KV,hd)."""
    KV, hd = cfg.n_kv, cfg.head_dim
    B, M, _ = memory.shape
    kv = memory.to(cfg.cdtype) @ p["wkv"].to(cfg.cdtype)
    return (kv[..., :KV * hd].reshape(B, M, KV, hd),
            kv[..., KV * hd:].reshape(B, M, KV, hd))


def _cross_cached(p, cfg: ModelConfig, x, xk, xv):
    """Cross-attention of x (B,1,D) against precomputed memory K/V."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    B = h.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    dt = x.dtype
    q = (h @ p["wq"].to(dt)).reshape(B, 1, KV, H // KV, hd).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, xk.float()) / hd ** 0.5
    pr = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", pr, xv.float())
    out = o.reshape(B, 1, H * hd).to(dt) @ p["wo"].to(dt)
    return torch.tanh(p["gate"].float()).to(dt) * out


def _ring_from_prefill(k, window: int, S: int):
    """The last `window` keys of (B,S,KV,hd) arranged so that slot(p) =
    p % window (the reference's `jnp.roll`)."""
    return torch.roll(k[:, -window:], S % window, dims=1)


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            cache_len: Optional[int] = None):
    """Run the prompt and build the decode cache: (hidden_last (B,1,D),
    cache).  Dense and MoE: {pos, k, v} with k/v (n_layers, B, cache_len,
    KV, hd), cache layer l written by the l-th layer run (interleaved MoE:
    the reference's (n_pairs, moe_every) -> n_layers order).  ssm: {pos,
    ssm: {conv, state}}; hybrid: {pos, k, v (the A layers' rings), rg:
    {conv, h}}; vlm and encdec: {pos, k, v, xk, xv}, the cross K/V over
    the whole memory."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache_len = cache_len or S
    x = _embed(params, cfg, tokens)
    dev, KV, hd = x.device, cfg.n_kv, cfg.head_dim

    def kv_buffers(n_layers, length, heads=KV):
        # `heads`: the first layer's k's, this rank's KV heads where a
        # serving store keeps them local (`attention._project_qkv`)
        shape = (n_layers, B, length, heads, hd)
        return (torch.zeros(shape, dtype=cfg.cdtype, device=dev),
                torch.zeros(shape, dtype=cfg.cdtype, device=dev))

    # a fill, not a copy from the host: no blocking transfer on the card
    cache: Dict[str, Any] = {"pos": torch.full((), S, dtype=torch.int32,
                                               device=dev)}
    if cfg.family in ("dense", "moe"):
        ck = cv = None
        for l, (wl, is_moe) in enumerate(_schedule(params, cfg)):
            a, (k, v) = self_attention(wl["attn"], cfg, x)
            x = x + a
            x = _moe_res(cfg, x, wl)[0] if is_moe else _mlp_res(cfg, x, wl)
            if ck is None:
                ck, cv = kv_buffers(cfg.n_layers, cache_len, k.shape[2])
            ck[l, :, :S] = k
            cv[l, :, :S] = v
        cache.update(k=ck, v=cv)
    elif cfg.family == "ssm":
        convs, states = [], []
        for i in range(cfg.n_layers):
            o, (conv, state) = mamba_forward(_layer(params["layers"], i),
                                             cfg, x)
            x = x + o
            convs.append(conv)
            states.append(state)
        cache["ssm"] = {"conv": torch.stack(convs),
                        "state": torch.stack(states)}
    elif cfg.family == "hybrid":
        _, _, n_r, n_a = hybrid_counts(cfg)
        W = _ring_len(cfg, cache_len)
        ck = cv = None
        convs, hs = [], []
        for kind, i in _hybrid_schedule(cfg):
            if kind == "R":
                wl = _layer(params["r_layers"], i)
                t, (conv, h_last) = rglru_forward(wl["temporal"], cfg, x)
                x = _mlp_res(cfg, x + t, wl)
                convs.append(conv)
                hs.append(h_last)
            else:
                wl = _layer(params["a_layers"], i)
                a, (k, v) = self_attention(wl["attn"], cfg, x,
                                           window=cfg.local_window)
                x = _mlp_res(cfg, x + a, wl)
                if ck is None:
                    ck, cv = kv_buffers(n_a, W, k.shape[2])
                if cfg.local_window and S >= W:
                    ck[i] = _ring_from_prefill(k, W, S)
                    cv[i] = _ring_from_prefill(v, W, S)
                else:
                    ck[i, :, :S] = k
                    cv[i, :, :S] = v
        if ck is None:
            ck, cv = kv_buffers(n_a, W)
        cache.update(k=ck, v=cv, rg={"conv": torch.stack(convs),
                                     "h": torch.stack(hs)})
    elif cfg.family == "vlm":
        mem = batch["vis_emb"]
        every = cfg.cross_attn_every
        nb = cfg.n_layers // every
        ck = cv = None
        xks, xvs = [], []
        for bi in range(nb):
            wx = _layer(params["x_layers"], bi)
            xk, xv = _precompute_cross_kv(wx["xattn"], cfg, mem)
            xks.append(xk)
            xvs.append(xv)
            x = _xattn_body(cfg, x, wx, mem)
            for si in range(every - 1):
                ws = _layer(params["self_layers"], bi, si)
                a, (k, v) = self_attention(ws["attn"], cfg, x)
                x = _mlp_res(cfg, x + a, ws)
                if ck is None:
                    ck, cv = kv_buffers(nb * (every - 1), cache_len,
                                        k.shape[2])
                ck[bi * (every - 1) + si, :, :S] = k
                cv[bi * (every - 1) + si, :, :S] = v
        if ck is None:
            ck, cv = kv_buffers(nb * (every - 1), cache_len)
        cache.update(k=ck, v=cv, xk=torch.stack(xks), xv=torch.stack(xvs))
    elif cfg.family == "encdec":
        mem = _encode(params, cfg, batch["enc_emb"], remat=False)
        ck = cv = None
        xks, xvs = [], []
        for i in range(cfg.n_layers):
            wl = _layer(params["dec_layers"], i)
            a, (k, v) = self_attention(wl["attn"], cfg, x)
            if ck is None:
                ck, cv = kv_buffers(cfg.n_layers, cache_len, k.shape[2])
            x = x + a
            xk, xv = _precompute_cross_kv(wl["xattn"], cfg, mem)
            x = x + cross_attention(wl["xattn"], cfg, x, mem)
            x = _mlp_res(cfg, x, wl)
            ck[i, :, :S] = k
            cv[i, :, :S] = v
            xks.append(xk)
            xvs.append(xv)
        cache.update(k=ck, v=cv, xk=torch.stack(xks), xv=torch.stack(xvs))
    else:
        raise ValueError(cfg.family)
    h = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return h[:, -1:, :], cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache: dict):
    """token: (B,1) int32 -> (hidden (B,1,D), cache with pos + 1).  The
    cache's ``pos`` is a 0-d int32 tensor, or (dense and MoE) a (B,)
    vector of per-row positions (continuous batching).  The new K/V and
    recurrent states are written into the given cache's tensors in
    place."""
    pos = cache["pos"]
    x = _embed(params, cfg, token)
    if cfg.family in ("dense", "moe"):
        for l, (wl, is_moe) in enumerate(_schedule(params, cfg)):
            a, _, _ = decode_self_attention(wl["attn"], cfg, x,
                                            cache["k"][l], cache["v"][l], pos)
            x = x + a
            x = _moe_res(cfg, x, wl)[0] if is_moe else _mlp_res(cfg, x, wl)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            c = T.map_tree(lambda t: t[i], cache["ssm"])
            x = x + mamba_decode_step(_layer(params["layers"], i), cfg, x,
                                      c)[0]
    elif cfg.family == "hybrid":
        for kind, i in _hybrid_schedule(cfg):
            if kind == "R":
                wl = _layer(params["r_layers"], i)
                c = T.map_tree(lambda t: t[i], cache["rg"])
                t, _ = rglru_decode_step(wl["temporal"], cfg, x, c)
                x = _mlp_res(cfg, x + t, wl)
            else:
                wl = _layer(params["a_layers"], i)
                a, _, _ = decode_self_attention(
                    wl["attn"], cfg, x, cache["k"][i], cache["v"][i], pos,
                    window=cfg.local_window)
                x = _mlp_res(cfg, x + a, wl)
    elif cfg.family == "vlm":
        every = cfg.cross_attn_every
        for bi in range(cfg.n_layers // every):
            wx = _layer(params["x_layers"], bi)
            x = x + _cross_cached(wx["xattn"], cfg, x, cache["xk"][bi],
                                  cache["xv"][bi])
            x = _gated_mlp_res(cfg, x, wx)
            for si in range(every - 1):
                ws = _layer(params["self_layers"], bi, si)
                l = bi * (every - 1) + si
                a, _, _ = decode_self_attention(ws["attn"], cfg, x,
                                                cache["k"][l], cache["v"][l],
                                                pos)
                x = _mlp_res(cfg, x + a, ws)
    elif cfg.family == "encdec":
        for i in range(cfg.n_layers):
            wl = _layer(params["dec_layers"], i)
            a, _, _ = decode_self_attention(wl["attn"], cfg, x,
                                            cache["k"][i], cache["v"][i], pos)
            x = x + a
            x = x + _cross_cached(wl["xattn"], cfg, x, cache["xk"][i],
                                  cache["xv"][i])
            x = _mlp_res(cfg, x, wl)
    else:
        raise ValueError(cfg.family)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return rms_norm(x, params["final_ln"], cfg.norm_eps), new_cache
