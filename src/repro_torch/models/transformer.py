"""The dense transformer (port of the dense family of
`repro.models.transformer`): `model_specs`, `forward`, `cache_specs`,
`prefill` and `decode_step`.  The reference's `lax.scan` over stacked
layers becomes a Python loop over per-layer views of the stacked leaves;
``params["layers"]`` may also be a list of per-layer trees (the training
step's per-layer leaves, `steps.make_train_step`).  `forward` remats every
layer as the reference's `_scan_layers` does
(`torch.utils.checkpoint`, non-reentrant).

Logits are not produced here; `steps.py` applies the head."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core import tree as T
from .attention import attn_specs, decode_self_attention, self_attention
from .config import ModelConfig
from .nn import embed_specs, mlp_apply, mlp_specs, rms_norm
from .params import Spec

__all__ = ["model_specs", "forward", "cache_specs", "prefill", "decode_step",
           "stack_specs"]


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port has only the dense family (got {cfg.family!r})")


def stack_specs(tree: Any, n: int) -> Any:
    """Prepend a stacked layer dim n to every Spec in the tree."""
    return T.map_tree(lambda s: Spec((n,) + s.shape, (None,) + s.axes,
                                     s.init, s.scale, s.dtype), tree)


def model_specs(cfg: ModelConfig) -> dict:
    _dense_only(cfg)
    d = cfg.d_model
    layer = {"attn": attn_specs(cfg),
             "mlp": {"ln": Spec((d,), ("model_dim",), "zeros"),
                     **mlp_specs(cfg)}}
    return {"embed": embed_specs(cfg),
            "final_ln": Spec((d,), ("model_dim",), "zeros"),
            "layers": stack_specs(layer, cfg.n_layers)}


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """Decode-cache Spec tree (dense: per-layer k/v plus the position)."""
    _dense_only(cfg)
    axes = (None, "batch", "kv_seq", "kv_heads", None)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv, cfg.head_dim)
    return {"pos": Spec((), (), "zeros", dtype="int32"),
            "k": Spec(shape, axes, "zeros"),
            "v": Spec(shape, axes, "zeros")}


def _layer(stacked: Any, i: int) -> Any:
    if isinstance(stacked, (list, tuple)):
        return stacked[i]
    return T.map_tree(lambda w: w[i], stacked)


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # gather, then convert: the same values as the reference's
    # convert-then-gather without converting the whole table
    return params["embed"]["tok"][tokens.long()].to(cfg.cdtype)


def _mlp_res(cfg: ModelConfig, x, wl):
    return x + mlp_apply(wl["mlp"], cfg, rms_norm(x, wl["mlp"]["ln"],
                                                  cfg.norm_eps))


def _dense_body(cfg: ModelConfig, x, wl):
    a, _ = self_attention(wl["attn"], cfg, x)
    return _mlp_res(cfg, x + a, wl)


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Full-sequence forward to the final hidden states: (hidden (B,S,D),
    aux loss (0-d fp32, zero for the dense family)).  With grad enabled
    each layer is rematerialized in the backward, so only the layer inputs
    stay resident."""
    _dense_only(cfg)
    x = _embed(params, cfg, batch["tokens"])
    remat = torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        wl = _layer(params["layers"], i)
        x = (checkpoint(_dense_body, cfg, x, wl, use_reentrant=False)
             if remat else _dense_body(cfg, x, wl))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rms_norm(x, params["final_ln"], cfg.norm_eps), aux


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            cache_len: Optional[int] = None):
    """Run the prompt and build the decode cache: (hidden_last (B,1,D),
    cache {pos, k, v}) with k/v (n_layers, B, cache_len, KV, hd)."""
    _dense_only(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache_len = cache_len or S
    x = _embed(params, cfg, tokens)
    shape = (cfg.n_layers, B, cache_len, cfg.n_kv, cfg.head_dim)
    ck = torch.zeros(shape, dtype=cfg.cdtype, device=x.device)
    cv = torch.zeros(shape, dtype=cfg.cdtype, device=x.device)
    for i in range(cfg.n_layers):
        wl = _layer(params["layers"], i)
        a, (k, v) = self_attention(wl["attn"], cfg, x)
        x = _mlp_res(cfg, x + a, wl)
        ck[i, :, :S] = k
        cv[i, :, :S] = v
    cache = {"pos": torch.tensor(S, dtype=torch.int32, device=x.device),
             "k": ck, "v": cv}
    h = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return h[:, -1:, :], cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache: dict):
    """token: (B,1) int32 -> (hidden (B,1,D), cache with pos + 1).  The
    cache's ``pos`` is a 0-d int32 tensor, or a (B,) vector of per-row
    positions (continuous batching).  The new k/v are written into the
    given cache's tensors in place."""
    _dense_only(cfg)
    pos = cache["pos"]
    x = _embed(params, cfg, token)
    for i in range(cfg.n_layers):
        wl = _layer(params["layers"], i)
        a, _, _ = decode_self_attention(wl["attn"], cfg, x, cache["k"][i],
                                        cache["v"][i], pos)
        x = _mlp_res(cfg, x + a, wl)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return rms_norm(x, params["final_ln"], cfg.norm_eps), new_cache
