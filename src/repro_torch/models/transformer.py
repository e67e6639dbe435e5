"""The dense and MoE transformers (port of those families of
`repro.models.transformer`): `model_specs`, `forward`, `cache_specs`,
`prefill` and `decode_step`.

  dense : L x [self-attn, MLP]
  moe   : L x [self-attn, MoE (+ optional shared expert)]; with
          ``moe_every`` > 1, each MoE layer follows ``moe_every - 1``
          dense layers (``dense_layers`` stacked (n_moe, moe_every - 1,
          ...)), the Llama-4 interleave

The reference's `lax.scan` over stacked layers becomes a Python loop over
per-layer views of the stacked leaves; ``params["layers"]`` may also be a
list of per-layer trees, and ``params["dense_layers"]`` a list of lists
(the training step's per-layer leaves, `steps.make_train_step`).
`forward` remats every layer as the reference's `_scan_layers` does
(`torch.utils.checkpoint`, non-reentrant).  Every other family raises.

Logits are not produced here; `steps.py` applies the head."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core import tree as T
from .attention import attn_specs, decode_self_attention, self_attention
from .config import ModelConfig
from .moe import moe_apply, moe_specs
from .nn import embed_specs, mlp_apply, mlp_specs, rms_norm
from .params import Spec

__all__ = ["model_specs", "forward", "cache_specs", "prefill", "decode_step",
           "stack_specs"]

#: the families the port has a model for
_FAMILIES = ("dense", "moe")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"the port has the {' and '.join(_FAMILIES)} families only "
            f"(got {cfg.family!r})")


def stack_specs(tree: Any, n: int, extra_axes: Tuple[int, ...] = ()) -> Any:
    """Prepend stacked layer dims (n, *extra_axes) to every Spec in the
    tree."""
    dims = (n,) + tuple(extra_axes)
    return T.map_tree(lambda s: Spec(dims + s.shape,
                                     (None,) * len(dims) + s.axes,
                                     s.init, s.scale, s.dtype), tree)


def _dense_layer_specs(cfg: ModelConfig) -> dict:
    return {"attn": attn_specs(cfg),
            "mlp": {"ln": Spec((cfg.d_model,), ("model_dim",), "zeros"),
                    **mlp_specs(cfg)}}


def _moe_layer_specs(cfg: ModelConfig) -> dict:
    return {"attn": attn_specs(cfg),
            "moe": {"ln": Spec((cfg.d_model,), ("model_dim",), "zeros"),
                    **moe_specs(cfg)}}


def model_specs(cfg: ModelConfig) -> dict:
    _check_family(cfg)
    d = cfg.d_model
    specs: Dict[str, Any] = {"embed": embed_specs(cfg),
                             "final_ln": Spec((d,), ("model_dim",), "zeros")}
    if cfg.family == "dense":
        specs["layers"] = stack_specs(_dense_layer_specs(cfg), cfg.n_layers)
    else:
        n_moe = cfg.n_layers // cfg.moe_every
        specs["layers"] = stack_specs(_moe_layer_specs(cfg), n_moe)
        if cfg.moe_every > 1:   # interleaved: (moe_every-1) dense per MoE
            specs["dense_layers"] = stack_specs(_dense_layer_specs(cfg),
                                                n_moe, (cfg.moe_every - 1,))
    return specs


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """Decode-cache Spec tree: per-layer k/v over all `n_layers` (dense
    and MoE alike) plus the position."""
    _check_family(cfg)
    axes = (None, "batch", "kv_seq", "kv_heads", None)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv, cfg.head_dim)
    return {"pos": Spec((), (), "zeros", dtype="int32"),
            "k": Spec(shape, axes, "zeros"),
            "v": Spec(shape, axes, "zeros")}


def _layer(stacked: Any, i: int, j: Optional[int] = None) -> Any:
    """Layer i (or (i, j) of a (pairs, moe_every - 1) stack): a view of
    the stacked leaves, or the entry of a list of per-layer trees."""
    if isinstance(stacked, (list, tuple)):
        return stacked[i] if j is None else stacked[i][j]
    if j is None:
        return T.map_tree(lambda w: w[i], stacked)
    return T.map_tree(lambda w: w[i, j], stacked)


def _schedule(params, cfg: ModelConfig) -> List[Tuple[Any, bool]]:
    """(layer weights, is_moe) in execution order; entry l writes cache
    layer l.  MoE with ``moe_every`` > 1 runs pair i as dense layers
    (i, 0 .. moe_every - 2) then MoE layer i."""
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


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # gather, then convert: the same values as the reference's
    # convert-then-gather without converting the whole table
    return params["embed"]["tok"][tokens.long()].to(cfg.cdtype)


def _mlp_res(cfg: ModelConfig, x, wl):
    return x + mlp_apply(wl["mlp"], cfg, rms_norm(x, wl["mlp"]["ln"],
                                                  cfg.norm_eps))


def _moe_res(cfg: ModelConfig, x, wl):
    mo, aux = moe_apply(wl["moe"], cfg, rms_norm(x, wl["moe"]["ln"],
                                                 cfg.norm_eps))
    return x + mo, aux


def _dense_body(cfg: ModelConfig, x, wl):
    a, _ = self_attention(wl["attn"], cfg, x)
    return _mlp_res(cfg, x + a, wl)


def _moe_body(cfg: ModelConfig, x, wl):
    a, _ = self_attention(wl["attn"], cfg, x)
    return _moe_res(cfg, x + a, wl)


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Full-sequence forward to the final hidden states: (hidden (B,S,D),
    aux loss (0-d fp32: the mean over MoE layers of the router's
    load-balance loss, zero for the dense family)).  With grad enabled
    each layer is rematerialized in the backward, so only the layer inputs
    stay resident."""
    _check_family(cfg)
    x = _embed(params, cfg, batch["tokens"])
    remat = torch.is_grad_enabled()
    auxs = []
    for wl, is_moe in _schedule(params, cfg):
        body = _moe_body if is_moe else _dense_body
        out = (checkpoint(body, cfg, x, wl, use_reentrant=False)
               if remat else body(cfg, x, wl))
        if is_moe:
            x, aux = out
            auxs.append(aux)
        else:
            x = out
    aux = (torch.stack(auxs).mean() if auxs else
           torch.zeros((), dtype=torch.float32, device=x.device))
    return rms_norm(x, params["final_ln"], cfg.norm_eps), aux


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            cache_len: Optional[int] = None):
    """Run the prompt and build the decode cache: (hidden_last (B,1,D),
    cache {pos, k, v}) with k/v (n_layers, B, cache_len, KV, hd), cache
    layer l written by the l-th layer run (interleaved MoE: the
    reference's (n_pairs, moe_every) -> n_layers order)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache_len = cache_len or S
    x = _embed(params, cfg, tokens)
    shape = (cfg.n_layers, B, cache_len, cfg.n_kv, cfg.head_dim)
    ck = torch.zeros(shape, dtype=cfg.cdtype, device=x.device)
    cv = torch.zeros(shape, dtype=cfg.cdtype, device=x.device)
    for l, (wl, is_moe) in enumerate(_schedule(params, cfg)):
        a, (k, v) = self_attention(wl["attn"], cfg, x)
        x = x + a
        x = _moe_res(cfg, x, wl)[0] if is_moe else _mlp_res(cfg, x, wl)
        ck[l, :, :S] = k
        cv[l, :, :S] = v
    cache = {"pos": torch.tensor(S, dtype=torch.int32, device=x.device),
             "k": ck, "v": cv}
    h = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return h[:, -1:, :], cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache: dict):
    """token: (B,1) int32 -> (hidden (B,1,D), cache with pos + 1).  The
    cache's ``pos`` is a 0-d int32 tensor, or a (B,) vector of per-row
    positions (continuous batching).  The new k/v are written into the
    given cache's tensors in place."""
    _check_family(cfg)
    pos = cache["pos"]
    x = _embed(params, cfg, token)
    for l, (wl, is_moe) in enumerate(_schedule(params, cfg)):
        a, _, _ = decode_self_attention(wl["attn"], cfg, x, cache["k"][l],
                                        cache["v"][l], pos)
        x = x + a
        x = _moe_res(cfg, x, wl)[0] if is_moe else _mlp_res(cfg, x, wl)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return rms_norm(x, params["final_ln"], cfg.norm_eps), new_cache
