"""Train and serve step builders (port of `repro.models.steps`).

The loss is computed in sequence chunks against the head, each chunk
rematerialized in the backward, so (B, S, V) logits are never resident.

The training step updates its state in place.  The reference's
`value_and_grad` over the stacked layer leaves would, through autograd's
select backward, allocate a zero tensor as large as a whole stack for
every layer; instead the step gives the model per-layer leaves that alias
the stacked params' storage (``w[i].detach().requires_grad_()``) and whose
``.grad`` is a view of a stacked grad buffer, so the grads land in place
in the params' own stacked layout (the reference's, which the int8
compression tiles) and AdamW then updates the params, `m` and `v` in
place.  MoE's interleaved ``dense_layers`` stack (pairs, moe_every - 1,
...) gets one such leaf per (pair, j).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core import tree as T
from ..optim import (AdamWConfig, adamw_update, compress_decompress,
                     init_error_state, init_opt_state)
from .config import ModelConfig
from .transformer import STACKED, decode_step, forward, prefill

__all__ = ["head_weights", "chunked_xent", "make_loss_fn", "make_train_step",
           "init_train_state", "make_prefill_step", "make_decode_step"]


def head_weights(params: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["tok"].T            # (D, V)
    return params["embed"]["head"]


def _chunk_nll(h, head, labels, mask):
    logits = (h @ head.to(h.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return ((lse - ll) * mask).sum()


def chunked_xent(hidden: torch.Tensor, head: torch.Tensor,
                 labels: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross entropy over (B, S) in S-chunks; hidden
    (B, S, D), head (D, V).  Each chunk's logits are recomputed in the
    backward instead of kept."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S  # irregular small sequences: single chunk
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=hidden.device)
    remat = torch.is_grad_enabled()
    tot = torch.zeros((), device=hidden.device)
    cnt = torch.zeros((), device=hidden.device)
    for a in range(0, S, chunk):
        h, l, m = (hidden[:, a:a + chunk], labels[:, a:a + chunk],
                   mask[:, a:a + chunk])
        nll = (checkpoint(_chunk_nll, h, head, l, m, use_reentrant=False)
               if remat else _chunk_nll(h, head, l, m))
        tot = tot + nll
        cnt = cnt + m.sum()
    return tot / torch.clamp(cnt, min=1.0)


def make_loss_fn(cfg: ModelConfig):
    """loss_fn(params, batch) -> (total, {loss, aux}).  batch: tokens
    (B, S), the stub modality input `forward` reads (vis_emb for the vlm
    family, enc_emb for encdec), optionally a mask."""
    def loss_fn(params, batch):
        hidden, aux = forward(params, cfg, batch)
        labels = batch["tokens"][:, 1:]
        h = hidden[:, :-1, :]
        mask = batch.get("mask")
        mask = mask[:, 1:] if mask is not None else None
        loss = chunked_xent(h, head_weights(params, cfg), labels, mask)
        total = loss + cfg.router_aux_weight * aux
        return total, {"loss": loss, "aux": aux}

    return loss_fn


def _grad_leaves(params: Any, grads: Any) -> Any:
    """The model's view of `params` for one backward: leaves that alias
    the params' storage and require grad, with ``.grad`` set to views of
    `grads`, so autograd accumulates into `grads` in place.  Every stacked
    layer key (`transformer.STACKED`) becomes a list of per-layer trees,
    a list of lists for the two-level stacks (MoE's ``dense_layers``, the
    VLM's ``self_layers``)."""
    def alias(p, g):
        a = p.detach().requires_grad_()
        a.grad = g
        return a

    def split(stacked, gstacked, depth):
        if depth == 0:
            return T.map_tree(alias, stacked, gstacked)
        n = T.leaves(stacked)[0].shape[0]
        return [split(T.map_tree(lambda w, i=i: w[i], stacked),
                      T.map_tree(lambda w, i=i: w[i], gstacked), depth - 1)
                for i in range(n)]

    return {k: split(v, grads[k], STACKED.get(k, 0))
            for k, v in params.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    grad_compression: bool = False, microbatches: int = 1):
    """train_step(state, batch) -> (state, metrics); `state` =
    {params, opt: {m, v, count}, [err]} is updated in place and returned.

    microbatches > 1 accumulates the grads of K slices of the batch, so
    activation memory scales with B/K, as the reference does with its
    default fp32 `grad_dtype`: each slice's grads are added in fp32 into
    fp32 accumulators, in order, and the sum is divided by K; those are
    the grads AdamW gets.  Each slice's backward lands in grad buffers of
    the params' dtype (zeroed after each slice); where those are fp32,
    they are the accumulators themselves (autograd's in-place fp32 add is
    the reference's), so no second buffer is held.  With K == 1 the grads
    stay in the params' dtype, as in the reference."""
    loss_fn = make_loss_fn(cfg)
    K = microbatches

    def train_step(state, batch):
        params = state["params"]
        grads = T.map_tree(torch.zeros_like, params)
        leaves = _grad_leaves(params, grads)
        if K == 1:
            parts = [batch]
        else:
            B = batch["tokens"].shape[0]
            assert B % K == 0, (B, K)
            n = B // K
            parts = [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                     for i in range(K)]
        in_place = K == 1 or all(g.dtype == torch.float32
                                 for g in T.leaves(grads))
        acc = grads if in_place else T.map_tree(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads)
        lsum = asum = 0
        for part in parts:
            total, metrics = loss_fn(leaves, part)
            total.backward()
            lsum = lsum + total.detach()
            asum = asum + metrics["aux"].detach()
            if not in_place:
                for a, g in zip(T.leaves(acc), T.leaves(grads)):
                    a.add_(g)       # fp32 + the promoted slice grad
                    g.zero_()
        del leaves
        grads = acc
        if K > 1:
            for g in T.leaves(grads):
                g.div_(K)
        # the reference's metrics: one batch's, or the K slices' means
        loss = metrics["loss"].detach() if K == 1 else lsum / K
        if grad_compression:
            compress_decompress(grads, state["err"])
        _, _, opt_metrics = adamw_update(opt_cfg, grads, state["opt"],
                                         params)
        return state, {"total": lsum / K, "loss": loss, "aux": asum / K,
                       **opt_metrics}

    return train_step


def init_train_state(params, grad_compression: bool = False) -> dict:
    state = {"params": params, "opt": init_opt_state(params)}
    if grad_compression:
        state["err"] = init_error_state(params)
    return state


def _logits_last(params, cfg: ModelConfig, hidden: torch.Tensor):
    return (hidden @ head_weights(params, cfg).to(hidden.dtype)).float()


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_prefill_step(cfg: ModelConfig, cache_len: Optional[int] = None):
    """prefill_step(params, batch) -> (next_token (B,1), logits, cache)."""

    def prefill_step(params, batch):
        h_last, cache = prefill(params, cfg, batch, cache_len)
        logits = _logits_last(params, cfg, h_last)
        return _greedy(logits), logits, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """decode_fn(params, token (B,1), cache) -> (next_token, logits, cache)."""

    def decode_fn(params, token, cache):
        h, cache = decode_step(params, cfg, token, cache)
        logits = _logits_last(params, cfg, h)
        return _greedy(logits), logits, cache

    return decode_fn
