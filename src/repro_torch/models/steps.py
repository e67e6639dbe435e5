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
from ..pshard import (ambient_mesh, ambient_rules, local_split,
                      model_columns, use_mesh_and_rules, vocab_greedy)
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
                    grad_compression: bool = False, microbatches: int = 1,
                    param_pspecs=None, grad_dtype=torch.float32):
    """train_step(state, batch) -> (state, metrics); `state` =
    {params, opt: {m, v, count}, [err]} is updated in place and returned.

    microbatches > 1 accumulates the grads of K slices of the batch (slice
    k the rows [k B/K, (k+1) B/K)), so activation memory scales with B/K,
    as the reference does: each slice's grads are added in fp32 to the
    `grad_dtype` accumulator and rounded once to it, in order, and the sum
    is divided by K; those are the grads AdamW gets.  Each slice's
    backward lands in grad buffers of the params' dtype (zeroed after each
    slice); where those and the accumulator are fp32, they are the
    accumulators themselves (autograd's in-place fp32 add is the
    reference's), so no second buffer is held.  With K == 1 there is no
    accumulator: the grads stay in the params' dtype, as in the reference.

    `param_pspecs` (the `params.partition_specs` tree of the params on
    the ambient process mesh, `launch.mesh.Mesh`) makes this the sharded
    step (`launch.shards`): `state` then holds this rank's shards -- the
    params by `param_pspecs`, `m` and `v` by the ZeRO-1 moment specs
    (`launch.specs.train_state` places them) -- and every rank gets the
    whole global batch; slice k's rows are then split over the batch
    axes, as the reference's `resplit` does.  Without an ambient mesh the
    specs are ignored, as the reference's constraints are."""
    loss_fn = make_loss_fn(cfg)
    K = microbatches

    def train_step(state, batch):
        mesh = ambient_mesh()
        if param_pspecs is not None and mesh is not None:
            return _sharded_step(cfg, opt_cfg, loss_fn, K, param_pspecs,
                                 grad_dtype, grad_compression, mesh,
                                 state, batch)
        params = state["params"]
        grads = T.map_tree(torch.zeros_like, params)
        leaves = _grad_leaves(params, grads)
        parts = _slices(batch, K)
        in_place = _in_place(K, grads, grad_dtype)
        acc = grads if in_place else T.map_tree(
            lambda g: torch.zeros(g.shape, dtype=grad_dtype,
                                  device=g.device), grads)
        lsum = asum = 0
        for part in parts:
            total, metrics = loss_fn(leaves, part)
            total.backward()
            lsum = lsum + total.detach()
            asum = asum + metrics["aux"].detach()
            if not in_place:
                _accumulate(acc, grads)
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


def _slices(batch: dict, K: int) -> list:
    """The K micro-slices of a batch: slice k is rows [k B/K, (k+1) B/K)."""
    if K == 1:
        return [batch]
    B = batch["tokens"].shape[0]
    assert B % K == 0, (B, K)
    n = B // K
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            for i in range(K)]


def _in_place(K: int, grads: Any, grad_dtype) -> bool:
    """Whether the backward's grad buffers are the accumulators: one
    slice, or fp32 grads into an fp32 accumulator."""
    return K == 1 or (grad_dtype == torch.float32 and all(
        g.dtype == torch.float32 for g in T.leaves(grads)))


def _accumulate(acc: Any, grads: Any) -> None:
    """acc := round_to_acc_dtype(acc + grads) in fp32; grads := 0."""
    for a, g in zip(T.leaves(acc), T.leaves(grads)):
        if a.dtype == torch.float32:
            a.add_(g)           # fp32 + the promoted slice grad
        else:
            a.copy_(a.float().add_(g))
        g.zero_()


def _sharded_step(cfg, opt_cfg, loss_fn, K, param_pspecs, grad_dtype,
                  grad_compression, mesh, state, batch):
    """One step of this rank of a process mesh (`make_train_step`'s
    `param_pspecs`; `launch.shards` for the plan, the gathers and the
    exchanges).

    Slice k's rows are split over the batch axes (every row on every rank
    where they do not divide); each rank's loss on its rows is weighted by
    its share of the slice's counted tokens (the mask's, else its rows),
    so the grads summed over the batch axes are the slice's mean loss's,
    and the MoE load-balance statistics are summed over the batch axes
    inside the forward (`pshard.ambient_batch_sum`), so its aux loss is
    the slice's, on every rank."""
    from ..launch.placement import row_split
    from ..launch.shards import model_view, plan_for
    if grad_compression:
        raise ValueError("make_train_step: the int8 grad compression is "
                         "not sharded (param_pspecs on a mesh)")
    rules = ambient_rules()
    plan = plan_for(cfg, mesh, rules)
    if T.leaves(plan.pspecs) != [tuple(s) for s in T.leaves(param_pspecs)]:
        raise ValueError("param_pspecs are not the params' partition specs "
                         "on the ambient mesh and rules")
    params = state["params"]
    grads = T.map_tree(torch.zeros_like, params)
    in_place = _in_place(K, grads, grad_dtype)
    acc = grads if in_place else T.map_tree(
        lambda g: torch.zeros(g.shape, dtype=grad_dtype, device=g.device),
        grads)
    B = batch["tokens"].shape[0]
    assert B % K == 0, (B, K)
    rows, axes, pieces = row_split(B // K, mesh, rules)
    view = model_view(params, grads, plan, axes, cfg.cdtype)
    bsum = plan.batch_sum(axes)
    lpart = asum = 0
    for part in _slices(batch, K):
        mine = {k: v[rows] for k, v in part.items()}
        w = _share(part, mine, pieces)
        with use_mesh_and_rules(mesh, rules, batch_shards=pieces,
                                batch_sum=bsum):
            _, metrics = loss_fn(view, mine)
            obj = w * metrics["loss"] + cfg.router_aux_weight * metrics["aux"]
            obj.backward()
        lpart = lpart + w * metrics["loss"].detach()
        asum = asum + metrics["aux"].detach()
        if not in_place:
            _accumulate(acc, grads)
    del view
    if K > 1:
        for g in T.leaves(acc):
            g.div_(K)
    # the slices' losses over the batch axes (group order), on every rank
    lsum = plan.exchange.sum(lpart, axes) if pieces > 1 else lpart
    total = lsum + cfg.router_aux_weight * asum
    loss = lsum if K == 1 else total / K
    _, _, opt_metrics = adamw_update(opt_cfg, acc, state["opt"], params,
                                     plan=plan)
    return state, {"total": total / K, "loss": loss, "aux": asum / K,
                   **opt_metrics}


def _share(part: dict, mine: dict, pieces: int):
    """This rank's weight in its slice's mean loss: its counted tokens
    (the mask's after the first position) over the slice's, or 1/pieces
    without a mask (every row counts alike)."""
    if pieces == 1:
        return 1.0
    mask = part.get("mask")
    if mask is None:
        return 1.0 / pieces
    return (mine["mask"][:, 1:].float().sum()
            / torch.clamp(mask[:, 1:].float().sum(), min=1.0))


def init_train_state(params, grad_compression: bool = False) -> dict:
    state = {"params": params, "opt": init_opt_state(params)}
    if grad_compression:
        state["err"] = init_error_state(params)
    return state


def _logits_last(params, cfg: ModelConfig, hidden: torch.Tensor):
    """(fp32 logits of `hidden`, the axes their columns are split over):
    this rank's ``vocab`` columns where a serving store keeps the head's
    slice local (a column-parallel head), else every column and ()."""
    head = head_weights(params, cfg)
    axes = local_split(head, (cfg.d_model, cfg.padded_vocab),
                       ("model_dim", "vocab"), 1)[0]
    return (hidden @ head.to(hidden.dtype)).float(), axes


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_prefill_step(cfg: ModelConfig, cache_len: Optional[int] = None):
    """prefill_step(params, batch) -> (next_token (B,1), logits, cache);
    a column-parallel head's logits are gathered whole."""

    def prefill_step(params, batch):
        h_last, cache = prefill(params, cfg, batch, cache_len)
        logits = model_columns(*_logits_last(params, cfg, h_last))
        return _greedy(logits), logits, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, logits: bool = True):
    """decode_fn(params, token (B,1), cache) -> (next_token, logits,
    cache).  Without `logits` the logits are None, and a column-parallel
    head's token is picked from every rank's columns
    (`pshard.vocab_greedy`) without building the whole row."""

    def decode_fn(params, token, cache):
        h, cache = decode_step(params, cfg, token, cache)
        part, axes = _logits_last(params, cfg, h)
        if not logits:
            return vocab_greedy(part, axes), None, cache
        whole = model_columns(part, axes)
        return _greedy(whole), whole, cache

    return decode_fn
