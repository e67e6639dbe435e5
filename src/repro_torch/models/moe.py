"""Mixture-of-Experts layer (port of `repro.models.moe`): token-choice
top-k routing with sort-based capacity dispatch.

The reference splits the tokens into G data-parallel groups, G being the
mesh's batch shard count (`_dp_groups`), so that every sort and scatter is
local to a group; without a mesh G is 1.  The port runs one process per
mesh position: where the engine has already split the batch over the
ranks, a process's tokens are one group of the reference's (G local = 1),
and where it has not (a batch that does not divide), the process splits
its tokens into the reference's G groups itself.

Supports llama4-style (128 experts, top-1, a shared expert, interleaved)
and phi3.5-moe-style (16 experts, top-2) from the same code path.  The
expert FFN is two plain batched products, as in the reference (which
computes them outside any Pallas kernel).

Where the layer gets this rank's experts alone (a serving store keeps the
``expert`` axis local, `launch.placement`), the FFN runs where they live:
the reference constrains the (G, E, C, D) dispatch buffer to ("batch",
"expert", ...) so GSPMD computes each expert on its owner; here every
rank's buffers are gathered over the expert axes, each rank computes its
experts' rows of every group and the rows go back (`_expert_parallel`).
Routing, dispatch and the combine stay per token group, and the combine
adds at most top-k contributions onto zero, so it stays exact.  Where
the experts' ``w_up`` / ``w_down`` also hold this rank's slice of ``ff``
(a serving store's rules put ``ff`` on ``model``), each rank's experts
are column-parallel, then row-parallel, each expert's gated halves
re-aligned and the partial outputs summed in rank order over the ``ff``
axes (`_down`) before they go back; the shared expert is the dense
MLP's (`nn.mlp_apply`).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..pshard import (ambient_batch_shards, ambient_batch_sum,
                      ambient_mesh, ambient_rules, local_split, model_sum,
                      spec_axes, spec_for)
from .config import ModelConfig
from .nn import ff_columns, gelu, mlp_apply, mlp_specs
from .params import Spec

__all__ = ["moe_specs", "moe_apply", "route", "dispatch"]


def _dp_groups(n_tokens: int) -> int:
    """Token groups in this process's `n_tokens` tokens: the reference's
    group count over the ambient mesh's batch axes (halved until it
    divides the whole batch's tokens; 1 without a mesh), divided by the
    batch pieces the processes hold (`pshard.ambient_batch_shards`)."""
    mesh = ambient_mesh()
    if mesh is None:
        return 1
    shards = ambient_batch_shards()
    total = n_tokens * shards
    g = 1
    for ax in ambient_rules().axes_for("batch"):
        if ax in mesh.axis_names:
            g *= mesh.shape[ax]
    while g > 1 and total % g:
        g //= 2
    return max(g // shards, 1)


def moe_specs(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.moe_experts, cfg.moe_dff or cfg.d_ff
    gated = cfg.act in ("swiglu", "geglu")
    specs = {
        "router": Spec((d, e), ("model_dim", None), "scaled"),
        "w_up": Spec((e, d, 2 * f if gated else f),
                     ("expert", "model_dim", "ff"), "scaled"),
        "w_down": Spec((e, f, d), ("expert", "ff", "model_dim"), "scaled"),
    }
    if cfg.moe_shared_expert:
        specs["shared"] = mlp_specs(cfg)
    return specs


def _capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Slots per expert: capacity_factor x top-k x tokens / experts,
    rounded up to a multiple of 8, at least 8."""
    c = int(math.ceil(cfg.capacity_factor * cfg.moe_topk * tokens_per_group
                      / cfg.moe_experts))
    return max(8, -(-c // 8) * 8)


def route(cfg: ModelConfig, probs: torch.Tensor):
    """Top-k of the router probabilities (G, Tl, E) in fp32: (gate values
    renormalized to sum to 1, expert ids), each (G, Tl, K)."""
    gate_vals, expert_idx = torch.topk(probs, cfg.moe_topk, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return gate_vals, expert_idx


def dispatch(expert_idx: torch.Tensor, n_experts: int, capacity: int):
    """Sort-based capacity dispatch of token-major expert ids (G, Tl, K):
    (order, sorted_tok, dest, keep), each (G, Tl*K).  `order` is the
    stable argsort of the ids (an unstable sort would drop other tokens
    at capacity), `sorted_tok` the token of each sorted assignment,
    `dest` its row in the (E*C + 1)-row buffer (row E*C is the pad row
    that dropped assignments go to) and `keep` whether it fits."""
    G, Tl, K = expert_idx.shape
    E, C = n_experts, capacity
    flat_e = expert_idx.reshape(G, Tl * K)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    sorted_tok = order // K
    # exclusive-cumsum expert counts -> each expert's first sorted slot
    cnt = F.one_hot(flat_e, E).sum(dim=1)                          # (G,E)
    starts = torch.cumsum(cnt, dim=1) - cnt
    pos = (torch.arange(Tl * K, device=flat_e.device)[None, :]
           - torch.gather(starts, 1, sorted_e))
    keep = pos < C
    dest = torch.where(keep, sorted_e * C + pos,
                       torch.full_like(pos, E * C))
    return order, sorted_tok, dest, keep


def _activate(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """The expert FFN's activation of the up projection (E', ..., F), or
    of this rank's slice of each gated half."""
    if cfg.act in ("swiglu", "geglu"):
        act = F.silu if cfg.act == "swiglu" else gelu
        f = h.shape[-1] // 2
        return h[..., :f] * act(h[..., f:])
    # the reference's ungated expert: relu2, else silu
    return F.relu(h) ** 2 if cfg.act == "relu2" else F.silu(h)


def _up(cfg: ModelConfig, x: torch.Tensor, w_up: torch.Tensor):
    """The activated up projection of dispatch buffers x (G, E', C, D)
    and the axes the down projection's partial products are summed over:
    where ``w_up`` holds this rank's slice of the ``ff`` columns, each
    expert's gated halves are re-aligned (`nn.ff_columns`)."""
    E, f = cfg.moe_experts, cfg.moe_dff or cfg.d_ff
    gated = cfg.act in ("swiglu", "geglu")
    up = local_split(w_up, (E, cfg.d_model, 2 * f if gated else f),
                     ("expert", "model_dim", "ff"), 2)
    h, down = ff_columns(torch.einsum("gecd,edf->gecf", x, w_up), up,
                         (E, f, cfg.d_model), ("expert", "ff", "model_dim"),
                         1, 2 if gated else 1)
    return _activate(cfg, h), down


def _down(h: torch.Tensor, w_down: torch.Tensor, down) -> torch.Tensor:
    """The down projection of activated (G, E', C, F') rows in h's dtype;
    where ``w_down`` holds this rank's ``ff`` rows (`down`, their axes),
    the ranks' partials added in rank order in fp32, rounded once
    (`pshard.model_sum`)."""
    return model_sum(torch.einsum("gecf,efd->gecd", h, w_down.to(h.dtype)),
                     down)


def _ffn(cfg: ModelConfig, x: torch.Tensor, w_up: torch.Tensor,
         w_down: torch.Tensor) -> torch.Tensor:
    """Two batched products of dispatch buffers x (G, E', C, D) under E'
    experts' weights in x's dtype (row-parallel, then the ordered sum,
    where the weights hold this rank's ``ff`` slice)."""
    h, down = _up(cfg, x, w_up.to(x.dtype))
    return _down(h, w_down, down)


def _experts(cfg: ModelConfig, expert_in: torch.Tensor, p) -> torch.Tensor:
    """The expert FFN of dispatch buffers (G, E, C, D) under p's ``w_up``
    and ``w_down``, each read once and in turn (a leaf gathered when read
    is dropped before the next is read).  Where ``w_up`` holds E / n of
    the experts, they are computed where they live
    (`_expert_parallel`)."""
    dt = expert_in.dtype
    w_up = p["w_up"].to(dt)
    if w_up.shape[0] != cfg.moe_experts:
        return _expert_parallel(cfg, expert_in, w_up, p["w_down"])
    h, down = _up(cfg, expert_in, w_up)
    del w_up
    return _down(h, p["w_down"], down)


def _expert_parallel(cfg: ModelConfig, expert_in: torch.Tensor,
                     w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The expert FFN where the experts live: `w_up` (in the compute
    dtype) and `w_down` (as stored) hold this rank's E / n experts (its
    slice along the ``expert`` axes of the
    ambient mesh, n ranks).  Every rank's dispatch buffers are gathered
    over those axes (an exact all-gather, `launch.shards.Exchange`); the
    rank runs its experts on every group's rows for them (n G rows of C
    slots an expert, in the ranks' order) and the outputs are gathered
    back, each rank keeping its own groups' rows of every expert.  Returns
    (G, E, C, D) as `_experts` does."""
    from ..launch.shards import exchange_for
    mesh, E = ambient_mesh(), cfg.moe_experts
    axes = spec_axes(spec_for((E,), ("expert",), mesh, ambient_rules())[0])
    n, El = mesh.group_size(axes), w_up.shape[0]
    if n * El != E:
        raise ValueError(f"{El} local experts on an expert group of {n} "
                         f"ranks: the layer has {E}")
    k, G = mesh.index_in(axes), expert_in.shape[0]
    ex = exchange_for(mesh)
    rows = torch.cat([x[:, k * El:(k + 1) * El]
                      for _, x in ex.parts(expert_in, axes)])
    out = _ffn(cfg, rows, w_up, w_down)                     # (n G, El, C, D)
    return torch.cat([y[k * G:(k + 1) * G]
                      for _, y in ex.parts(out, axes)], dim=1)


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
              experts=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (output (B, S, D), the Switch load-balance aux loss,
    a 0-d fp32).  `experts`, when given, stands for the expert FFN: a
    function of the dispatch buffers (G, E, C, D) to the experts' outputs
    of the same shape (a check that applies the experts shard by
    shard)."""
    B, S, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_topk
    T = B * S
    dt = x.dtype
    G = _dp_groups(T)
    Tl = T // G
    C = _capacity(cfg, Tl)
    xg = x.reshape(G, Tl, D)

    # --- routing (fp32) ----------------------------------------------------
    logits = xg.float() @ p["router"].float()                      # (G,Tl,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = route(cfg, probs)                      # (G,Tl,K)

    # load-balance auxiliary loss (Switch-style, over all tokens)
    bsum = ambient_batch_sum()
    if bsum is None:
        me = probs.mean(dim=(0, 1))                                # (E,)
        ce = F.one_hot(expert_idx, E).sum(dim=(0, 1, 2)).float() / (T * K)
    else:
        # the training step's batch is split over the processes: the
        # statistics are the whole batch's, as the reference's are
        Tg = T * ambient_batch_shards()
        stats = bsum(torch.cat([probs.sum(dim=(0, 1)),
                                F.one_hot(expert_idx, E)
                                .sum(dim=(0, 1, 2)).float()]))
        me, ce = stats[:E] / Tg, stats[E:] / (Tg * K)
    aux = E * torch.sum(me * ce)

    # --- sort-based capacity dispatch ---------------------------------------
    order, sorted_tok, dest, keep = dispatch(expert_idx, E, C)
    flat_g = gate_vals.reshape(G, Tl * K)
    src = torch.gather(xg, 1, sorted_tok[..., None].expand(-1, -1, D)).to(dt)
    # dropped rows all land on the pad row E*C, which is sliced off
    buf = torch.stack([
        torch.zeros((E * C + 1, D), dtype=dt, device=x.device)
        .index_copy(0, dest[g], src[g]) for g in range(G)])
    expert_in = buf[:, :E * C].reshape(G, E, C, D)

    # --- expert FFN: here, or where the experts live ---------------------------
    expert_out = experts(expert_in) if experts is not None \
        else _experts(cfg, expert_in, p)

    # --- combine, in the compute dtype ---------------------------------------
    rows = expert_out.reshape(G, E * C, D)
    safe = torch.where(keep, dest, torch.zeros_like(dest))
    gathered = torch.gather(rows, 1, safe[..., None].expand(-1, -1, D))
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros_like(gathered)).to(dt)
    wsorted = torch.gather(flat_g, 1, order)
    contrib = gathered * wsorted[..., None].to(dt)
    # a token receives at most top-k <= 2 contributions, added onto zero:
    # 0 + a + b == 0 + b + a bit for bit, so the order index_add_ takes
    # (atomics on the card) cannot change a bit
    y = torch.stack([
        torch.zeros((Tl, D), dtype=dt, device=x.device)
        .index_add(0, sorted_tok[g], contrib[g]) for g in range(G)])

    if cfg.moe_shared_expert:
        y = y + mlp_apply(p["shared"], cfg, xg)
    return y.reshape(B, S, D), aux
