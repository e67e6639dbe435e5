"""AdamW with global-norm clipping and a warmup + cosine schedule (port of
`repro.optim.adamw`).

The reference returns new params and moments; here `adamw_update`
updates the params, `m`, `v`, the clipped grads and the step count in
place, in the reference's arithmetic order.  Each leaf is walked in
chunks of `CHUNK` elements, so the update's temporaries are a few
chunk-sized fp32 buffers, never a leaf-sized one (phi3-mini's stacked
`w_up` is 6.44 GB a copy).

On a process mesh (``plan``, a `launch.shards.ShardPlan`) the params and
grads are this rank's shards by the params specs and `m` / `v` its
slices by the ZeRO-1 moment specs: the norm counts every element once
over the mesh, each rank updates the elements of its moments slice, and
the params are rejoined to their own spec (`ShardPlan.rejoin`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Union

import torch

from ..core import tree as T

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "warmup_cosine",
           "global_norm"]

#: elements of a leaf updated together (64 MB of fp32 temporaries each)
CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def warmup_cosine(cfg: AdamWConfig,
                  step: Union[int, torch.Tensor]) -> torch.Tensor:
    """The learning rate at `step` (fp32, on the step's device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Any, dtype=torch.float32) -> dict:
    """Zero moments shaped like the params, and a 0-d int32 step count on
    the params' device."""
    leaves = T.leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)
    return {"m": T.map_tree(zeros, params),
            "v": T.map_tree(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _flat(x: torch.Tensor) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError("adamw: leaves must be contiguous to be updated "
                         "in place")
    return x.view(-1)


def global_norm(tree: Any, plan=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 dot with itself
    (a leaf's dot summed over its `CHUNK`-element chunks); with a
    `ShardPlan`, of this rank's shards, each element counted once over
    the mesh.  A 0-d fp32 tensor on the leaves' device (no host sync)."""
    leaves = T.leaves(tree)
    if plan is not None:
        return torch.sqrt(plan.norm_sq(leaves, leaf_sq))
    return torch.sqrt(sum_in_order([leaf_sq(x) for x in leaves]))


def leaf_sq(x: torch.Tensor) -> torch.Tensor:
    """A leaf's fp32 dot with itself, summed over its `CHUNK`-element
    chunks in order (0-d, on its device)."""
    f = x.reshape(-1)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in range(0, f.numel(), CHUNK):
        c = f[a:a + CHUNK].float()
        total = total + torch.dot(c, c)
    return total


def sum_in_order(terms) -> torch.Tensor:
    """0 + t0 + t1 + ..., one add at a time (fp32, 0-d)."""
    total = torch.zeros((), dtype=torch.float32,
                        device=terms[0].device if len(terms) else None)
    for t in terms:
        total = total + t
    return total


def adamw_update(cfg: AdamWConfig, grads: Any, opt_state: dict, params: Any,
                 plan=None):
    """One AdamW step, in place: the grads are clipped, `m`, `v`, the
    params and ``opt_state["count"]`` updated.  Returns (params,
    opt_state, metrics {grad_norm, lr}), the same trees it was given.
    `plan` (a `launch.shards.ShardPlan`): the trees are this rank's
    shards (module doc)."""
    count = opt_state["count"]
    count.add_(1)
    lr = warmup_cosine(cfg, count)
    gnorm = global_norm(grads, plan)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    c = count.to(torch.float32)
    mh = 1.0 - torch.pow(b1, c)
    vh = 1.0 - torch.pow(b2, c)
    for i, (p, g, m, v) in enumerate(zip(T.leaves(params), T.leaves(grads),
                                         T.leaves(opt_state["m"]),
                                         T.leaves(opt_state["v"]))):
        if plan is None:
            _update_leaf(cfg, lr, scale, mh, vh, p, g, m, v)
            continue
        # this rank's moments slice of the params and grads (views where
        # it lies in the params slice), updated, then rejoined
        pm = plan.moment_part(i, p)
        _update_leaf(cfg, lr, scale, mh, vh, pm, plan.moment_part(i, g),
                     m, v)
        plan.rejoin(i, p, pm)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


def _update_leaf(cfg, lr, scale, mh, vh, p, g, m, v) -> None:
    """The update of one leaf (or of one moments slice of it), chunk by
    chunk; a strided slice is updated in a contiguous copy."""
    pc, gc = p.contiguous(), g.contiguous()
    fp, fg, fm, fv = _flat(pc), _flat(gc), _flat(m), _flat(v)
    for a in range(0, fp.numel(), CHUNK):
        _update_chunk(cfg, lr, scale, mh, vh, fp[a:a + CHUNK],
                      fg[a:a + CHUNK], fm[a:a + CHUNK], fv[a:a + CHUNK])
    if pc.data_ptr() != p.data_ptr():
        p.copy_(pc)
    if gc.data_ptr() != g.data_ptr():
        g.copy_(gc)


def _update_chunk(cfg, lr, scale, mh, vh, p, g, m, v) -> None:
    """The reference's per-leaf arithmetic over one chunk, in place."""
    # clipped grads keep their storage dtype
    g.copy_(g.float() * scale)
    g32 = g.float()
    # moments keep their storage dtype; accumulation in fp32
    m.copy_(m.float() * cfg.b1 + g32 * (1 - cfg.b1))
    v.copy_(v.float() * cfg.b2 + torch.square(g32) * (1 - cfg.b2))
    step = (m.float() / mh).div_(torch.sqrt(v.float() / vh).add_(cfg.eps))
    step.add_(cfg.weight_decay * p.float())
    p.copy_(p.float() - lr * step)
