"""The shape-set registry of the dry run and the placement of a training
cell's state (port of `repro.launch.specs`).

`SHAPES`, `skip_reason`, `applicable` and `arch_rules` are the
reference's.  The reference's `abstract_inputs` builds `ShapeDtypeStruct`
stand-ins for the dry run's lowering, which comes with the dry-run report
(`launch/dryrun.py`, `launch/hlo_stats.py`), not yet ported.  What its
train branch places is here concretely: `train_state` puts this rank's
params (by `params.partition_specs`, in the policy's ``param_dtype``),
`m` and `v` (by `optim.opt_spec_tree`, ZeRO-1, in its ``opt_dtype``) and
the count on a process mesh, and `microbatches` clamps the policy's K
as the reference's `dryrun.lower_cell` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..configs import get_rules_overrides, get_train_policy
from ..models.config import ModelConfig
from ..pshard import DEFAULT_RULES, ShardingRules

__all__ = ["SHAPES", "ShapeSpec", "ENCDEC_MEM_LEN", "applicable",
           "arch_rules", "skip_reason", "microbatches", "train_state"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

#: encoder memory length for encdec decode shapes (fixed audio context)
ENCDEC_MEM_LEN = 4096


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return ("long_500k requires sub-quadratic attention; "
                f"{cfg.family} is full-attention (see DESIGN.md §5)")
    return None


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    return skip_reason(cfg, shape) is None


def arch_rules(arch: str, extra: Optional[dict] = None,
               serve: bool = False) -> ShardingRules:
    rules = DEFAULT_RULES.replace(**get_rules_overrides(arch, serve=serve))
    if extra:
        rules = rules.replace(**extra)
    return rules


def microbatches(k: int, batch: int, mesh) -> int:
    """The policy's K clamped so each slice still divides the data-parallel
    axes (the reference's `lower_cell`): min(k, max(1, batch // dp))."""
    dp = 1
    if mesh is not None:
        for ax in ("pod", "data"):
            if ax in mesh.axis_names:
                dp *= mesh.shape[ax]
    return min(k, max(1, batch // dp))


def train_state(params: Any, cfg: ModelConfig, mesh,
                rules: Optional[ShardingRules] = None,
                policy: Optional[dict] = None, device=None) -> dict:
    """This rank's training state on a process mesh, from the whole params
    (the same tree on every rank; see `launch.shards.place_state`), in
    the dtypes of `policy` (default: the arch's `get_train_policy`), on
    `device` (default: the params')."""
    from .shards import place_state, plan_for
    policy = policy or get_train_policy(cfg.name)
    return place_state(params, plan_for(cfg, mesh, rules),
                       getattr(torch, policy["param_dtype"]),
                       getattr(torch, policy["opt_dtype"]), device)
