"""The shape-set registry of the dry run, its abstract inputs, and the
placement of a training cell's state (port of `repro.launch.specs`).

`SHAPES`, `skip_reason`, `applicable` and `arch_rules` are the
reference's.  `abstract_inputs(arch, shape, mesh)` gives every input of a
cell's step as one rank's shards on the ``meta`` device
(`params.abstractify`): nothing is allocated for the full configs, and
the shapes are the reference's per-device shapes on the same mesh.  What
its train branch places is here concretely too: `train_state` puts this
rank's params (by `params.partition_specs`, in the policy's
``param_dtype``), `m` and `v` (by `optim.opt_spec_tree`, ZeRO-1, in its
``opt_dtype``) and the count on a process mesh, and `microbatches` clamps
the policy's K as the reference's `dryrun.lower_cell` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..configs import get_config, get_rules_overrides, get_train_policy
from ..models.config import ModelConfig
from ..pshard import DEFAULT_RULES, ShardingRules

__all__ = ["SHAPES", "ShapeSpec", "ENCDEC_MEM_LEN", "applicable",
           "arch_rules", "abstract_inputs", "cell_inputs", "skip_reason",
           "microbatches", "train_state"]


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


def _mem_len(cfg: ModelConfig, shape: ShapeSpec) -> int:
    if cfg.family == "vlm":
        return cfg.vis_tokens
    if cfg.family == "encdec":
        return shape.seq if shape.kind == "train" else ENCDEC_MEM_LEN
    return 0


def abstract_inputs(arch: str, shape_name: str, mesh,
                    rules: Optional[ShardingRules] = None) -> Dict[str, Any]:
    """Every input of the (arch, shape) cell's step as this rank's shards
    on ``meta`` (`params.abstractify`), by kind:
      train  : state {params, opt {m, v, count}} in the train policy's
               dtypes, the moments ZeRO-1 (`optim.opt_spec_tree`); batch
      prefill: params (compute dtype, as serving holds them), batch
      decode : params, cache, token
    plus 'cfg', 'rules', 'shape' and (train) 'policy'."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    reason = skip_reason(cfg, shape)
    if reason:
        raise ValueError(f"{arch} x {shape_name} skipped: {reason}")
    policy = get_train_policy(arch) if shape.kind == "train" else None
    return cell_inputs(cfg, shape, mesh, rules or arch_rules(arch), policy)


def cell_inputs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                rules: Optional[ShardingRules] = None,
                policy: Optional[dict] = None) -> Dict[str, Any]:
    """`abstract_inputs` of a config (cut in depth, say) and any shape:
    train cells in `policy`'s dtypes (default: the arch's)."""
    from ..data.synthetic import make_batch_specs
    from ..models.params import Spec, abstractify
    from ..models.transformer import cache_specs, model_specs
    from ..optim.sharding_rules import opt_spec_tree
    rules = rules if rules is not None else DEFAULT_RULES
    pspecs = model_specs(cfg)
    out: Dict[str, Any] = {"cfg": cfg, "rules": rules, "shape": shape}
    if shape.kind == "train":
        policy = policy or get_train_policy(cfg.name)
        out["policy"] = policy
        params = abstractify(pspecs, mesh, policy["param_dtype"], rules)
        bspecs = make_batch_specs(cfg, shape.batch, shape.seq,
                                  mem_len=_mem_len(cfg, shape))
        opt_specs = opt_spec_tree(pspecs)
        odt = policy["opt_dtype"]
        out["state"] = {"params": params, "opt": {
            "m": abstractify(opt_specs, mesh, odt, rules),
            "v": abstractify(opt_specs, mesh, odt, rules),
            "count": abstractify(Spec((), (), "zeros", dtype="int32"), mesh,
                                 torch.int32, rules)}}
        out["batch"] = abstractify(bspecs, mesh, cfg.cdtype, rules)
        return out

    # serving cells hold compute-dtype (bf16) parameters
    out["params"] = abstractify(pspecs, mesh, cfg.cdtype, rules)
    if shape.kind == "prefill":
        bspecs = make_batch_specs(cfg, shape.batch, shape.seq,
                                  mem_len=_mem_len(cfg, shape))
        out["batch"] = abstractify(bspecs, mesh, cfg.cdtype, rules)
    else:  # decode
        cspecs = cache_specs(cfg, shape.batch, shape.seq,
                             mem_len=_mem_len(cfg, shape))
        out["cache"] = abstractify(cspecs, mesh, cfg.cdtype, rules)
        out["token"] = abstractify(
            Spec((shape.batch, 1), ("batch", None), dtype="int32"),
            mesh, torch.int32, rules)
    return out


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
