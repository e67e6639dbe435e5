"""Derived sharding rules (port of `repro.optim.sharding_rules`): ZeRO-1
moment specs and the reliability placement, as pure functions over
`pshard.spec_for` tuples.

Parameters are TP-sharded over "model"; the Adam moments (2x fp32 the
size of the params) would otherwise be replicated over "data"/"pod", so
the moment Spec assigns the largest physically replicated dimension the
logical axis "zero" (mapped to the data axis), ZeRO stage 1.  The
reliability placement (DESIGN.md §14) puts redundancy where the data it
protects lives: parity tables shard their arena-block axis across the
whole mesh (logical "arena_block"), and stacked TMR copies ride the
"copy" axis of a `launch.mesh.fold_copy_axis` mesh.  `opt_spec_tree`'s
caller (the sharded training step) comes with the training mesh.
"""
from __future__ import annotations

from typing import Any, Optional

from ..core import tree as T
from ..models.params import Spec
from ..pshard import DEFAULT_RULES, ShardingRules, spec_for

__all__ = ["opt_spec_tree", "parity_pspec", "copy_stack_pspec"]

_REPLICATED = (None, "model_dim", "seq")  # logicals that resolve to ()


def _zero_shard(s: Spec) -> Spec:
    # the largest dim whose logical axis is physically replicated
    best, best_size = None, 0
    for i, (size, name) in enumerate(zip(s.shape, s.axes)):
        if name in _REPLICATED and size > best_size:
            best, best_size = i, size
    if best is None:
        return Spec(s.shape, s.axes, "zeros")
    axes = tuple("zero" if i == best else a for i, a in enumerate(s.axes))
    return Spec(s.shape, axes, "zeros")


def opt_spec_tree(param_specs: Any) -> Any:
    """Spec tree for one Adam moment (m or v), ZeRO-1 sharded."""
    return T.map_tree(_zero_shard, param_specs)


def parity_pspec(n_blocks: int, n_slopes: int, mesh,
                 rules: Optional[ShardingRules] = None) -> tuple:
    """Sharding of an ECC parity table (n_blocks, n_slopes): the arena
    block axis across the whole mesh, so each rank holds the parity rows
    of the blocks it scrubs (replicated when n_blocks does not divide)."""
    return spec_for((n_blocks, n_slopes), ("arena_block", None), mesh, rules)


def copy_stack_pspec(pspec: tuple, mesh, copies: int = 3,
                     rules: Optional[ShardingRules] = None) -> tuple:
    """Sharding of a (copies, *shape) stack of TMR copies: the "copy"
    logical axis prepended to a per-copy spec.  On a fold_copy_axis mesh
    the leading dim shards over the copy replica groups; elsewhere (no
    "copy" axis, or one whose size does not divide `copies`) it is
    replicated -- correct, just not free."""
    rules = rules or DEFAULT_RULES
    axes = tuple(a for a in rules.axes_for("copy") if a in mesh.axis_names)
    total = 1
    for a in axes:
        total *= mesh.shape[a]
    if not axes or copies % total != 0:
        return (None,) + tuple(pspec)
    return (axes if len(axes) > 1 else axes[0],) + tuple(pspec)
