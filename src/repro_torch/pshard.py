"""Logical-axis sharding (port of `repro.pshard`): one place that maps
model-logical dimension names to mesh axes.

Models annotate tensors with *logical* axes ("batch", "ff", "kv_seq",
...); the launcher installs an ambient mesh and a `ShardingRules` table;
resolution checks divisibility, so small or odd dimensions degrade to
replication instead of erroring.

A mesh here is anything with the reference's two attributes:
``axis_names`` (a tuple) and ``shape`` (axis name -> size) -- the process
mesh of `launch.mesh` (one process per position, on `torch.distributed`)
or an `AbstractMesh`, which has no processes and serves the pure
resolution functions.  `spec_for` returns the reference's per-dimension
entries as a plain tuple -- ``None``, an axis name, or a tuple of names --
and `to_placements` turns that tuple into DTensor placements (`Shard`,
`Replicate`), which stand for the reference's `NamedSharding`.

The port runs one process per mesh position, so a plain tensor under a
mesh is that process's local value; `constrain` redistributes a DTensor
and leaves a plain tensor as it is.

**Computing an axis where it lives.**  Where a serving rank's leaf holds
its slice of an axis that no batch axis splits (``heads``, ``kv_heads``,
``ff``, ``vocab`` on ``model``; `launch.placement.local_dims`), the model
computes that slice and the ranks of the axis's group meet in three
exchanges, each an exact all-gather (`launch.shards.Exchange`):
`model_sum` (the partial products of a row-parallel product, added in
rank order in fp32 and rounded once, so every rank holds the same bits),
`realign` (a column-parallel activation whose whole is several packed
segments, ``[u | g]`` or ``[k | v]``, cut so that a rank holds its slice
of each) and `vocab_greedy` (the greedy token from every rank's columns,
as `torch.argmax` of the whole row picks it).  `local_split` tells a
model whether a leaf holds a slice, by its shape.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["ShardingRules", "DEFAULT_RULES", "AbstractMesh", "ambient_mesh",
           "ambient_rules", "ambient_batch_shards", "ambient_batch_sum",
           "capture", "use_mesh_and_rules",
           "spec_for", "named_sharding", "to_placements", "shard_slices",
           "constrain",
           "constrain_tree", "spec_axes", "split_of", "local_split",
           "model_sum", "model_columns", "realign", "vocab_greedy"]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical dim name -> tuple of mesh axis names (in sharding order)."""

    table: Dict[str, Tuple[str, ...]] = dataclasses.field(default_factory=dict)

    def axes_for(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        return self.table.get(logical, ())

    def replace(self, **updates) -> "ShardingRules":
        t = dict(self.table)
        for k, v in updates.items():
            t[k] = tuple(v) if v else ()
        return ShardingRules(t)


#: the reference's default strategy: DP over (pod, data); TP/EP/vocab over
#: model; FSDP (weight d_model dim over data).  Reliability placement: the
#: TMR copy axis rides a "copy" mesh axis (present only on meshes folded by
#: `launch.mesh.fold_copy_axis`), and parity tables shard their arena-block
#: axis across the whole mesh.
DEFAULT_RULES = ShardingRules({
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "vocab_in": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "expert": ("model",),
    "model_dim": ("data",),
    "kv_seq": ("model",),
    "seq": (),
    "zero": ("data",),
    "copy": ("copy",),
    "arena_block": ("data", "model"),
})


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh shape without processes: ``AbstractMesh((2, 2), ("data",
    "model"))``.  Enough for `spec_for` and the placement rules."""

    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"sizes {self.sizes} vs axes {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


class _Ctx(threading.local):
    mesh = None
    rules: ShardingRules = DEFAULT_RULES
    batch_shards: int = 1
    batch_sum = None


_CTX = _Ctx()


def ambient_mesh():
    return _CTX.mesh


def ambient_rules() -> ShardingRules:
    return _CTX.rules


def ambient_batch_shards() -> int:
    """Into how many per-process pieces the running code's batch dimension
    was split (1 when every process holds the whole batch).  MoE reads it
    to count its local token groups."""
    return _CTX.batch_shards


def ambient_batch_sum():
    """The sharded training step's sum over the processes that hold the
    other pieces of the batch (``f(x) -> sum of every piece's x``, the
    gradient flowing to this process's own x), or None.  MoE reads it to
    make its load-balance statistics the whole batch's, as the
    reference's are."""
    return _CTX.batch_sum


@contextlib.contextmanager
def use_mesh_and_rules(mesh, rules: Optional[ShardingRules] = None,
                       batch_shards: int = 1, batch_sum=None):
    old = (_CTX.mesh, _CTX.rules, _CTX.batch_shards, _CTX.batch_sum)
    _CTX.mesh = mesh
    _CTX.rules = rules if rules is not None else DEFAULT_RULES
    _CTX.batch_shards = int(batch_shards)
    _CTX.batch_sum = batch_sum
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.batch_shards, _CTX.batch_sum = old


def capture():
    """The ambient context as a zero-argument context-manager factory:
    a layer recomputed in the backward (which autograd may run on another
    thread) re-enters the context its forward ran in."""
    return functools.partial(use_mesh_and_rules, _CTX.mesh, _CTX.rules,
                             _CTX.batch_shards, _CTX.batch_sum)


def _resolve_dim(size: int, logical: Optional[str], mesh,
                 rules: ShardingRules):
    axes = [a for a in rules.axes_for(logical) if a in mesh.axis_names]
    if not axes:
        return None
    total = 1
    for a in axes:
        total *= mesh.shape[a]
    if size % total != 0:
        return None  # degrade to replication rather than erroring
    return tuple(axes) if len(axes) > 1 else axes[0]


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]],
             mesh=None, rules: Optional[ShardingRules] = None) -> tuple:
    """Per-dimension sharding of a tensor with the given logical axes
    (None, an axis name or a tuple of names), with divisibility-checked
    degradation; mesh axes are never used twice.  ``()`` without a mesh
    (the reference's empty PartitionSpec)."""
    mesh = mesh if mesh is not None else ambient_mesh()
    rules = rules or ambient_rules()
    if mesh is None:
        return ()
    parts, used = [], set()
    for size, name in zip(shape, logical):
        r = _resolve_dim(size, name, mesh, rules)
        flat = r if isinstance(r, tuple) else ((r,) if r else ())
        if r is not None and not (set(flat) & used):
            parts.append(r)
            used.update(flat)
        else:
            parts.append(None)
    return tuple(parts)


def named_sharding(shape: Sequence[int], logical: Sequence[Optional[str]],
                   mesh=None, rules: Optional[ShardingRules] = None):
    """The DTensor placements of a tensor with the given logical axes (the
    reference's NamedSharding: `to_placements` of `spec_for`), or None
    without a mesh."""
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is None:
        return None
    return to_placements(spec_for(shape, logical, mesh, rules), mesh)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one dimension's entry, as a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _checked(spec: tuple, mesh) -> None:
    """A dimension over several mesh axes must name them in mesh order:
    DTensor nests a dimension's shards in mesh-dimension order, so any
    other order has no placement.  Raises; never reorders."""
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        pos = [mesh.axis_names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(
                f"dimension {d} is sharded over {axes}, which is not the "
                f"mesh's axis order {mesh.axis_names}: no DTensor placement "
                f"nests shards that way")


def to_placements(spec: tuple, mesh) -> list:
    """DTensor placements (one per mesh axis, in mesh order) of a
    `spec_for` tuple: ``Shard(d)`` on every mesh axis dimension d is split
    over, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    _checked(spec, mesh)
    out = [Replicate() for _ in mesh.axis_names]
    for d, entry in enumerate(spec):
        for a in spec_axes(entry):
            out[mesh.axis_names.index(a)] = Shard(d)
    return out


def shard_slices(shape: Sequence[int], spec: tuple, mesh,
                 coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The slice of a `shape` tensor that the process at mesh `coords`
    holds under `spec` (the reference's NamedSharding layout: a dimension
    over axes (a1, a2) is cut into size(a1) * size(a2) even pieces, a1
    major)."""
    _checked(spec, mesh)
    out = []
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        k, n = 0, 1
        for a in spec_axes(entry):
            k = k * mesh.shape[a] + coords[a]
            n *= mesh.shape[a]
        step = size // n
        out.append(slice(k * step, (k + 1) * step))
    return tuple(out)


def constrain(x, *logical: Optional[str]):
    """Redistribute a DTensor to the placements its logical axes resolve
    to on the ambient mesh; a no-op without a mesh, and for a plain tensor
    (a process's local value)."""
    mesh = ambient_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = spec_for(x.shape, logical, mesh, ambient_rules())
    return x.redistribute(mesh.device_mesh, to_placements(spec, mesh))


def constrain_tree(tree, spec_tree):
    """`constrain` a tree of DTensors against a tree of spec tuples;
    no-op when spec_tree is None or there is no ambient mesh."""
    mesh = ambient_mesh()
    if mesh is None or spec_tree is None:
        return tree
    from torch.distributed.tensor import DTensor

    from .core import tree as T

    def one(x, s):
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(mesh.device_mesh, to_placements(s, mesh))
    return T.map_tree(one, tree, spec_tree)


# -- computing an axis where it lives (module doc) -----------------------------

def split_of(whole: Sequence[int], logical: Sequence[Optional[str]],
             dim: int) -> Tuple[Tuple[str, ...], int, int]:
    """(axes, n, k): the mesh axes dimension `dim` of a `whole`-shaped
    tensor with these logical axes is split over on the ambient mesh and
    rules, their rank count and this rank's index among them (((), 1, 0)
    without a mesh or a split)."""
    mesh = ambient_mesh()
    if mesh is None:
        return (), 1, 0
    axes = spec_axes(spec_for(whole, logical, mesh, ambient_rules())[dim])
    if not axes or mesh.group_size(axes) <= 1:
        return (), 1, 0
    return axes, mesh.group_size(axes), mesh.index_in(axes)


def local_split(w, whole: Sequence[int], logical: Sequence[Optional[str]],
                dim: int) -> Tuple[Tuple[str, ...], int, int]:
    """`split_of` for a leaf `w` of a `whole`-shaped tensor: ((), 1, 0)
    when `w` holds the whole dimension `dim` (a leaf gathered whole, or no
    mesh), else the split its slice is this rank's of."""
    if w.shape[dim] == whole[dim]:
        return (), 1, 0
    axes, n, k = split_of(whole, logical, dim)
    if n * w.shape[dim] != whole[dim]:
        raise ValueError(f"a leaf of {tuple(w.shape)} is no rank's slice of "
                         f"{tuple(whole)} over {axes or 'no axes'}")
    return axes, n, k


def _exchange():
    from .launch.shards import exchange_for
    return exchange_for(ambient_mesh())


#: the bytes of a rank's part in one exchange of the model group: a
#: larger activation goes in row chunks, so that at most the group's parts
#: of one chunk are in flight (a long prefill's would be n times the
#: activation)
PART_BYTES = 1 << 26


def _row_chunks(x, width: int):
    """x as rows (..., last dim) and the row slices each exchange takes,
    an out-tensor's rows being `width` wide."""
    rows = x.reshape(-1, x.shape[-1])
    step = max(1, PART_BYTES // max(1, width * rows.element_size()))
    return rows, [slice(a, a + step) for a in range(0, rows.shape[0], step)]


def model_sum(x, axes: Sequence[str]):
    """The sum over the ranks of `axes` of every rank's partial `x`, added
    in rank order in fp32 and rounded once to x's dtype: the same bits on
    every rank.  `x` itself over no axes."""
    if not axes:
        return x
    rows, chunks = _row_chunks(x, x.shape[-1])
    if len(chunks) == 1:
        return _exchange().sum(x, axes).to(x.dtype)
    out = rows.new_empty(rows.shape)
    for sl in chunks:
        out[sl] = _exchange().sum(rows[sl], axes)
    return out.view(x.shape)


def model_columns(x, axes: Sequence[str]):
    """The whole last dimension of which `x` holds this rank's contiguous
    slice (the ranks of `axes` in order); `x` itself over no axes."""
    import torch
    if not axes:
        return x
    n = ambient_mesh().group_size(axes)
    rows, chunks = _row_chunks(x, x.shape[-1])
    if len(chunks) == 1:
        return torch.cat([p for _, p in _exchange().parts(x, axes)], dim=-1)
    out = rows.new_empty((rows.shape[0], n * rows.shape[1]))
    for sl in chunks:
        torch.cat([p for _, p in _exchange().parts(rows[sl], axes)], dim=-1,
                  out=out[sl])
    return out.view(*x.shape[:-1], out.shape[-1])


def realign(x, axes: Sequence[str], segments: int):
    """A column-parallel activation cut by segment: `x` holds this rank's
    contiguous n-th of a whole last dimension packed as `segments` equal
    parts (``[u | g]``, ``[k | v]``); returns this rank's n-th of each
    part, in part order, contiguous."""
    import torch
    if not axes or segments == 1:
        return x
    mesh = ambient_mesh()
    n, k = mesh.group_size(axes), mesh.index_in(axes)
    part = x.shape[-1] * n // segments
    w = part // n
    rows, chunks = _row_chunks(x, x.shape[-1])
    out = rows.new_empty(rows.shape)
    for sl in chunks:
        whole = torch.cat([p for _, p in _exchange().parts(rows[sl], axes)],
                          dim=-1)
        torch.cat([whole[:, s * part + k * w:s * part + (k + 1) * w]
                   for s in range(segments)], dim=-1, out=out[sl])
    return out.view(x.shape)


def vocab_greedy(logits, axes: Sequence[str]):
    """The greedy token (int32, logits' shape without the last axis) of a
    row whose columns are split over the ranks of `axes`: each rank's
    largest value and its first index, then the largest over the ranks in
    column order, a tie to the lowest index and a NaN taken as the
    largest -- `torch.argmax` of the whole row, without it."""
    import torch
    i = torch.argmax(logits, dim=-1)
    if not axes:
        return i.to(torch.int32)
    v = torch.gather(logits.float(), -1, i[..., None])[..., 0]
    width = logits.shape[-1]
    pair = torch.stack([v.view(torch.int32), i.to(torch.int32)])
    best = at = None
    for r, (_, part) in enumerate(_exchange().parts(pair, axes)):
        pv, pi = part[0].view(torch.float32), part[1] + r * width
        if best is None:
            best, at = pv.clone(), pi
            continue
        take = (pv > best) | (torch.isnan(pv) & ~torch.isnan(best))
        best = torch.where(take, pv, best)
        at = torch.where(take, pi, at)
    return at
