"""Declarative parameter specs, materialized into an arena (port of
`repro.models.params`: `Spec`, `materialize`, `abstractify`,
`partition_specs` and `count_params`, plus `from_numpy` and
`train_state_from_reference`, which carry the JAX package's parameters
and training state across as numpy trees).

Parameters are a dict tree with the reference's keys and shapes (stacked
``(n_layers, ...)`` layer leaves included) whose leaves are views of one
packed int32 arena (`core.arena`), so protection acts on the weights the
model reads.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..core import arena, prng
from ..core import tree as T

__all__ = ["Spec", "layout", "materialize", "fill_range", "abstractify",
           "count_params",
           "from_numpy", "train_state_from_reference", "partition_specs"]


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]       # logical axis names, len == ndim
    init: str = "normal"                  # normal | zeros | ones | scaled
    scale: float = 0.02
    dtype: Optional[str] = None           # None -> caller's default dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")

    def resolved_dtype(self, default) -> torch.dtype:
        return arena.torch_dtype(self.dtype if self.dtype is not None
                                 else default)


@dataclasses.dataclass(frozen=True)
class _Leaf:
    shape: Tuple[int, ...]
    dtype: torch.dtype


def layout(tree: Any, dtype: Any = "float32") -> arena.ArenaSpec:
    """The arena layout of a Spec tree (what `materialize` allocates),
    without allocating."""
    return arena.arena_spec(T.map_tree(
        lambda s: _Leaf(s.shape, s.resolved_dtype(dtype)), tree))


def materialize(tree: Any, generator: torch.Generator,
                dtype: Any = "float32", device=None) -> Any:
    """Parameters for a Spec tree, drawn in place into a fresh arena on
    `device` (default: the generator's device).

    Same distributions as the reference (normal(0, scale); "scaled" is
    normal / sqrt(shape[0]), the reference's fan-in rule, which for stacked
    layer leaves is the layer count), drawn from `generator`, one leaf
    after another in flatten order.  `generator` may be a `core.prng` key:
    leaf i then takes the reference's draw under ``split(key, n)[i]``,
    scaled in float32 as the reference scales it: its bits."""
    device = torch.device(device) if device is not None else generator.device
    spec = layout(tree, dtype)
    words = torch.zeros(spec.n_words, dtype=torch.int32, device=device)
    params = arena.unpack(words, spec)
    leaves, specs = T.leaves(params), T.leaves(tree)
    keys = prng.split(generator, len(specs)) if prng.is_key(generator) \
        else [None] * len(specs)
    for x, s, k in zip(leaves, specs, keys):
        if s.init == "zeros":
            continue
        if s.init == "ones":
            x.fill_(1)
        elif k is not None:
            x.view(-1).copy_(_keyed(s, k, 0, x.numel()))
        elif s.init == "scaled":
            x.normal_(0.0, 1.0 / _fan_in(s) ** 0.5, generator=generator)
        else:
            x.normal_(0.0, s.scale, generator=generator)
    return params


def _fan_in(s: Spec) -> int:
    return s.shape[0] if len(s.shape) > 1 else max(s.shape[0], 1)


def _keyed(s: Spec, k: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """Flat elements [start, start + count) of a normal or scaled leaf
    drawn under its key `k`, float32, as the reference scales them."""
    x = prng.normal(k, count, start)
    if s.init == "scaled":
        # the float32 root, exact; a tensor divisor, since CUDA divides by
        # a host scalar through its reciprocal
        root = torch.tensor(float(np.float32(np.sqrt(_fan_in(s)))),
                            device=x.device)
        return x / root
    return x * float(np.float32(s.scale))


#: the most elements `fill_range` draws at once
FILL_STEP = 1 << 26


def fill_range(tree: Any, key: torch.Tensor, words: torch.Tensor, lo: int,
               dtype: Any = "float32") -> None:
    """Words [lo, lo + words.numel()) of the arena `materialize(tree, key,
    dtype)` draws, into `words` (int32, on the key's device), with nothing
    before them drawn: every keyed value is a function of (its leaf's key,
    its flat index), so a range of the arena -- a mesh rank's block range
    -- is drawn alone, `FILL_STEP` elements at a time.  Pad words are
    zero.  A `torch.Generator` cannot fill the middle of a leaf without
    drawing what comes before it, so this takes a key only."""
    if not prng.is_key(key):
        raise TypeError("fill_range draws from a core.prng key")
    spec = layout(tree, dtype)
    hi = lo + words.numel()
    words.zero_()
    specs = T.leaves(tree)
    for s, leaf, k in zip(specs, spec.leaves, prng.split(key, len(specs))):
        a = min(max(lo - leaf.offset, 0), leaf.n_words)
        b = min(max(hi - leaf.offset, a), leaf.n_words)
        if a == b or s.init == "zeros":
            continue
        w = words[leaf.offset + a - lo:leaf.offset + b - lo]
        if leaf.dtype == torch.bfloat16:    # two halves a word, LSB first
            n = 1
            for d in leaf.shape:
                n *= d
            e0, e1 = 2 * a, min(2 * b, n)
            x = w.view(torch.bfloat16)[:e1 - e0]
        else:
            e0, x = a, w.view(leaf.dtype)
        if s.init == "ones":
            x.fill_(1)
            continue
        for start, count in prng.chunks(x.numel(), FILL_STEP):
            x[start:start + count] = _keyed(s, k, e0 + start, count)


def abstractify(tree: Any, mesh, dtype: Any = "float32", rules=None) -> Any:
    """One rank's shard of every leaf of a Spec tree as a ``meta`` tensor
    (the dry run's inputs: nothing allocated), shaped by `pshard.spec_for`
    and `pshard.shard_slices` at the mesh's ``coords`` (rank 0's where it
    has none: a dimension is split only where it divides, so every rank's
    shard has this shape); whole leaves without a mesh.
    `launch.shards.global_shape` gives a shard's whole shape back."""
    from ..pshard import shard_slices, spec_for

    def conv(s: Spec) -> torch.Tensor:
        shape = tuple(s.shape)
        if mesh is not None:
            coords = getattr(mesh, "coords", None) or {
                a: 0 for a in mesh.axis_names}
            sl = shard_slices(shape, spec_for(shape, s.axes, mesh, rules),
                              mesh, coords)
            shape = tuple(x.stop - x.start for x in sl)
        return torch.empty(shape, dtype=s.resolved_dtype(dtype),
                           device="meta")
    return T.map_tree(conv, tree)


def partition_specs(tree: Any, mesh, rules=None) -> Any:
    """The `pshard.spec_for` tuple of every leaf of a Spec tree on `mesh`
    (the reference's PartitionSpec tree)."""
    from ..pshard import spec_for
    return T.map_tree(lambda s: spec_for(s.shape, s.axes, mesh, rules), tree)


def count_params(tree: Any) -> int:
    """Parameters in a Spec tree (nothing materialized)."""
    tot = 0
    for s in T.leaves(tree):
        n = 1
        for d in s.shape:
            n *= d
        tot += n
    return tot


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if arena.torch_dtype(a.dtype) == torch.bfloat16:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def from_numpy(tree: Any, device="cpu") -> Any:
    """The port's parameters for a tree of numpy arrays (e.g. the JAX
    package's parameters through ``jax.tree.map(np.asarray, params)``),
    copied bit for bit into a fresh arena on `device`."""
    # numpy has no bf16: such leaves move as their raw bits
    words, spec = arena.pack(T.map_tree(lambda a: _tensor(a, "cpu"), tree))
    return arena.unpack(words.to(device), spec)


def train_state_from_reference(state: Any, device="cpu") -> dict:
    """The port's training state for the reference's ``{params, opt: {m,
    v, count}, [err]}`` as a tree of numpy arrays (``jax.tree.map(
    np.asarray, state)``): the params in a fresh arena (`from_numpy`), the
    moments and the error state as tensors, the count a 0-d int32, all on
    `device` and bit for bit."""
    out = {"params": from_numpy(state["params"], device),
           "opt": {"m": T.map_tree(lambda a: _tensor(a, device),
                                   state["opt"]["m"]),
                   "v": T.map_tree(lambda a: _tensor(a, device),
                                   state["opt"]["v"]),
                   "count": torch.tensor(int(np.asarray(
                       state["opt"]["count"])), dtype=torch.int32,
                       device=device)}}
    if "err" in state:
        out["err"] = T.map_tree(lambda a: _tensor(a, device), state["err"])
    return out

