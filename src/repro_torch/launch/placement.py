"""The serving store on a process mesh (DESIGN.md §14): how `prepare`
builds each rank's shard, and how the model reads a sharded store.

**Placement.**  Every leaf is placed as `pshard.spec_for` resolves its
logical axes on the engine's exec mesh (FSDP ``model_dim`` over data,
``ff``/``heads``/``vocab`` over model, small or odd dims replicated): a
rank holds exactly its slice of every leaf (`pshard.shard_slices`), packed
into a local arena of its own.  TMR copies ride the "copy" axis of a
folded mesh (each copy group holds one copy) and are held by every rank
otherwise (`optim.sharding_rules.copy_stack_pspec`).

**The build plan** (`build_store`).  Flattening sharded leaves into one
arena is not left to DTensor's ``cat`` and bit views; the plan is explicit:

1. every rank has the whole clean parameter arena (the caller's);
2. ECC schemes encode the parity of this rank's contiguous block range of
   the clean arena only (`kernels.sharded.block_range`);
3. copy by copy, in the unmeshed order, the fault model draws the whole
   copy's faults from the run's generator on every rank -- a copy this
   rank does not hold is drawn and dropped (`FaultModel.skip`), so no draw
   depends on rank or world size -- into one working arena;
4. ECC schemes scrub this rank's block range of the working arena with
   the kernel, then the ranks of the scrub group swap their (sparse)
   corrections -- word index and repaired value, by an int64 / int32 SUM
   all-reduce (`kernels.sharded.scrub_joined`, which `shard_scrub` runs
   too) -- so every rank's working arena is the whole scrubbed copy;
5. the rank copies its slice of every leaf into its local arena; the
   scrub counts, summed over the scrub group by each scrub, are summed
   over the remaining axes (a folded mesh's copy axis) once, at the end.

At its peak a rank holds the clean arena, one working arena, its local
arena, its range's parity and (in a scrub group of several ranks) a copy
of its range from before the scrub.  When the rank's slice of every leaf is the
whole leaf (a folded copy group of one rank) the working arena IS the
local arena, and with ``donate`` (one held copy) the working arena is the
caller's clean arena itself: the rank then holds one copy in all.

**Reading** (`gathered`).  The model gets a lazy view of a store: a leaf
is gathered whole when the layer reads it -- the explicit redistribute
(Shard -> Replicate) that DTensor's ``full_tensor()`` would do -- and
dropped after.  Stacked layer leaves are gathered one layer at a time, so
a rank holds its shards plus the leaves of the layer it runs (FSDP).  The
gather is an int32 SUM all-reduce of this rank's slice placed into zeros
(exact on every backend: gloo has no all-gather for CUDA tensors), except
where several ranks share one card (gloo over CUDA, whose collectives
stage through host memory): there every rank maps its peers' local arenas
once, when the store is built (CUDA IPC handles swapped by one object
all-gather after a device sync), and a gather copies each peer's slice
device to device.  The arenas are not written after they are built.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from ..core import arena, prng
from ..core import tree as T
from ..kernels.sharded import BLOCK, block_range, scrub_joined
from ..pshard import shard_slices, spec_axes

__all__ = ["ShardedStore", "build_store", "place_store", "empty_store",
           "gathered", "replicate",
           "exchange_copies", "row_split", "gather_rows", "local_elements"]


@dataclasses.dataclass
class ShardedStore:
    """One rank's part of a serving store (module doc).

    words  : the local arena, (n_words,) or (C, n_words) int32 with
             C = len(held): this rank's slice of every leaf.
    spec   : its layout; `global_spec` the unsharded arena's.
    specs  : per-copy `spec_for` tuple of every leaf, flatten order.
    held   : the copy indices this rank holds, or None (no copy axis).
    mesh   : the exec mesh the store is placed on.
    peers  : the other ranks' `words` mapped here (ranks sharing one card).
    """

    words: torch.Tensor
    spec: arena.ArenaSpec
    global_spec: arena.ArenaSpec
    specs: List[tuple]
    held: Optional[Tuple[int, ...]]
    mesh: Any
    peers: Optional[dict] = None

    def slot(self, copy: Optional[int]) -> Optional[int]:
        """Index of `copy` in the local copy axis (None: no copy axis)."""
        if self.held is None:
            return None
        if copy not in self.held:
            raise ValueError(f"copy {copy} is not held by rank "
                             f"{self.mesh.rank} (holds {self.held})")
        return self.held.index(copy)


def local_elements(store: ShardedStore) -> int:
    """Elements of every leaf this rank holds (all held copies)."""
    copies = 1 if store.held is None else len(store.held)
    return copies * sum(math.prod(l.shape) for l in store.spec.leaves)


def _layout(global_spec: arena.ArenaSpec, specs, mesh):
    """(this rank's slice of every leaf, the local arena's layout): the
    global layout itself when every slice is the whole leaf."""
    slices = [shard_slices(l.shape, s, mesh, mesh.coords)
              for l, s in zip(global_spec.leaves, specs)]
    local = [arena.LeafSpec(0, 0, 0, l.dtype,
                            tuple(x.stop - x.start for x in sl))
             for l, sl in zip(global_spec.leaves, slices)]
    if all(ll.shape == l.shape for ll, l in zip(local, global_spec.leaves)):
        return slices, global_spec
    return slices, arena.arena_spec(T.unflatten(global_spec.paths, local))


def _keep_slices(dst: torch.Tensor, lspec, src: torch.Tensor, global_spec,
                 slices) -> None:
    """dst's leaves := this rank's slices of src's whole leaves."""
    for d, s, sl in zip(T.leaves(arena.unpack(dst, lspec)),
                        T.leaves(arena.unpack(src, global_spec)), slices):
        d.copy_(s[sl])


def _store(local: torch.Tensor, lspec, global_spec, specs, mesh, held):
    """The ShardedStore over a (C, n) local arena (C = 1 without a copy
    axis), its peers mapped when the ranks share a card."""
    words = local.view(-1) if held is None else local
    return _share(ShardedStore(words=words, spec=lspec,
                               global_spec=global_spec, specs=list(specs),
                               held=None if held is None else tuple(held),
                               mesh=mesh))


def copy_source(generator, i: int):
    """Copy i's fault source when a store is built: the one generator,
    drawn in copy order, or ``fold_in(key, 100 + i)`` for a `core.prng`
    key (the reference engine's convention)."""
    if prng.is_key(generator):
        return prng.fold_in(generator, 100 + i)
    return generator


def build_store(words: torch.Tensor, global_spec: arena.ArenaSpec,
                specs: Sequence[tuple], mesh, *, copies: int,
                held: Optional[Tuple[int, ...]], fault=None,
                generator: Optional[torch.Generator] = None,
                dt: float = 1.0, ecc=None, scrub_axes: Sequence[str] = (),
                donate: bool = False):
    """This rank's `ShardedStore` of `copies` corrupted (and, with `ecc`,
    scrubbed) copies of the clean arena `words`, by the plan of the module
    doc.  `scrub_axes`: the mesh axes each copy's block range is split
    over.  Returns (store, counts (3,) int32 summed over the mesh, or
    None without `ecc`)."""
    dev = words.device
    slices, lspec = _layout(global_spec, specs, mesh)
    held_set = (0,) if held is None else held
    # the working arena: the caller's own when donated (one held copy)
    if donate and len(held_set) == 1:
        work = words
    elif fault is None and ecc is None:
        work = words                    # read only
    else:
        work = words.clone()
    if lspec is global_spec and len(held_set) == 1:
        local = work.view(1, -1)        # the working arena is the store
    else:
        local = torch.zeros((len(held_set), lspec.n_words),
                            dtype=torch.int32, device=dev)
    total = None
    if ecc is not None:
        lo, hi = block_range(global_spec.n_blocks,
                             mesh.group_size(scrub_axes),
                             mesh.index_in(scrub_axes))
        parity = ecc.encode_arena(words[lo * BLOCK:hi * BLOCK])
        total = torch.zeros(3, dtype=torch.int32, device=dev)
    fresh = True
    for j in range(copies):
        if j not in held_set:
            if fault is not None:
                fault.skip(arena.unpack(words, global_spec),
                           copy_source(generator, j), dt)
            continue
        if not fresh and work is not words:
            work.copy_(words)
        fresh = False
        if fault is not None:
            fault.corrupt(arena.unpack(work, global_spec),
                          copy_source(generator, j), dt)
        if ecc is not None:
            # this rank's range scrubbed by the kernel, the group's
            # corrections swapped into the whole working arena
            _, counts = scrub_joined(ecc.scrub_arena, mesh, scrub_axes,
                                     work, parity.clone(), lo)
            total += counts
        if local.data_ptr() != work.data_ptr():
            _keep_slices(local[held_set.index(j)], lspec, work, global_spec,
                         slices)
    if total is not None:
        # summed over the scrub group by each scrub; the other axes (the
        # copy axis of a folded mesh) add the other copies' counts
        total = mesh.all_reduce(total, tuple(
            a for a in mesh.axis_names if a not in scrub_axes))
    return _store(local, lspec, global_spec, specs, mesh, held), total


def place_store(words: torch.Tensor, global_spec: arena.ArenaSpec,
                specs: Sequence[tuple], mesh,
                held: Optional[Tuple[int, ...]]) -> ShardedStore:
    """Place an already built store -- `words` (n_words,) or (3, n_words)
    -- on `mesh`: this rank's slices of the copies it holds, nothing drawn
    or scrubbed (a checkpoint restore, an externally built store)."""
    slices, lspec = _layout(global_spec, specs, mesh)
    rows = [words] if held is None else [words[j] for j in held]
    local = torch.zeros((len(rows), lspec.n_words), dtype=torch.int32,
                        device=words.device)
    for slot, row in enumerate(rows):
        _keep_slices(local[slot], lspec, row, global_spec, slices)
    return _store(local, lspec, global_spec, specs, mesh, held)


def empty_store(global_spec: arena.ArenaSpec, specs: Sequence[tuple], mesh,
                held: Optional[Tuple[int, ...]], device=None) -> ShardedStore:
    """A store of this rank's layout whose words are not set (the dry
    run's, on ``meta``: nothing is drawn, scrubbed or allocated)."""
    _, lspec = _layout(global_spec, specs, mesh)
    local = torch.empty((1 if held is None else len(held), lspec.n_words),
                        dtype=torch.int32, device=device or mesh.device)
    return _store(local, lspec, global_spec, specs, mesh, held)


def _share(store: ShardedStore) -> ShardedStore:
    """Map every other rank's local arena here when the ranks share one
    card (module doc); collective."""
    mesh = store.mesh
    if not mesh.shares_card:
        return store
    import torch.distributed as dist
    from torch.multiprocessing.reductions import reduce_tensor
    # the arena is complete on the card before any peer reads it
    torch.cuda.synchronize(store.words.device)
    handles = [None] * mesh.size
    dist.all_gather_object(handles, reduce_tensor(store.words))
    store.peers = {r: fn(*args) for r, (fn, args) in enumerate(handles)
                   if r != mesh.rank}
    return store


# -- reading a sharded store ----------------------------------------------------

def _as_int32(full: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """An integer tensor carrying `full`'s bits, for an exact SUM (a view
    for 32-bit floats, the tensor itself for int32/int64; a widened copy of
    the half-words for bf16), and whether it is a copy."""
    if full.dtype in (torch.int32, torch.int64):
        return full, False
    if full.dtype == torch.float32:
        return full.view(torch.int32), False
    if full.dtype == torch.bfloat16:
        return full.view(torch.int16).to(torch.int32), True
    raise TypeError(f"cannot move {full.dtype} bits")


def replicate(local: torch.Tensor, shape: Sequence[int], sl: Tuple[slice, ...],
              axes: Sequence[str], mesh) -> torch.Tensor:
    """The whole tensor of which `local` is this rank's slice `sl`: the
    slice placed into zeros, then an int32 SUM all-reduce over the ranks
    of `axes` (the explicit Shard -> Replicate redistribute; exact, every
    element is one rank's bits plus zeros)."""
    if not axes or mesh.group_size(axes) <= 1:
        return local
    full = torch.zeros(tuple(shape), dtype=local.dtype, device=local.device)
    full[sl] = local
    w, copied = _as_int32(full)
    mesh.all_reduce(w, axes)
    if copied:
        full.view(torch.int16).copy_(w.to(torch.int16))
    return full


def _leaf_view(words: torch.Tensor, spec: arena.ArenaSpec, li: int,
               slot: Optional[int]) -> torch.Tensor:
    """Leaf `li` of a local arena (copy `slot` of a copy-axis one)."""
    w = words if slot is None else words[slot]
    leaf = spec.leaves[li]
    return arena.words_to_leaf(w[leaf.offset:leaf.offset + leaf.n_words],
                               leaf)


def _gather(store: ShardedStore, li: int, slot: Optional[int],
            idx: Tuple[int, ...]) -> torch.Tensor:
    """Leaf `li` (at stacked index `idx`) whole, from the ranks of its
    shard group."""
    mesh, spec = store.mesh, store.specs[li]
    shape = store.global_spec.leaves[li].shape
    local = _leaf_view(store.words, store.spec, li, slot)[idx]
    axes = tuple(a for e in spec for a in spec_axes(e))
    if not axes or mesh.group_size(axes) <= 1:
        return local
    n = len(idx)
    if store.peers is None:
        sl = shard_slices(shape, spec, mesh, mesh.coords)
        return replicate(local, shape[n:], sl[n:], axes, mesh)
    full = torch.empty(shape[n:], dtype=local.dtype, device=local.device)
    for r in mesh.group_ranks(axes):
        src = local if r == mesh.rank else \
            _leaf_view(store.peers[r], store.spec, li, slot)[idx]
        full[shard_slices(shape, spec, mesh, mesh.coords_of(r))[n:]] = src
    return full


class Lazy:
    """A leaf of a lazy params view: `get` returns the tensor the model
    reads (`View` calls it when the leaf is read)."""
    __slots__ = ()

    def get(self) -> torch.Tensor:
        raise NotImplementedError


class _Leaf(Lazy):
    __slots__ = ("store", "li", "slot", "idx")

    def __init__(self, store, li, slot, idx=()):
        self.store, self.li, self.slot, self.idx = store, li, slot, idx

    @property
    def n_stacked(self) -> int:
        return self.store.global_spec.leaves[self.li].shape[len(self.idx)]

    def at(self, idx: Tuple[int, ...]) -> "_Leaf":
        return _Leaf(self.store, self.li, self.slot, self.idx + idx)

    def get(self) -> torch.Tensor:
        return _gather(self.store, self.li, self.slot, self.idx)


class View(dict):
    """A params dict whose `Lazy` leaves are gathered when read."""

    def __getitem__(self, k):
        v = dict.__getitem__(self, k)
        return v.get() if isinstance(v, Lazy) else v

    def get(self, k, default=None):
        return self[k] if k in self else default

    def values(self):
        return [self[k] for k in self]

    def items(self):
        return [(k, self[k]) for k in self]


class _Stack(list):
    """Stacked layer leaves as a list of per-layer views: item i (or i, j)
    gathers layer i's leaves when they are read."""

    def __init__(self, node, depth: int, n: int):
        super().__init__(range(n))
        self._node, self._depth = node, depth

    def __getitem__(self, i):
        if isinstance(i, slice):
            raise TypeError("a stacked view is indexed one layer at a time")
        i = range(len(self))[i]
        node = _map(lambda leaf: leaf.at((i,)), self._node)
        if self._depth > 1:
            first = next(iter(_leaves(node)))
            return _Stack(node, self._depth - 1, first.n_stacked)
        return _wrap(node)

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def _map(fn, node):
    if isinstance(node, dict):
        return {k: _map(fn, v) for k, v in node.items()}
    return fn(node)


def _leaves(node):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _leaves(node[k])
    else:
        yield node


def _wrap(node):
    if isinstance(node, dict):
        return View({k: _wrap(v) for k, v in node.items()})
    return node


def gathered(store: ShardedStore, copy: Optional[int] = None):
    """The params tree the model reads from `store` (copy `copy` of a
    copy-axis store): a lazy view whose leaves are gathered whole when
    read and stacked layers one layer at a time (module doc)."""
    from ..models.transformer import STACKED
    slot = store.slot(copy)
    leaves = [_Leaf(store, li, slot)
              for li in range(len(store.global_spec.leaves))]
    tree = T.unflatten(store.global_spec.paths, leaves)
    out = View()
    for k, v in tree.items():
        if k in STACKED and isinstance(v, dict):
            first = next(iter(_leaves(v)))
            dict.__setitem__(out, k, _Stack(v, STACKED[k], first.n_stacked))
        else:
            dict.__setitem__(out, k, _wrap(v))
    return out


# -- rows and copies across ranks ----------------------------------------------

def row_split(n_rows: int, mesh, rules):
    """(row slice of this rank, batch axes, pieces) for a batch of `n_rows`
    under the "batch" rule (every row on every rank when it does not
    divide)."""
    from ..pshard import spec_for
    spec = spec_for((n_rows,), ("batch",), mesh, rules)
    axes = spec_axes(spec[0]) if spec else ()
    sl = shard_slices((n_rows,), spec, mesh, mesh.coords)[0]
    return sl, axes, mesh.group_size(axes) if axes else 1


def gather_rows(x: torch.Tensor, n_rows: int, sl: slice, axes, mesh):
    """The whole batch of which `x` is this rank's rows `sl`."""
    return replicate(x, (n_rows,) + tuple(x.shape[1:]),
                     (sl,) + tuple(slice(0, s) for s in x.shape[1:]),
                     axes, mesh)


def exchange_copies(x: torch.Tensor, copy: int, mesh,
                    copies: int = 3) -> List[torch.Tensor]:
    """The `copies` values of `x` across the copy axis of a folded mesh
    (this rank holds copy `copy`): each rank places its copy into a
    (copies, ...) zero stack, an exact SUM all-reduce over "copy"."""
    stack = torch.zeros((copies,) + tuple(x.shape), dtype=x.dtype,
                        device=x.device)
    stack[copy] = x
    w, copied = _as_int32(stack)
    mesh.all_reduce(w, ("copy",))
    if copied:
        stack.view(torch.int16).copy_(w.to(torch.int16))
    return [stack[i] for i in range(copies)]
