"""The serving store on a process mesh (DESIGN.md §14): how `prepare`
builds each rank's shard, and how the model reads a sharded store.

**Placement.**  Every leaf is placed as `pshard.spec_for` resolves its
logical axes on the engine's exec mesh (FSDP ``model_dim`` over data,
``ff``/``heads``/``vocab`` over model, ``expert`` over model or, under a
config's serving rules, data; small or odd dims replicated): a rank holds
exactly its slice of every leaf (`pshard.shard_slices`), packed into a
local arena of its own.  TMR copies ride the "copy" axis of a folded mesh
(each copy group holds one copy) and are held by every rank otherwise
(`optim.sharding_rules.copy_stack_pspec`).

**The build plan** (`build_store`).  No rank holds the whole clean arena
or a whole working copy (unless its slice of every leaf is the whole
leaf).  The clean arena comes from a source that fills any word range: a
`KeyedParams` (a `core.prng` key, every draw a function of the leaf's key
and the flat index, `params.fill_range`) or a `WholeArena` already in
hand.  Rank r of the scrub group (the mesh axes a copy's block range is
split over: every axis but a folded copy axis) owns the contiguous block
range ``[lo, hi)`` of the global arena (`kernels.sharded.block_range`);
copy by copy, in the unmeshed order, it

1. fills its range from the source;
2. under an ECC scheme, encodes the range's parity (once, from the first
   clean range it fills);
3. applies the faults that land in its range: the fault model draws the
   whole copy's faults from the run's generator in order and keeps what
   falls in the range (`FaultModel.corrupt_range`; a copy this rank does
   not hold is drawn and dropped), so no draw depends on rank or world
   size;
4. under an ECC scheme, scrubs the range with the kernel
   (`kernels.sharded.scrub_range`: counts summed over the scrub group);
5. sends each word of its range to the ranks whose leaf slices hold it
   (`_redistribute`): an exact all-gather of equal pieces of every rank's
   range, `STEP` words a rank at a time (`launch.shards.Exchange`: where
   the ranks share a card, through staging buffers they mapped once),
   from which each rank keeps what its slices hold.

The scrub counts are summed over the remaining axes (a folded mesh's copy
axis) once, at the end.  At its peak a rank holds its local arena, one
range, the range's parity and the gather's pieces.  When the scrub group
is one rank its range is the whole arena and IS the local arena; with
``donate`` (a `WholeArena`, one held copy) that is the caller's arena
itself.

**Reading** (`gathered`).  The model gets a lazy view of a store: a leaf
is gathered when the layer reads it -- the explicit redistribute
(Shard -> Replicate) that DTensor's ``full_tensor()`` would do -- and
dropped after, except along its kept dimensions (``keep``: the engine
keeps `local_dims`, every dimension split over mesh axes no batch axis
shares -- heads, KV heads, ff, vocab on model -- and a MoE leaf's
``expert`` dimension): there the layer gets this rank's slice alone and
computes it where it lives (`models.moe` expert parallelism, the column-
and row-parallel products of `models.nn` / `models.attention` /
`models.steps`).  Stacked layer leaves are gathered one layer at a time,
so a rank holds its shards plus the leaves of the layer it runs (FSDP
over what is left).  The gather is an int32 SUM all-reduce of this
rank's slice placed into zeros (exact on every backend: gloo has no
all-gather for CUDA tensors), except where several ranks share one card
(gloo over
CUDA, whose collectives stage through host memory): there each rank
posts its slice to the staging buffer its peers mapped once a mesh and
reads theirs device to device (`launch.shards.Exchange`).  No peer maps
a store's arena: a tensor that peers mapped through CUDA IPC stayed
allocated on its owner after every side dropped it and the IPC memory
was collected, on every rank where the peers dropped first, and on two
ranks of four where the owner dropped first (`tools/ipc_release.py`:
PyTorch 2.11, four ranks of an H100).  No order freed it on every rank,
so a dropped store could stay on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..core import arena, prng
from ..core import tree as T
from ..kernels.sharded import BLOCK, block_range, scrub_range
from ..pshard import shard_slices, spec_axes

__all__ = ["ShardedStore", "WholeArena", "KeyedParams", "build_store",
           "place_store", "empty_store", "expert_dims", "local_dims",
           "gathered", "replicate", "LargestAllocation",
           "LeafReads",
           "exchange_copies", "row_split", "gather_rows", "local_elements"]

#: words a rank contributes to each all-gather of `_redistribute`
STEP = 1 << 26


@dataclasses.dataclass
class ShardedStore:
    """One rank's part of a serving store (module doc).

    words  : the local arena, (n_words,) or (C, n_words) int32 with
             C = len(held): this rank's slice of every leaf.
    spec   : its layout; `global_spec` the unsharded arena's.
    specs  : per-copy `spec_for` tuple of every leaf, flatten order.
    held   : the copy indices this rank holds, or None (no copy axis).
    mesh   : the exec mesh the store is placed on.
    keep   : per leaf, the dimensions `gathered` does not gather (this
             rank's slice along them is what the model reads).
    """

    words: torch.Tensor
    spec: arena.ArenaSpec
    global_spec: arena.ArenaSpec
    specs: List[tuple]
    held: Optional[Tuple[int, ...]]
    mesh: Any
    keep: List[Tuple[int, ...]] = dataclasses.field(default_factory=list)

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


def expert_dims(tree: Any) -> List[Tuple[int, ...]]:
    """Per leaf of a Spec tree (flatten order), the dimensions whose
    logical axis is ``expert``: the ``keep`` under which a MoE layer's
    experts are computed where they live."""
    return [tuple(d for d, a in enumerate(s.axes) if a == "expert")
            for s in T.leaves(tree)]


#: the keys under which a serving rank still reads its leaves gathered
#: whole (but their experts): cross-attention's, and the RG-LRU's
#: (``temporal``); an SSM family's every leaf
GATHERED = ("xattn", "temporal")


def local_dims(cfg, mesh, rules) -> List[Tuple[int, ...]]:
    """Per leaf of `cfg`'s params (flatten order), the dimensions a
    serving rank keeps local and computes where they live on `mesh` under
    `rules`: every dimension split over a group of more than one rank
    whose mesh axes are disjoint from the batch's (``heads``,
    ``kv_heads``, ``ff``, ``vocab`` on ``model``; FSDP's ``model_dim``
    over data stays gathered), and the expert dimensions -- but only the
    expert dimensions of the `GATHERED` leaves and of an SSM."""
    from ..models.params import partition_specs
    from ..models.transformer import model_specs
    specs = model_specs(cfg)
    batch = set(rules.axes_for("batch"))
    out = []
    for path, s, spec, experts in zip(
            T.paths(specs), T.leaves(specs),
            T.leaves(partition_specs(specs, mesh, rules)),
            expert_dims(specs)):
        if cfg.family == "ssm" or set(path) & set(GATHERED):
            out.append(experts)
            continue
        out.append(tuple(
            d for d, e in enumerate(spec) if d in experts or (
                spec_axes(e) and not set(spec_axes(e)) & batch
                and math.prod(mesh.shape[a] for a in spec_axes(e)) > 1)))
    return out


# -- the clean arena's sources ---------------------------------------------------

class WholeArena:
    """A clean arena already in hand: its (n_words,) int32 words."""

    def __init__(self, words: torch.Tensor):
        self.words = words
        self.device = words.device

    def fill(self, out: torch.Tensor, lo: int) -> None:
        """out := words [lo, lo + out.numel())."""
        out.copy_(self.words[lo:lo + out.numel()])


class KeyedParams:
    """The parameters `params.materialize(tree, key, dtype)` draws, never
    drawn whole: `fill` draws any word range alone (`params.fill_range`).
    `spec` is the arena's layout, `materialize()` the whole arena (one
    process's reference)."""

    words = None

    def __init__(self, tree: Any, key: torch.Tensor, dtype: Any = "float32",
                 device=None):
        from ..models.params import layout
        if not prng.is_key(key):
            raise TypeError("KeyedParams draws from a core.prng key")
        self.tree, self.dtype = tree, dtype
        self.device = torch.device(device) if device is not None \
            else key.device
        self.key = key.to(self.device)
        self.spec = layout(tree, dtype)

    def fill(self, out: torch.Tensor, lo: int) -> None:
        from ..models.params import fill_range
        fill_range(self.tree, self.key, out, lo, self.dtype)

    def materialize(self) -> Any:
        from ..models.params import materialize
        return materialize(self.tree, self.key, self.dtype, self.device)


class LargestAllocation(TorchDispatchMode):
    """A dispatch mode that records, in ``bytes``, the largest storage
    any op allocates while it is active (outputs that share an input's
    storage -- views, in-place ops -- allocate nothing): what a build
    holds at most in one tensor."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {x.untyped_storage().data_ptr()
                for x in _tensors((args, kwargs))}
        for x in _tensors(out):
            st = x.untyped_storage()
            if st.data_ptr() not in seen:
                self._allocated(st.nbytes())
        return out

    def _allocated(self, nbytes: int) -> None:
        self.bytes = max(self.bytes, nbytes)


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


#: the `LeafReads` that are recording
_READS: list = []


class LeafReads(LargestAllocation):
    """`LargestAllocation` by leaf read: ``reads`` lists, for every leaf a
    model reads from a store (`gathered`) while it is active, [leaf index,
    the shape read, the largest storage allocated from the start of that
    read to the start of the next] -- what a rank materializes of each
    leaf, and at most while it computes with it."""

    def __init__(self):
        super().__init__()
        self.reads: List[list] = []

    def __enter__(self):
        _READS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _READS.remove(self)
        return super().__exit__(*exc)

    def _allocated(self, nbytes: int) -> None:
        super()._allocated(nbytes)
        if self.reads:
            self.reads[-1][2] = max(self.reads[-1][2], nbytes)


# -- the build ------------------------------------------------------------------

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


def _store(local: torch.Tensor, lspec, global_spec, specs, mesh, held,
           keep=None):
    """The ShardedStore over a (C, n) local arena (C = 1 without a copy
    axis)."""
    words = local.view(-1) if held is None else local
    keep = list(keep) if keep is not None else [()] * len(specs)
    return ShardedStore(words=words, spec=lspec, global_spec=global_spec,
                        specs=list(specs),
                        held=None if held is None else tuple(held),
                        mesh=mesh, keep=keep)


def copy_source(generator, i: int):
    """Copy i's fault source when a store is built: the one generator,
    drawn in copy order, or ``fold_in(key, 100 + i)`` for a `core.prng`
    key (the reference engine's convention)."""
    if prng.is_key(generator):
        return prng.fold_in(generator, 100 + i)
    return generator


def build_store(source, global_spec: arena.ArenaSpec,
                specs: Sequence[tuple], mesh, *, copies: int,
                held: Optional[Tuple[int, ...]], fault=None,
                generator: Optional[torch.Generator] = None,
                dt: float = 1.0, ecc=None, scrub_axes: Sequence[str] = (),
                donate: bool = False, keep=None):
    """This rank's `ShardedStore` of `copies` corrupted (and, with `ecc`,
    scrubbed) copies of the clean arena of `source` (a `KeyedParams` or a
    `WholeArena`), by the plan of the module doc.
    `scrub_axes`: the mesh axes each copy's block range is split over;
    `keep`: per leaf, the dimensions `gathered` leaves local.  Returns
    (store, counts (3,) int32 summed over the mesh, or None without
    `ecc`)."""
    dev = source.device
    slices, lspec = _layout(global_spec, specs, mesh)
    held_set = (0,) if held is None else held
    n = mesh.group_size(scrub_axes)
    lo, hi = block_range(global_spec.n_blocks, n, mesh.index_in(scrub_axes))
    whole = n <= 1                      # the range is the whole arena
    if whole and len(held_set) == 1 and source.words is not None and \
            (donate or (fault is None and ecc is None)):
        local = source.words.view(1, -1)    # the caller's arena is the store
    else:
        local = torch.zeros((len(held_set), lspec.n_words),
                            dtype=torch.int32, device=dev)
    rng = None if whole else torch.empty((hi - lo) * BLOCK,
                                         dtype=torch.int32, device=dev)
    parity = total = None
    if ecc is not None:
        total = torch.zeros(3, dtype=torch.int32, device=dev)
    for j in range(copies):
        if j not in held_set:
            if fault is not None:       # drawn and dropped
                fault.corrupt_range(local[0, :0], global_spec, 0,
                                    copy_source(generator, j), dt)
            continue
        slot = held_set.index(j)
        buf = local[slot] if whole else rng
        if buf.data_ptr() != (source.words.data_ptr()
                              if source.words is not None else -1):
            source.fill(buf, lo * BLOCK)
        if ecc is not None and parity is None:
            parity = ecc.encode_arena(buf)
        if fault is not None:
            fault.corrupt_range(buf, global_spec, lo * BLOCK,
                                copy_source(generator, j), dt)
        if ecc is not None:
            fixed, _, counts = scrub_range(ecc.scrub_arena, mesh, scrub_axes,
                                           buf, parity.clone())
            if fixed.data_ptr() != buf.data_ptr():
                buf.copy_(fixed)
            total += counts
        if not whole:
            _redistribute(rng, lo * BLOCK, global_spec, local[slot], lspec,
                          slices, mesh, scrub_axes)
    del rng
    if total is not None:
        # summed over the scrub group by each scrub; the other axes (the
        # copy axis of a folded mesh) add the other copies' counts
        total = mesh.all_reduce(total, tuple(
            a for a in mesh.axis_names if a not in scrub_axes))
    return _store(local, lspec, global_spec, specs, mesh, held, keep), total


def _boxes(shape: Tuple[int, ...], a: int, b: int, at: int = 0):
    """The flat element range [a, b) of a `shape` tensor as contiguous
    boxes: (flat offset, a slice per dimension), in flat order."""
    if a >= b:
        return []
    if not shape:
        return [(at, ())]
    inner = math.prod(shape[1:])
    i0, r0 = divmod(a, inner)
    i1, r1 = divmod(b, inner)
    rest = tuple(slice(0, s) for s in shape[1:])
    out = []
    if r0:
        stop = r1 if i1 == i0 else inner
        out += [(o, (slice(i0, i0 + 1),) + sl) for o, sl in
                _boxes(shape[1:], r0, stop, at + i0 * inner)]
        if i1 == i0:
            return out
        i0 += 1
    if i1 > i0:
        out.append((at + i0 * inner, (slice(i0, i1),) + rest))
    if r1:
        out += [(o, (slice(i1, i1 + 1),) + sl) for o, sl in
                _boxes(shape[1:], 0, r1, at + i1 * inner)]
    return out


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The same-width integer view of a leaf (exact copies of any bits)."""
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def _scatter(piece: torch.Tensor, g0: int, global_spec, dst: torch.Tensor,
             lspec, slices) -> None:
    """dst's leaves := what of this rank's slices lies in `piece`, the
    global arena's words [g0, g0 + piece.numel())."""
    g1 = g0 + piece.numel()
    for leaf, ll, sl in zip(global_spec.leaves, lspec.leaves, slices):
        a = min(max(g0 - leaf.offset, 0), leaf.n_words)
        b = min(max(g1 - leaf.offset, a), leaf.n_words)
        if a == b:
            continue
        n = math.prod(leaf.shape)
        w = piece[leaf.offset + a - g0:leaf.offset + b - g0]
        if leaf.dtype == torch.bfloat16:
            e0, e1 = 2 * a, min(2 * b, n)
            src = w.view(torch.int16)[:e1 - e0]
        else:
            e0, e1, src = a, b, w
        out = _bits(arena.words_to_leaf(
            dst[ll.offset:ll.offset + ll.n_words], ll))
        for off, box in _boxes(leaf.shape, e0, e1):
            meet = tuple(slice(max(x.start, y.start), min(x.stop, y.stop))
                         for x, y in zip(box, sl))
            if any(m.start >= m.stop for m in meet):
                continue
            ext = tuple(x.stop - x.start for x in box)
            part = src[off - e0:off - e0 + math.prod(ext)].view(ext)
            out[tuple(slice(m.start - y.start, m.stop - y.start)
                      for m, y in zip(meet, sl))] = part[tuple(
                          slice(m.start - x.start, m.stop - x.start)
                          for m, x in zip(meet, box))]


def _redistribute(rng: torch.Tensor, w0: int, global_spec, dst, lspec,
                  slices, mesh, axes) -> None:
    """Every rank of the scrub group (`axes`) sends each word of its range
    (`rng`, from global word `w0`) to the ranks whose slices hold it: an
    exact all-gather (`shards.Exchange`: a collective, or on a shared card
    the peers' staging buffers) of `STEP`-word pieces of every range, from
    which each rank keeps what its slices hold."""
    from .shards import exchange_for
    n = mesh.group_size(axes)
    per = -(-global_spec.n_blocks // n) * BLOCK
    starts = [min(global_spec.n_words, i * per) for i in range(n)]
    sizes = [min(global_spec.n_words, s + per) - s for s in starts]
    step = min(STEP, per)
    piece = torch.zeros(step, dtype=torch.int32, device=rng.device)
    ex = exchange_for(mesh)
    for k in range(0, per, step):
        m = max(0, min(step, rng.numel() - k))
        piece[:m] = rng[k:k + m]
        piece[m:] = 0
        for i, (_, got) in enumerate(ex.parts(piece, axes)):
            c = max(0, min(step, sizes[i] - k))
            _scatter(got[:c], starts[i] + k, global_spec, dst, lspec,
                     slices)


def place_store(words: torch.Tensor, global_spec: arena.ArenaSpec,
                specs: Sequence[tuple], mesh,
                held: Optional[Tuple[int, ...]], keep=None) -> ShardedStore:
    """Place an already built store -- `words` (n_words,) or (3, n_words)
    -- on `mesh`: this rank's slices of the copies it holds, nothing drawn
    or scrubbed (a checkpoint restore, an externally built store)."""
    slices, lspec = _layout(global_spec, specs, mesh)
    rows = [words] if held is None else [words[j] for j in held]
    local = torch.zeros((len(rows), lspec.n_words), dtype=torch.int32,
                        device=words.device)
    for slot, row in enumerate(rows):
        _keep_slices(local[slot], lspec, row, global_spec, slices)
    return _store(local, lspec, global_spec, specs, mesh, held, keep)


def empty_store(global_spec: arena.ArenaSpec, specs: Sequence[tuple], mesh,
                held: Optional[Tuple[int, ...]], device=None,
                keep=None) -> ShardedStore:
    """A store of this rank's layout whose words are not set (the dry
    run's, on ``meta``: nothing is drawn, scrubbed or allocated)."""
    _, lspec = _layout(global_spec, specs, mesh)
    local = torch.empty((1 if held is None else len(held), lspec.n_words),
                        dtype=torch.int32, device=device or mesh.device)
    return _store(local, lspec, global_spec, specs, mesh, held, keep)


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


def _gather_axes(store: ShardedStore, li: int) -> Tuple[str, ...]:
    """The mesh axes leaf `li` is gathered over: those of every sharded
    dimension but its kept ones."""
    keep = store.keep[li] if store.keep else ()
    return tuple(a for d, e in enumerate(store.specs[li]) if d not in keep
                 for a in spec_axes(e))


def _gather(store: ShardedStore, li: int, slot: Optional[int],
            idx: Tuple[int, ...]) -> torch.Tensor:
    """Leaf `li` (at stacked index `idx`) from the ranks of its shard
    group: whole, but along its kept dimensions, where it stays this
    rank's slice."""
    mesh, spec = store.mesh, store.specs[li]
    shape = store.global_spec.leaves[li].shape
    local = _leaf_view(store.words, store.spec, li, slot)[idx]
    keep = store.keep[li] if store.keep else ()
    axes = _gather_axes(store, li)
    if not axes or mesh.group_size(axes) <= 1:
        return local
    n = len(idx)

    def placed(coords):
        # the slice of a rank at `coords` in the gathered tensor: its own
        # along the gathered dimensions, all of this rank's along the kept
        sl = shard_slices(shape, spec, mesh, coords)
        return tuple(slice(0, local.shape[d - n]) if d in keep else x
                     for d, x in enumerate(sl))[n:]

    full_shape = tuple(local.shape[d - n] if d in keep else shape[d]
                       for d in range(n, len(shape)))
    if not mesh.shares_card:
        return replicate(local, full_shape, placed(mesh.coords), axes, mesh)
    from .shards import exchange_for
    full = torch.empty(full_shape, dtype=local.dtype, device=local.device)
    for r, src in exchange_for(mesh).parts(local.contiguous(), axes):
        full[placed(mesh.coords_of(r))] = src
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
        for r in _READS:
            r.reads.append([self.li, None, 0])
        x = _gather(self.store, self.li, self.slot, self.idx)
        for r in _READS:
            r.reads[-1][1] = tuple(x.shape)
        return x


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
    copy-axis store): a lazy view whose leaves are gathered when read --
    whole, but along their kept dimensions -- and stacked layers one layer
    at a time (module doc)."""
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
