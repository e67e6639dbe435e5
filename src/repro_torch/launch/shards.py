"""A training state sharded over a process mesh: the reference's
`make_train_step(param_pspecs=...)` under `jax.jit` over NamedShardings,
one process a rank here.

**The plan** (`ShardPlan`).  For every leaf of the params: its global
shape, its params spec (`params.partition_specs`) and its moments spec
(`optim.sharding_rules.opt_spec_tree`, ZeRO-1: the largest dimension
whose logical axis counts as replicated is split over "zero", i.e. data),
both `pshard.spec_for` tuples on the mesh, and this rank's slice under
each (`pshard.shard_slices`).  A rank holds exactly those slices: the
params and the gradient accumulator by the params spec, `m` and `v` by
the moments spec.  A params spec never splits a stacked layer dim (its
logical axis is None), so a rank's shard of a stacked leaf is the stack
of its shards of each layer; a moments spec may split it.

**Exchanges** (`Exchange`).  Every transfer between ranks is an exact
all-gather over one group of mesh axes: each rank's tensor, copied bit
for bit to every rank of the group.  What a rank then sums, it sums in
the group's rank order, the same order on every rank, so a value that
several ranks compute from the same parts has the same bits on each.
Over nccl (a card a rank) and gloo on the CPU the gather is a
collective.  Where several ranks share one card (gloo over CUDA, whose
collectives stage through host memory at about 1 GB/s), each rank
instead posts its tensor into a staging buffer of its own that every
other rank mapped once through CUDA IPC, and reads its peers' buffers
device to device; inter-process CUDA events order the writes and reads
on the card and a host barrier orders the exchanges, so no exchange
syncs the host with the card (`Exchange`).

**The step** (`models.steps.make_train_step` with `param_pspecs` under
an ambient process mesh).  The model reads a lazy view of the params
(`model_view`): a leaf is gathered whole from its shard group when a
layer reads it, again in the layer's recompute in the backward, and
dropped after (FSDP over every sharded axis).  The gather is an autograd
function whose backward takes the whole leaf's grad from this rank's
rows, sums it over the ranks that hold the batch's other rows (in fp32,
group order) and returns this rank's slice in the params' dtype.  AdamW
then updates each rank's moments slice (`moment_part`) and rejoins the
params to their own spec (`rejoin`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..core import tree as T
from ..pshard import shard_slices, spec_axes
from .placement import Lazy, View

__all__ = ["Exchange", "ShardPlan", "plan_for", "exchange_for", "nested",
           "assemble", "global_shape", "model_view", "place_state",
           "state_shardings"]

Slices = Tuple[slice, ...]


def axes_of(spec: tuple) -> Tuple[str, ...]:
    """The mesh axes a spec splits any dimension over."""
    return tuple(a for e in spec for a in spec_axes(e))


def nested(outer: tuple, inner: tuple) -> bool:
    """Whether every rank's slice under `inner` lies inside its slice
    under `outer`: in every dimension, outer's axes begin inner's."""
    for d in range(max(len(outer), len(inner))):
        o = spec_axes(outer[d]) if d < len(outer) else ()
        i = spec_axes(inner[d]) if d < len(inner) else ()
        if i[:len(o)] != o:
            return False
    return True


def _rel(inner: Slices, outer: Slices) -> Slices:
    """`inner`'s slices relative to the start of `outer` (inner inside)."""
    return tuple(slice(a.start - b.start, a.stop - b.start)
                 for a, b in zip(inner, outer))


def _meet(a: Slices, b: Slices) -> Optional[Slices]:
    out = []
    for x, y in zip(a, b):
        lo, hi = max(x.start, y.start), min(x.stop, y.stop)
        if lo >= hi:
            return None
        out.append(slice(lo, hi))
    return tuple(out)


def _extent(sl: Slices) -> Tuple[int, ...]:
    return tuple(s.stop - s.start for s in sl)


class Exchange:
    """Exact all-gathers between the ranks of one mesh (module doc):
    collectives, or on a shared card the peers' staging buffers.

    On a shared card no exchange waits on the host for the card.  Each
    rank has two staging halves and, per half, two inter-process events:
    ``posted`` (recorded after its tensor is written into the half) and
    ``read`` (recorded after its reads of the peers' halves).  Exchange e
    writes half h = e % 2: the stream first waits for every peer's
    ``read[h]`` of exchange e - 2 (in any group; recorded before they met
    exchange e - 1's barrier), copies, records ``posted[h]``; the ranks
    meet at a host barrier; each stream then waits for its group's
    ``posted[h]`` before its reads, and records ``read[h]`` when the next
    exchange starts (after the caller's reads are enqueued)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.peer = bool(mesh.shares_card)
        self._mine: Optional[torch.Tensor] = None
        self._peers: Dict[int, torch.Tensor] = {}
        self._events = None        # own {"posted": [2], "read": [2]}
        self._peer_events: Dict[int, dict] = {}
        self._count = 0            # exchanges posted so far

    def _map(self, nbytes: int) -> None:
        """(Re)allocate this rank's two staging halves and map every
        peer's (with their events, once); collective, and every rank asks
        for the same size."""
        import torch.distributed as dist
        from torch.multiprocessing.reductions import reduce_tensor
        dev = self.mesh.device
        # nobody reads the old halves any more (they may stay allocated:
        # the peers mapped them and drop first, `launch.placement`)
        torch.cuda.synchronize(dev)
        self.mesh.barrier()
        self._peers = {}
        cap = -(-max(nbytes, 1) // (1 << 20)) << 20
        self._mine = torch.empty((2, cap), dtype=torch.uint8, device=dev)
        if self._events is None:
            self._events = {k: [torch.cuda.Event(interprocess=True)
                                for _ in range(2)]
                            for k in ("posted", "read")}
            for evs in self._events.values():
                for ev in evs:
                    ev.record()
        torch.cuda.synchronize(dev)
        mine = (reduce_tensor(self._mine),
                {k: [ev.ipc_handle() for ev in evs]
                 for k, evs in self._events.items()})
        handles = [None] * self.mesh.size
        dist.all_gather_object(handles, mine)
        for r, ((fn, args), evs) in enumerate(handles):
            if r == self.mesh.rank:
                continue
            self._peers[r] = fn(*args)
            if r not in self._peer_events:
                self._peer_events[r] = {
                    k: [torch.cuda.Event.from_ipc_handle(dev, h)
                        for h in hs] for k, hs in evs.items()}

    def _post(self, x: torch.Tensor, ranks: Sequence[int]) -> int:
        stream = torch.cuda.current_stream(x.device)
        if self._count:
            # every read of the previous exchange is enqueued by now
            self._events["read"][(self._count - 1) % 2].record(stream)
        nb = x.numel() * x.element_size()
        if self._mine is None or nb > self._mine.shape[1]:
            self._map(nb)
        h = self._count % 2
        self._count += 1
        # any rank may have read this half two exchanges ago, in any group
        for ev in self._peer_events.values():
            stream.wait_event(ev["read"][h])
        if nb:
            self._mine[h, :nb].view(x.dtype).copy_(x.reshape(-1))
        self._events["posted"][h].record(stream)
        self.mesh.barrier()
        for r in ranks:
            if r != self.mesh.rank:
                stream.wait_event(self._peer_events[r]["posted"][h])
        return h

    def parts(self, x: torch.Tensor,
              axes: Sequence[str]) -> List[Tuple[int, torch.Tensor]]:
        """(rank, that rank's `x`) for every rank of the group over `axes`
        in group order; every rank of the mesh calls it together, with a
        tensor of the same shape.  On a shared card a peer's tensor is a
        view of its staging buffer: read it before the next exchange."""
        mesh = self.mesh
        ranks = mesh.group_ranks(axes)
        if len(ranks) == 1:
            return [(mesh.rank, x)]
        if not self.peer:
            return list(zip(ranks, mesh.all_gather(x, axes)))
        x = x.contiguous()
        h = self._post(x, ranks)
        nb = x.numel() * x.element_size()
        return [(r, x if r == mesh.rank else
                 self._peers[r][h, :nb].view(x.dtype).view(x.shape))
                for r in ranks]

    def sum(self, x: torch.Tensor, axes: Sequence[str],
            sl: Optional[Slices] = None) -> torch.Tensor:
        """fp32 sum over the group of each rank's ``x[sl]``, in group
        order (a fresh tensor)."""
        acc = None
        for _, part in self.parts(x, axes):
            v = part if sl is None else part[sl]
            if acc is None:
                acc = v.to(torch.float32, copy=True)
            else:
                acc.add_(v)
        return acc


def global_shape(local: Sequence[int], spec: tuple, mesh) -> Tuple[int, ...]:
    """The whole leaf's shape of a shard of shape `local` under `spec`."""
    out = []
    for d, n in enumerate(local):
        k = 1
        for a in spec_axes(spec[d] if d < len(spec) else None):
            k *= mesh.shape[a]
        out.append(int(n) * k)
    return tuple(out)


def assemble(x: torch.Tensor, shape: Sequence[int], spec: tuple, mesh,
             idx: Tuple[int, ...] = ()) -> torch.Tensor:
    """The whole tensor (of `shape`; at leading index `idx`) of which `x`
    is this rank's shard under `spec`, from the ranks of its shard group;
    collective."""
    parts = exchange_for(mesh).parts(x, axes_of(spec))
    if len(parts) == 1:
        return x
    n = len(idx)
    full = torch.empty(tuple(shape)[n:], dtype=x.dtype, device=x.device)
    for r, part in parts:
        full[shard_slices(shape, spec, mesh, mesh.coords_of(r))[n:]] = part
    return full


def exchange_for(mesh) -> Exchange:
    """The mesh's one `Exchange` (made on first use)."""
    ex = getattr(mesh, "_exchange", None)
    if ex is None:
        ex = mesh._exchange = Exchange(mesh)
    return ex


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    shape: Tuple[int, ...]
    pspec: tuple
    mspec: tuple
    pslice: Slices
    mslice: Slices


class ShardPlan:
    """Every leaf's specs and this rank's slices (module doc) for a Spec
    tree on a process mesh under `rules`."""

    def __init__(self, specs: Any, mesh, rules=None):
        from ..models.params import partition_specs
        from ..optim.sharding_rules import opt_spec_tree
        self.mesh = mesh
        self.paths = T.paths(specs)
        self.pspecs = partition_specs(specs, mesh, rules)
        self.mspecs = partition_specs(opt_spec_tree(specs), mesh, rules)
        self.leaves = [
            LeafPlan(tuple(s.shape), p, m,
                     shard_slices(s.shape, p, mesh, mesh.coords),
                     shard_slices(s.shape, m, mesh, mesh.coords))
            for s, p, m in zip(T.leaves(specs), T.leaves(self.pspecs),
                               T.leaves(self.mspecs))]
        self.exchange = exchange_for(mesh)

    def _slices_of(self, shape, spec, rank: int) -> Slices:
        return shard_slices(shape, spec, self.mesh,
                            self.mesh.coords_of(rank))

    # -- the forward and backward --------------------------------------------
    def gather(self, i: int, x: torch.Tensor,
               idx: Tuple[int, ...] = ()) -> torch.Tensor:
        """Leaf i (layer `idx` of a stacked leaf) whole, from this rank's
        params shard `x` and its shard group's."""
        lp = self.leaves[i]
        return assemble(x, lp.shape, lp.pspec, self.mesh, idx)

    def reduce(self, i: int, g: torch.Tensor, axes: Sequence[str],
               idx: Tuple[int, ...] = (), dtype=None) -> torch.Tensor:
        """This rank's params slice of leaf i's grad (layer `idx`) from
        the whole grad `g` of every rank over the batch `axes`: summed in
        fp32 in group order, returned in `dtype` (default g's)."""
        sl = self.leaves[i].pslice[len(idx):]
        dtype = dtype or g.dtype
        if self.mesh.group_size(axes) <= 1:
            return g[sl].to(dtype)
        return self.exchange.sum(g, axes, sl).to(dtype)

    def batch_sum(self, axes: Sequence[str]):
        """``f(x) -> the sum over the batch `axes` of every rank's x`` in
        group order, the gradient flowing to this rank's own x (None for a
        group of one): `pshard.ambient_batch_sum`."""
        if self.mesh.group_size(axes) <= 1:
            return None

        def f(x):
            out = None
            for r, part in self.exchange.parts(x.detach(), axes):
                v = x if r == self.mesh.rank else part
                out = v if out is None else out + v
            return out

        return f

    # -- the update ------------------------------------------------------------
    def norm_sq(self, grads: Sequence[torch.Tensor],
                leaf_sq) -> torch.Tensor:
        """The sum of every grad element's square over the whole mesh
        (fp32, 0-d): `leaf_sq` of each leaf's shard counts once, on the
        holder at coordinate 0 of the axes its spec does not split; the
        per-leaf terms are gathered from every rank and added in rank
        order, then leaf by leaf in order (on a mesh of one rank, the
        one-process `optim.adamw.global_norm` to the bit)."""
        from ..optim.adamw import sum_in_order
        dev = grads[0].device if grads else self.mesh.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        terms = []
        for lp, g in zip(self.leaves, grads):
            split = axes_of(lp.pspec)
            held = not any(self.mesh.coords[a] for a in self.mesh.axis_names
                           if a not in split)
            terms.append(leaf_sq(g) if held else zero)
        vec = torch.stack(terms) if terms else zero.reshape(1)
        return sum_in_order(self.exchange.sum(vec, self.mesh.axis_names))

    def moment_part(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Leaf i's moments slice of a tensor held by the params spec
        (`x`: this rank's params shard): a view where the moments slice
        lies inside the params slice, else gathered from the params
        shard group."""
        lp = self.leaves[i]
        if nested(lp.pspec, lp.mspec):
            return x[_rel(lp.mslice, lp.pslice)]
        out = torch.empty(_extent(lp.mslice), dtype=x.dtype, device=x.device)
        for r, part in self.exchange.parts(x, axes_of(lp.pspec)):
            src = self._slices_of(lp.shape, lp.pspec, r)
            meet = _meet(src, lp.mslice)
            if meet is not None:
                out[_rel(meet, lp.mslice)] = part[_rel(meet, src)]
        return out

    def rejoin(self, i: int, x: torch.Tensor, part: torch.Tensor) -> None:
        """`x` (this rank's params shard of leaf i) := the params spec's
        slice of every rank's updated moments slice (`part`, this rank's;
        a view of x where `moment_part` gave one)."""
        lp = self.leaves[i]
        if nested(lp.pspec, lp.mspec) and nested(lp.mspec, lp.pspec):
            return                              # updated in place
        if nested(lp.mspec, lp.pspec):          # params slice inside
            x.copy_(part[_rel(lp.pslice, lp.mslice)])
            return
        inside = nested(lp.pspec, lp.mspec)
        pax = axes_of(lp.pspec)
        # inside: the ranks splitting this rank's params slice further
        axes = tuple(a for a in axes_of(lp.mspec)
                     if not (inside and a in pax))
        for r, p in self.exchange.parts(part.contiguous(), axes):
            if inside and r == self.mesh.rank:
                continue                        # already in place
            src = self._slices_of(lp.shape, lp.mspec, r)
            meet = _meet(src, lp.pslice)
            if meet is not None:
                x[_rel(meet, lp.pslice)] = p[_rel(meet, src)]

    # -- placing and saving ------------------------------------------------------
    def take(self, i: int, full: torch.Tensor, moments: bool = False,
             dtype=None, device=None) -> torch.Tensor:
        """This rank's own copy of its slice of a whole leaf."""
        lp = self.leaves[i]
        part = full[lp.mslice if moments else lp.pslice]
        return part.to(device=device or part.device,
                       dtype=dtype or part.dtype, copy=True).contiguous()

    def held(self) -> Dict[str, int]:
        """Elements of the params, of one moment and of the accumulator
        this rank holds."""
        p = sum(_numel(_extent(lp.pslice)) for lp in self.leaves)
        m = sum(_numel(_extent(lp.mslice)) for lp in self.leaves)
        return {"params": p, "m": m, "v": m, "acc": p}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def plan_for(cfg, mesh, rules=None) -> ShardPlan:
    """The `ShardPlan` of `cfg`'s params on `mesh` under `rules` (one a
    mesh, config and rules)."""
    from ..models.transformer import model_specs
    from ..pshard import DEFAULT_RULES
    rules = rules if rules is not None else DEFAULT_RULES
    cache = mesh.__dict__.setdefault("_plans", {})
    key = (cfg, tuple(sorted(rules.table.items())))
    if key not in cache:
        cache[key] = ShardPlan(model_specs(cfg), mesh, rules)
    return cache[key]


class _Gather(torch.autograd.Function):
    """Forward: a params shard -> the whole leaf (in `up` when given).
    Backward: the whole leaf's grad from this rank's rows -> this rank's
    slice of the batch's grad in the shard's dtype (`ShardPlan.reduce`)."""

    @staticmethod
    def forward(ctx, local, plan, i, idx, axes, up):
        ctx.plan, ctx.i, ctx.idx, ctx.axes = plan, i, idx, axes
        ctx.dtype = local.dtype
        full = plan.gather(i, local, idx)
        if up is not None:
            return full.to(up)
        return local.view_as(local) if full is local else full

    @staticmethod
    def backward(ctx, g):
        return (ctx.plan.reduce(ctx.i, g.contiguous(), ctx.axes, ctx.idx,
                                ctx.dtype),
                None, None, None, None, None)


class _Shard(Lazy):
    __slots__ = ("alias", "plan", "i", "idx", "axes", "up")

    def __init__(self, alias, plan, i, idx, axes, up):
        self.alias, self.plan, self.i = alias, plan, i
        self.idx, self.axes, self.up = idx, axes, up

    def get(self) -> torch.Tensor:
        return _Gather.apply(self.alias, self.plan, self.i, self.idx,
                             self.axes, self.up)


def model_view(params: Any, grads: Any, plan: ShardPlan,
               axes: Sequence[str], compute_dtype=None) -> View:
    """The params tree the model reads in one sharded backward: per
    leaf (per layer of a stacked key, `transformer.STACKED`) an alias of
    this rank's shard that requires grad, whose ``.grad`` is the matching
    view of `grads` (so the grads land there in place), read through a
    gather (module doc); `axes` are the batch axes its grad is summed
    over.  A bf16 leaf under an fp32 `compute_dtype` is handed to the
    model in fp32, the dtype the model casts it to: its grad from this
    rank's rows then reaches the sum over the batch axes unrounded and is
    rounded to bf16 once, as a one-device step rounds the batch's."""
    from ..models.transformer import STACKED
    flat_p, flat_g = T.leaves(params), T.leaves(grads)
    if T.paths(params) != plan.paths:
        raise ValueError("the params tree is not the plan's")
    index = T.unflatten(plan.paths, list(range(len(flat_p))))

    def leaf(i, idx):
        a = flat_p[i][idx].detach().requires_grad_()
        a.grad = flat_g[i][idx]
        up = (compute_dtype if a.is_floating_point()
              and a.element_size() < torch.finfo(compute_dtype).bits // 8
              else None) if compute_dtype is not None else None
        return _Shard(a, plan, i, idx, tuple(axes), up)

    def wrap(node, idx):
        if isinstance(node, dict):
            return View({k: wrap(v, idx) for k, v in node.items()})
        return leaf(node, idx)

    def split(node, depth, idx):
        if depth == 0:
            return wrap(node, idx)
        first = T.leaves(node)[0] if isinstance(node, dict) else node
        n = plan.leaves[first].shape[len(idx)]
        return [split(node, depth - 1, idx + (j,)) for j in range(n)]

    return View({k: split(v, STACKED.get(k, 0), ())
                 for k, v in index.items()})


def place_state(params: Any, plan: ShardPlan, param_dtype=torch.float32,
                opt_dtype=torch.float32, device=None) -> dict:
    """This rank's training state from whole params (every rank the same
    tree): its params slices in `param_dtype`, zero `m` and `v` on its
    moments slices in `opt_dtype`, a 0-d int32 count, on `device`
    (default: the params')."""
    flat = T.leaves(params)
    if T.paths(params) != plan.paths:
        raise ValueError("the params tree is not the plan's")
    dev = torch.device(device) if device is not None else flat[0].device

    def zeros(i):
        return torch.zeros(_extent(plan.leaves[i].mslice), dtype=opt_dtype,
                           device=dev)

    return {"params": T.unflatten(plan.paths, [
                plan.take(i, x, dtype=param_dtype, device=dev)
                for i, x in enumerate(flat)]),
            "opt": {"m": T.unflatten(plan.paths,
                                     [zeros(i) for i in range(len(flat))]),
                    "v": T.unflatten(plan.paths,
                                     [zeros(i) for i in range(len(flat))]),
                    "count": torch.zeros((), dtype=torch.int32, device=dev)}}


def state_shardings(plan: ShardPlan) -> dict:
    """The spec tuple of every leaf of `place_state`'s state (None: the
    count, whole on every rank), for `Checkpointer.save(shardings=)` and
    `checkpoint.restore_resharded`."""
    return {"params": plan.pspecs,
            "opt": {"m": plan.mspecs, "v": plan.mspecs, "count": None}}
