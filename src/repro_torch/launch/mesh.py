"""Process meshes on `torch.distributed` (port of `repro.launch.mesh`).

The reference runs one controller over a device mesh; the port runs one
process per mesh position, as PyTorch does.  A `Mesh` is this process's
view of a ("data", "model") or ("copy", "data", "model") grid of ranks
(rank = row-major position): the axis names and sizes, this rank's
coordinates, a `DeviceMesh` (`init_device_mesh`) for DTensor placements,
and one process group for every set of axes, built once when the mesh is
made (a collective call, as every group creation is).

`spawn` starts a mesh's ranks: under ``torchrun`` it joins the given
world; otherwise it starts ``data * model`` processes itself (start method
``spawn``) that meet through a `FileStore` in a fresh temporary directory
(never a fixed TCP port, so concurrent runs cannot collide).  The backend
is ``nccl`` when every rank has a card of its own and ``gloo`` otherwise
(on the CPU, or several ranks on one card); either way every rank runs on
the device the caller asked for.

`fold_copy_axis` is the serving engine's replica-group trick (DESIGN.md
§14): a ("data", "model") mesh whose data axis divides by the TMR copy
count reshapes into ("copy", "data", "model") over the same ranks, so the
three copies land on three disjoint groups of data replicas.

`RecordingMesh` is one rank of a mesh with no processes behind it (the
dry run, `launch.dryrun`): it answers what a `Mesh` answers about ranks
and groups, runs on the ``meta`` device, and its collectives append
(op, result bytes, group size) to its log and return ``meta`` tensors of
the right shape; they move no data.  `collective_log` records the same
triples for the collectives a real `Mesh` issues.
"""
from __future__ import annotations

import contextlib
import datetime
import faulthandler
import itertools
import os
import pickle
import sys
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..pshard import AbstractMesh

__all__ = ["Mesh", "RecordingMesh", "make_production_mesh", "make_test_mesh",
           "make_tmr_serving_mesh", "fold_copy_axis", "require_devices",
           "spawn", "backend_for", "parse_mesh", "collectives_issued",
           "collective_log"]

#: collective timeout: a rank that died leaves the others waiting this
#: long at most
TIMEOUT = datetime.timedelta(seconds=600)


def _dist():
    import torch.distributed as dist
    return dist


class _Ranks:
    """What a mesh answers about its ranks from its ``axis_names``,
    ``sizes`` and this rank's ``coords`` (row-major positions)."""

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def describe(self) -> str:
        return "x".join(f"{a}={s}" for a, s in zip(self.axis_names,
                                                    self.sizes))

    def _axes(self, axes: Sequence[str]) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names if a in tuple(axes))

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The mesh coordinates of `rank`."""
        out = {}
        for name, s in reversed(list(zip(self.axis_names, self.sizes))):
            out[name] = rank % s
            rank //= s
        return {a: out[a] for a in self.axis_names}

    def group_size(self, axes: Sequence[str]) -> int:
        return _prod(self.shape[a] for a in self._axes(axes))

    def index_in(self, axes: Sequence[str]) -> int:
        """This rank's row-major position among the ranks of `group(axes)`."""
        k = 0
        for a in self._axes(axes):
            k = k * self.shape[a] + self.coords[a]
        return k


class Mesh(_Ranks):
    """This process's view of a mesh of ranks (module doc).  Collective to
    construct: every rank of the world builds the same mesh at the same
    point."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str],
                 device: torch.device):
        dist = _dist()
        self.sizes = tuple(int(s) for s in sizes)
        self.axis_names = tuple(axis_names)
        self.device = torch.device(device)
        n = 1
        for s in self.sizes:
            n *= s
        if not dist.is_initialized() or dist.get_world_size() != n:
            have = dist.get_world_size() if dist.is_initialized() else 0
            raise ValueError(f"mesh {'x'.join(map(str, self.sizes))} needs "
                             f"a world of {n} ranks, this one has {have}")
        self.rank = dist.get_rank()
        self.size = n
        self.coords = self.coords_of(self.rank)
        # every mesh here spans the whole world in row-major rank order
        from torch.distributed.device_mesh import init_device_mesh
        self.device_mesh = init_device_mesh(
            self.device.type, self.sizes, mesh_dim_names=self.axis_names)
        # one group per non-empty set of axes (in mesh order): the ranks
        # that differ from this one only along those axes
        self._groups: Dict[Tuple[str, ...], Any] = {}
        self._ranks: Dict[Tuple[str, ...], Tuple[int, ...]] = {}
        grid = torch.arange(n).reshape(self.sizes)
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                dims = [self.axis_names.index(a) for a in axes]
                rest = [d for d in range(len(self.sizes)) if d not in dims]
                moved = grid.permute(*rest, *dims).reshape(-1, _prod(
                    self.sizes[d] for d in dims))
                for ranks in moved.tolist():
                    g = dist.new_group(ranks, timeout=TIMEOUT)
                    if self.rank in ranks:
                        self._groups[axes] = g
                        self._ranks[axes] = tuple(ranks)
        self._folded = None

    def group(self, axes: Sequence[str]):
        """The process group of this rank over `axes` (None for no axes:
        nothing to reduce over)."""
        axes = self._axes(axes)
        return self._groups[axes] if axes else None

    def group_ranks(self, axes: Sequence[str]) -> Tuple[int, ...]:
        """The ranks of `group(axes)`, in their row-major order."""
        axes = self._axes(axes)
        return self._ranks[axes] if axes else (self.rank,)

    @property
    def shares_card(self) -> bool:
        """Several ranks on one card (the gloo case): their arenas can be
        read from each other directly (`launch.placement`)."""
        return (self.device.type == "cuda" and self.size > 1
                and _dist().get_backend() == "gloo")

    def all_gather(self, x: torch.Tensor,
                   axes: Sequence[str]) -> List[torch.Tensor]:
        """Every rank's `x` over the ranks of `axes`, in `group_ranks`
        order: exact copies (``[x]`` over none or a group of one)."""
        if self.group_size(axes) <= 1:
            return [x]
        x = x.contiguous()
        n = self.group_size(axes)
        out = [torch.empty_like(x) for _ in range(n)]
        _dist().all_gather(out, x, group=self.group(axes))
        _note("all-gather", n * _nbytes(x), n)
        return out

    def barrier(self) -> None:
        """Wait for every rank of the mesh (a group of one waits for none)."""
        if self.size > 1:
            _dist().barrier(group=self.group(self.axis_names))
            _note("barrier", 0, self.size)

    def all_reduce(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """SUM `x` in place over the ranks of `axes` (a no-op over none or
        a group of one); returns x."""
        n = self.group_size(axes)
        if n > 1:
            _dist().all_reduce(x, group=self.group(axes))
            _note("all-reduce", _nbytes(x), n)
        return x


class RecordingMesh(_Ranks, AbstractMesh):
    """Rank `rank` of a `sizes` mesh with no processes (module doc): the
    surface of `Mesh` that the training step and the engine use, on the
    ``meta`` device.  Its collectives append (op, result bytes, group
    size) to `log` and return ``meta`` tensors; a folded copy
    (`fold_copy_axis`) keeps the rank and the log.  An all-gather
    allocates every rank's tensor, as a card a rank does; with
    `peer_views` it returns this rank's own and views of memory it does
    not allocate, as ranks sharing one card read their peers' staging
    (`shards.Exchange`)."""

    shares_card = False

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str],
                 rank: int = 0, log: Optional[list] = None,
                 peer_views: bool = False):
        super().__init__(tuple(int(s) for s in sizes), tuple(axis_names))
        self.peer_views = bool(peer_views)
        self.size = _prod(self.sizes)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} of a mesh of {self.size}")
        self.rank = int(rank)
        self.coords = self.coords_of(self.rank)
        self.device = torch.device("meta")
        self.log = [] if log is None else log

    def group_ranks(self, axes: Sequence[str]) -> Tuple[int, ...]:
        """The ranks that differ from this one only along `axes`, in
        row-major order (`Mesh.group_ranks`)."""
        axes = self._axes(axes)
        out = []
        for pos in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = {**self.coords, **dict(zip(axes, pos))}
            r = 0
            for a in self.axis_names:
                r = r * self.shape[a] + c[a]
            out.append(r)
        return tuple(out)

    def all_gather(self, x: torch.Tensor,
                   axes: Sequence[str]) -> List[torch.Tensor]:
        n = self.group_size(axes)
        if n <= 1:
            return [x]
        self.log.append(("all-gather", n * _nbytes(x), n))
        if self.peer_views:
            # ranks sharing a card: this rank's own tensor, and views of
            # memory its peers hold (`shards.Exchange`)
            return [x if r == self.rank else
                    torch.empty((), dtype=x.dtype, device=self.device)
                    .expand(x.shape) for r in self.group_ranks(axes)]
        return [torch.empty(x.shape, dtype=x.dtype, device=self.device)
                for _ in range(n)]

    def barrier(self) -> None:
        if self.size > 1:
            self.log.append(("barrier", 0, self.size))

    def all_reduce(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        n = self.group_size(axes)
        if n > 1:
            self.log.append(("all-reduce", _nbytes(x), n))
        return x


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


#: collectives this process has issued through `Mesh.all_reduce`,
#: `all_gather` and `barrier`, on any of its meshes (a group of one issues
#: none), and the log `collective_log` keeps (None outside it)
_ISSUED = [0]
_LOG: List[Optional[list]] = [None]


def _note(op: str, nbytes: int, group: int) -> None:
    _ISSUED[0] += 1
    if _LOG[0] is not None:
        _LOG[0].append((op, int(nbytes), int(group)))


def collectives_issued() -> int:
    """How many collectives this process (one rank) has issued through
    the `Mesh` methods so far: read it before and after a region."""
    return _ISSUED[0]


@contextlib.contextmanager
def collective_log():
    """Yields a list that gets (op, result bytes, group size) of every
    collective this process issues through the `Mesh` methods inside the
    block: what a `RecordingMesh` logs for the same code."""
    old, _LOG[0] = _LOG[0], []
    try:
        yield _LOG[0]
    finally:
        _LOG[0] = old


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def require_devices(n: int, what: str) -> None:
    """Fail with an actionable message when the world has fewer ranks than
    a mesh needs."""
    dist = _dist()
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise ValueError(
            f"{what} needs {n} ranks but this world has {have}: start the "
            f"ranks with `launch.mesh.spawn` (or torchrun --nproc-per-node "
            f"{n})")


def _device() -> torch.device:
    return torch.device(os.environ.get("REPRO_MESH_DEVICE", "cuda"))


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[torch.device] = None) -> Mesh:
    """The reference's production shapes: 16x16 ("data", "model"), or
    2x16x16 with a leading "pod" axis; needs that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    require_devices(_prod(shape), f"production mesh "
                                  f"{'x'.join(map(str, shape))}")
    return Mesh(shape, axes, device or _device())


def make_test_mesh(data: int = 2, model: int = 2,
                   device: Optional[torch.device] = None) -> Mesh:
    """A ("data", "model") mesh over the whole world."""
    require_devices(data * model, f"test mesh {data}x{model}")
    return Mesh((data, model), ("data", "model"), device or _device())


def make_tmr_serving_mesh(copies: int = 3, data: int = 5, model: int = 16,
                          device: Optional[torch.device] = None) -> Mesh:
    """("copy", "data", "model") with the copy axis sized to the TMR copy
    count; equivalent to ``fold_copy_axis(make_test_mesh(copies * data,
    model))``."""
    require_devices(copies * data * model,
                    f"TMR serving mesh {copies}x{data}x{model}")
    return Mesh((copies, data, model), ("copy", "data", "model"),
                device or _device())


def fold_copy_axis(mesh: Mesh, copies: int = 3) -> Optional[Mesh]:
    """("data", "model") with data % copies == 0 -> ("copy", "data",
    "model") over the same ranks (row-major order kept, so copy i owns
    data rows [i * data/copies, (i+1) * data/copies)).  None when the data
    axis cannot host the copies; a mesh that already has a "copy" axis is
    returned unchanged.  Collective on first call; cached on the mesh.  An
    `pshard.AbstractMesh` folds to an AbstractMesh of the same shape, a
    `RecordingMesh` to one with its rank and log."""
    if "copy" in mesh.axis_names:
        return mesh
    if mesh.axis_names != ("data", "model"):
        return None
    d = mesh.shape["data"]
    if d % copies != 0:
        return None
    sizes = (copies, d // copies, mesh.shape["model"])
    if isinstance(mesh, RecordingMesh):
        # the rank keeps its position in row-major order
        if "_folded" not in mesh.__dict__:
            mesh._folded = RecordingMesh(sizes, ("copy", "data", "model"),
                                         mesh.rank, mesh.log, mesh.peer_views)
        return mesh._folded
    if isinstance(mesh, AbstractMesh):
        return AbstractMesh(sizes, ("copy", "data", "model"))
    if mesh._folded is None:
        mesh._folded = Mesh(sizes, ("copy", "data", "model"), mesh.device)
    return mesh._folded


def parse_mesh(text: str) -> Tuple[int, int]:
    """"DATAxMODEL" -> (data, model)."""
    try:
        data, model = (int(t) for t in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh expects DATAxMODEL (e.g. 2x2), got "
                         f"{text!r}") from None
    if data < 1 or model < 1:
        raise ValueError(f"--mesh sizes must be >= 1, got {text!r}")
    return data, model


def backend_for(device: torch.device, n_ranks: int) -> str:
    """nccl when every rank has a card of its own, else gloo."""
    if (device.type == "cuda" and torch.cuda.is_available()
            and n_ranks <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def _rank_device(device: torch.device, rank: int) -> torch.device:
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))


def _rank_main(rank: int, n: int, store_path: str, backend: str,
               device: str, fn: Callable, args: tuple, out_dir: str) -> None:
    dist = _dist()
    dev = _rank_device(torch.device(device), rank)
    if dev.type == "cpu":
        # ranks share the host's cores: one intra-op thread each, or every
        # rank's pool spins over all of them and the collectives starve
        torch.set_num_threads(1)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    os.environ["REPRO_MESH_DEVICE"] = str(dev)
    store = dist.FileStore(store_path, n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=TIMEOUT)
    faulthandler.enable()       # a rank that crashes says where
    try:
        out = fn(dev, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    except BaseException:
        # every failing rank reports, not only the first one joined
        print(f"[mesh] rank {rank} failed:\n{traceback.format_exc()}",
              file=sys.stderr, flush=True)
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n_ranks: int, *, args: tuple = (),
          device="cuda") -> list:
    """Run ``fn(rank_device, *args)`` on every rank of an `n_ranks` world
    and return the per-rank results (picklable), rank order.

    Under torchrun (``WORLD_SIZE`` set) this process is one rank: it joins
    the world from the environment and returns ``[its result]``.
    Otherwise it builds the CUDA kernels first (so ranks load them and
    never race to compile), prints the backend, starts the ranks with
    start method ``spawn`` and joins them; a rank's failure raises here.
    A rank on the CPU runs one intra-op thread."""
    dist = _dist()
    device = torch.device(device)
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != n_ranks:
            raise ValueError(f"torchrun world of {os.environ['WORLD_SIZE']} "
                             f"ranks, the mesh needs {n_ranks}")
        dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", 0)))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        os.environ["REPRO_MESH_DEVICE"] = str(dev)
        if not dist.is_initialized():
            dist.init_process_group(backend_for(device, n_ranks),
                                    timeout=TIMEOUT)
        return [fn(dev, *args)]
    backend = backend_for(device, n_ranks)
    if device.type == "cuda":
        from ..kernels import _build
        _build.build()
    print(f"[mesh] {n_ranks} ranks, backend {backend}, device {device.type}"
          + (f" ({torch.cuda.device_count()} card(s))"
             if device.type == "cuda" else ""), flush=True)
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro-mesh-") as tmp:
        mp.start_processes(
            _rank_main, nprocs=n_ranks, join=True, start_method="spawn",
            args=(n_ranks, os.path.join(tmp, "store"), backend, str(device),
                  fn, args, tmp))
        out = []
        for r in range(n_ranks):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    sys.stdout.flush()
    return out
