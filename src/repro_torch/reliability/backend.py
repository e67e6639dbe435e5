"""One registry for the port's dispatchable ops (port of
`repro.reliability.backend`).

    op           implementations (default first)
    -----------  -------------------------------
    diag_parity   kernel | torch   encode/scrub the packed ECC arena
    hsiao_secded  kernel | torch   (39,32) SEC-DED encode/scrub of the arena
    inject_scrub  kernel | torch   fused corrupt+scrub of the arena
    tmr_vote      kernel | torch   per-bit 2-of-3 majority
    netlist_exec  kernel | level | scan   netlist execution engines
    crossbar_nor  kernel | torch   gate-serial netlist interpreter

``kernel`` is the op's public wrapper: on a CUDA tensor it launches the
Hopper kernel (or raises), on a CPU tensor it runs the plain version.
The block-code ops also carry their mesh form (``scrub_sharded``; the
inject+scrub op's ``.sharded``): the same implementation run on each
rank's block range, counts summed (`kernels.sharded`).
``torch`` runs the plain version on any device.  Resolution order: the
per-call ``impl=``, then the default.  Implementations load lazily and
are cached.

The reference's default for ``netlist_exec`` is ``level``, its fastest
engine in CPU interpret mode; here ``kernel`` is the default, as for every
op, and runs the levelized plain version on a CPU tensor.  ``level`` and
``scan`` are the plain levelized and gate-serial executors on any device.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Dict, Optional, Tuple

__all__ = ["register", "ops", "implementations", "resolve", "dispatch"]

_LOADERS: Dict[str, Dict[str, Callable[[], object]]] = {}
_DEFAULTS: Dict[str, str] = {}
_CACHE: Dict[Tuple[str, str], object] = {}


def register(op: str, impl: str, loader: Callable[[], object],
             default: bool = False) -> None:
    """Register implementation `impl` of `op` behind a zero-arg loader."""
    _LOADERS.setdefault(op, {})[impl] = loader
    if default or op not in _DEFAULTS:
        _DEFAULTS[op] = impl


def ops() -> Tuple[str, ...]:
    return tuple(sorted(_LOADERS))


def implementations(op: str) -> Tuple[str, ...]:
    if op not in _LOADERS:
        raise KeyError(f"unknown op {op!r} (registered: {ops()})")
    return tuple(_LOADERS[op])


def resolve(op: str, impl: Optional[str] = None) -> str:
    avail = implementations(op)
    if impl is None:
        impl = _DEFAULTS[op]
    if impl not in avail:
        raise ValueError(f"unknown implementation {impl!r} for op {op!r} "
                         f"(available: {avail})")
    return impl


def dispatch(op: str, impl: Optional[str] = None):
    """Resolve and load the implementation of `op` (cached)."""
    name = resolve(op, impl)
    if (op, name) not in _CACHE:
        _CACHE[(op, name)] = _LOADERS[op][name]()
    return _CACHE[(op, name)]


def _bind(sharded, local, name: str = "local_scrub"):
    """The mesh form of an implementation: `sharded` (an op's
    ``scrub_sharded``) running `local` on each rank's block range."""
    def run(buf, parity, *extra, mesh=None, **kw):
        return sharded(buf, parity, *extra, mesh=mesh,
                       **{name: lambda *a: local(*a, **kw)})
    return run


class _Op:
    """A callable implementation with its mesh form as ``.sharded``."""

    def __init__(self, fn, sharded):
        self.fn, self.sharded = fn, sharded

    def __call__(self, *args, **kw):
        return self.fn(*args, **kw)


def _load_diag_parity_kernel():
    from ..kernels.diag_parity import encode_parity, scrub, scrub_sharded
    return SimpleNamespace(encode=encode_parity, scrub=scrub,
                           scrub_sharded=_bind(scrub_sharded, scrub))


def _load_diag_parity_torch():
    from ..kernels.diag_parity import scrub_sharded
    from ..kernels.diag_parity.ref import encode_parity_ref, scrub_ref
    return SimpleNamespace(encode=encode_parity_ref, scrub=scrub_ref,
                           scrub_sharded=_bind(scrub_sharded, scrub_ref))


def _load_hsiao_secded_kernel():
    from ..kernels.hsiao_secded import encode_hsiao, scrub, scrub_sharded
    return SimpleNamespace(encode=encode_hsiao, scrub=scrub,
                           scrub_sharded=_bind(scrub_sharded, scrub))


def _load_hsiao_secded_torch():
    from ..kernels.hsiao_secded import scrub_sharded
    from ..kernels.hsiao_secded.ref import encode_hsiao_ref, scrub_hsiao_ref
    return SimpleNamespace(encode=encode_hsiao_ref, scrub=scrub_hsiao_ref,
                           scrub_sharded=_bind(scrub_sharded,
                                               scrub_hsiao_ref))


def _load_inject_scrub_kernel():
    from ..kernels.inject_scrub import inject_scrub, inject_scrub_sharded
    return _Op(inject_scrub, _bind(inject_scrub_sharded, inject_scrub,
                                   "local_op"))


def _load_inject_scrub_torch():
    from ..kernels.inject_scrub import inject_scrub_sharded
    from ..kernels.inject_scrub.ref import inject_scrub_ref
    return _Op(inject_scrub_ref, _bind(inject_scrub_sharded,
                                       inject_scrub_ref, "local_op"))


def _load_tmr_vote_kernel():
    from ..kernels.tmr_vote import vote
    return vote


def _load_tmr_vote_torch():
    from ..kernels.tmr_vote.ref import vote_ref

    def vote(a, b, c, out=None):
        voted = vote_ref(a, b, c)
        return voted if out is None else out.copy_(voted)

    return vote


register("diag_parity", "kernel", _load_diag_parity_kernel, default=True)
register("diag_parity", "torch", _load_diag_parity_torch)
register("hsiao_secded", "kernel", _load_hsiao_secded_kernel, default=True)
register("hsiao_secded", "torch", _load_hsiao_secded_torch)
register("inject_scrub", "kernel", _load_inject_scrub_kernel, default=True)
register("inject_scrub", "torch", _load_inject_scrub_torch)
register("tmr_vote", "kernel", _load_tmr_vote_kernel, default=True)
register("tmr_vote", "torch", _load_tmr_vote_torch)


def _load_netlist_kernel():
    from ..kernels.netlist_exec import execute_packed
    return execute_packed


def _load_netlist_level():
    from ..core.scheduler import execute_levelized
    return execute_levelized


def _load_netlist_scan():
    from ..core.netlist import execute
    return execute


def _load_crossbar_nor_kernel():
    from ..kernels.crossbar_nor import execute_netlist
    return execute_netlist


def _load_crossbar_nor_torch():
    from ..kernels.crossbar_nor.ref import execute_netlist_ref
    return execute_netlist_ref


register("netlist_exec", "kernel", _load_netlist_kernel, default=True)
register("netlist_exec", "level", _load_netlist_level)
register("netlist_exec", "scan", _load_netlist_scan)
register("crossbar_nor", "kernel", _load_crossbar_nor_kernel, default=True)
register("crossbar_nor", "torch", _load_crossbar_nor_torch)
