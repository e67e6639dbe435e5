"""The transfer guard: count device->host syncs to enforce the
single-transfer telemetry invariant (port of `repro.obs.guard`, DESIGN.md
§15).

Inside `count_host_transfers()` every explicit host-read API of a tensor
is intercepted and tallied, wherever the tensor lives (so the CPU tests
mean something):

* ``MetricsRegistry.fetch`` -- the telemetry fetch (`fetch_telemetry`):
  one call counts as ONE sync however many counters it moves, and the
  reads it makes inside count as none;
* ``Tensor.item`` / ``.tolist`` / ``.cpu`` / ``.numpy`` / ``__array__``
  (``np.asarray``).  A read nested in another (``__array__`` calls
  ``numpy``) counts once, and ``.numpy()`` of a tensor that a counted
  ``.cpu()`` returned counts nothing more: ``x.cpu().numpy()`` is one
  transfer.

``torch.cuda.synchronize`` is not counted, as the reference does not count
``block_until_ready``: it waits for the card but moves no data (chunked
generation marks its latency timestamps with it).

``strict=True`` also arms ``torch.cuda.set_sync_debug_mode("error")`` on
CUDA, outside counted reads, so a sync that bypasses these APIs (a
blocking copy, a data-dependent shape) raises; on the CPU it is a no-op,
as jax's own guard is there.  The hook is process-global and not
reentrant -- for tests and checks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import traceback
import weakref
from typing import Iterator, List

import torch

__all__ = ["TransferLedger", "count_host_transfers"]

_READS = ("item", "tolist", "cpu", "numpy", "__array__")


@dataclasses.dataclass
class TransferLedger:
    """Tally of host syncs observed inside a `count_host_transfers` region."""

    syncs: int = 0
    sites: List[str] = dataclasses.field(default_factory=list)

    def _hit(self, api: str) -> None:
        self.syncs += 1
        if len(self.sites) < 32:
            stack = traceback.extract_stack(limit=12)[:-2]
            frame = next((f for f in reversed(stack)
                          if "obs/guard" not in f.filename
                          and "contextlib" not in f.filename), None)
            self.sites.append(
                f"{api} @ {frame.filename}:{frame.lineno}" if frame else api)


def _cuda_armed() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def count_host_transfers(strict: bool = True) -> Iterator[TransferLedger]:
    """Context manager yielding a `TransferLedger`; every explicit host
    read inside increments it (module doc)."""
    from .registry import MetricsRegistry

    ledger = TransferLedger()
    orig = {name: getattr(torch.Tensor, name) for name in _READS}
    orig_fetch = MetricsRegistry.fetch
    armed = strict and _cuda_armed()
    mode = torch.cuda.get_sync_debug_mode() if armed else 0
    depth = [0]          # > 0 inside a counted read
    fetched = {}         # id -> weakref of what a counted .cpu() returned

    @contextlib.contextmanager
    def counted(api: str, quiet: bool = False):
        if not depth[0] and not quiet:
            ledger._hit(api)
        depth[0] += 1
        if armed:
            torch.cuda.set_sync_debug_mode(mode)   # counted: let it sync
        try:
            yield
        finally:
            depth[0] -= 1
            if armed and not depth[0]:
                torch.cuda.set_sync_debug_mode("error")

    def fetch(self, telemetry):
        with counted("fetch_telemetry"):
            return orig_fetch(self, telemetry)

    def make_wrapper(name, fn):
        def wrapper(self, *args, **kw):
            ref = fetched.get(id(self))
            quiet = name == "numpy" and ref is not None and ref() is self
            with counted(f"Tensor.{name}", quiet):
                out = fn(self, *args, **kw)
            if name == "cpu" and isinstance(out, torch.Tensor):
                fetched[id(out)] = weakref.ref(out)
            return out
        return wrapper

    MetricsRegistry.fetch = fetch
    for name, fn in orig.items():
        setattr(torch.Tensor, name, make_wrapper(name, fn))
    if armed:
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield ledger
    finally:
        if armed:
            torch.cuda.set_sync_debug_mode(mode)
        MetricsRegistry.fetch = orig_fetch
        for name, fn in orig.items():
            setattr(torch.Tensor, name, fn)
