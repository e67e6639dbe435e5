"""Background prefetch + per-rank sharded loading (port of
`repro.data.loader`)."""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np

__all__ = ["Prefetcher", "ShardedLoader"]


class Prefetcher:
    """Prefetch batches on a background thread (overlaps host data work with
    device compute — the CPU-side analogue of compute/comm overlap)."""

    def __init__(self, it: Iterator[Any], depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def run():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self._q.put(item)
            except BaseException as e:  # surfaced on next()
                self._err = e
            finally:
                self._q.put(None)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


class ShardedLoader:
    """Wraps per-rank batch sources into one global batch: in this
    single-process harness it concatenates the per-rank shards (host numpy;
    the caller moves the batch to its device)."""

    def __init__(self, make_source: Callable[[int, int], Any], world: int,
                 to_device: bool = True):
        self.sources = [make_source(r, world) for r in range(world)]
        self.world = world
        self.to_device = to_device

    def batch_at(self, step: int) -> np.ndarray:
        shards = [s.batch_at(step) for s in self.sources]
        return np.concatenate(shards, axis=0)
