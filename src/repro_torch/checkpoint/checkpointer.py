"""Fault-tolerant checkpointing (port of `repro.checkpoint.checkpointer`).

* **atomic** -- write to `step_XXXXXXXX.tmp/`, then rename; a preempted
  writer never corrupts the latest checkpoint;
* **async** -- the device -> host copy is synchronous (a consistent
  snapshot), the writing happens on a background thread;
* **windowed** -- keep the most recent K checkpoints, delete older;
* **recoverable** -- a re-save of a published step moves it to `.old`
  first; if the writer dies between the two renames, the `.old` snapshot
  is still found and restored.

A snapshot is a nested dict whose leaves are tensors, numpy arrays or
Python scalars and strings.  The leaves go to one `arrays.npz` (bfloat16
as uint16 bit views, which npz can hold); `manifest.json` records the
tree as the leaves' key paths, where the reference pickles a JAX treedef.
So neither package reads the other's checkpoints.  `restore` returns the
tree with numpy leaves, `restore_tensors` with tensors on a device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core import tree as T

__all__ = ["Checkpointer"]


def _to_host(x: Any):
    """(numpy copy, is bf16) of a leaf; a tensor is copied even on the
    CPU, since the caller goes on updating it in place."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), True
        return x.numpy(), False
    return np.array(x), False


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ------------------------------------------------------------------
    def save(self, step: int, state: Any, block: bool = False) -> None:
        # device -> host happens synchronously (consistent snapshot) ...
        paths = T.paths(state)
        host = [_to_host(x) for x in T.leaves(state)]
        self.wait()

        def work():
            self._write(step, paths, host)
            self._gc()

        if self.async_save and not block:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, paths, host) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": a for i, (a, _) in enumerate(host)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "paths": [list(p) for p in paths],
                       "bf16_leaves": [i for i, (_, bf) in enumerate(host)
                                       if bf],
                       "time": time.time()}, f)
        old = final + ".old"
        if os.path.isdir(final):
            # re-save of a published step (e.g. after a scrub-triggered
            # restore rolled the loop back): move it aside rather than
            # delete it, so a crash between the two renames still leaves a
            # restorable snapshot (`.old` counts only when the published
            # dir is gone)
            if os.path.isdir(old):
                shutil.rmtree(old)
            os.replace(final, old)
        os.replace(tmp, final)  # atomic publish
        shutil.rmtree(old, ignore_errors=True)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}.old"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def _snapshots(self) -> Dict[int, str]:
        """step -> dir name of every restorable snapshot.  A `.old` aside
        counts only when the published dir for that step is gone.  Callers
        racing an in-flight async save should wait() first (TrainLoop's
        restore does), since _write renames the dir being re-saved."""
        finals, olds = {}, {}
        for name in os.listdir(self.dir):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            if name.endswith(".old"):
                olds[int(name[:-4].split("_")[1])] = name
            else:
                finals[int(name.split("_")[1])] = name
        for step, name in olds.items():
            finals.setdefault(step, name)
        return finals

    def all_steps(self) -> List[int]:
        return sorted(self._snapshots())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load(self, step: Optional[int]):
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        name = self._snapshots().get(step)
        if name is None:
            raise FileNotFoundError(f"no checkpoint for step {step} in "
                                    f"{self.dir}")
        path = os.path.join(self.dir, name)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            leaves = [z[f"leaf_{i}"] for i in range(len(manifest["paths"]))]
        return [tuple(p) for p in manifest["paths"]], leaves, \
            set(manifest["bf16_leaves"])

    def restore(self, step: Optional[int] = None) -> Any:
        """The snapshot of `step` (default: the latest) with numpy leaves;
        numpy has no bfloat16, so those leaves come back as their uint16
        bits (`restore_tensors` views them back)."""
        paths, leaves, _ = self._load(step)
        return T.unflatten(paths, leaves)

    def restore_tensors(self, step: Optional[int] = None,
                        device="cpu") -> Any:
        """The snapshot with every numeric leaf a tensor on `device`
        (bfloat16 leaves viewed back), strings left as numpy."""
        paths, leaves, bf16 = self._load(step)

        def leaf(i, a):
            if a.dtype.kind in "US":
                return a
            # (np.ascontiguousarray would make a 0-d leaf 1-d)
            t = torch.from_numpy(a if a.flags.c_contiguous else a.copy())
            if i in bf16:
                t = t.view(torch.bfloat16)
            return t.to(device)

        return T.unflatten(paths, [leaf(i, a) for i, a in enumerate(leaves)])
