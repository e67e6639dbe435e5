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

A state sharded over a process mesh (``save(..., shardings=)``, every
rank calling) is saved as the same global leaves: each leaf is gathered
whole from its ranks (a stacked leaf one layer at a time) and rank 0
writes it before the next is gathered, so no rank holds more than one
leaf at a time.  `restore_resharded` places a snapshot on any mesh: every
rank reads the leaves one at a time and keeps its slice of each.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core import tree as T

__all__ = ["Checkpointer", "restore_resharded"]


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
    def save(self, step: int, state: Any, block: bool = False, *,
             shardings: Any = None, mesh=None) -> None:
        """Snapshot `state` as step `step`.  With `shardings` (a spec
        tuple, or None for a leaf every rank holds whole, per leaf or per
        subtree) `state` is this rank's shards on `mesh` (default: the
        ambient mesh): every rank calls, rank 0 writes the global leaves,
        synchronously (module doc)."""
        if shardings is not None:
            self._save_sharded(step, state, shardings, mesh)
            return
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
        self._publish(final, tmp)

    @staticmethod
    def _publish(final: str, tmp: str) -> None:
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

    def _save_sharded(self, step: int, state: Any, shardings: Any,
                      mesh) -> None:
        from ..pshard import ambient_mesh
        mesh = mesh if mesh is not None else ambient_mesh()
        if mesh is None:
            raise ValueError("Checkpointer.save(shardings=) needs a mesh")
        self.wait()
        paths = T.paths(state)
        specs = _flatten_up_to(shardings, state)
        writing = mesh.rank == 0
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if writing:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            zf = zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w",
                                 allowZip64=True)
        bf16 = []
        for i, (x, spec) in enumerate(zip(T.leaves(state), specs)):
            a = _global_leaf(x, spec, mesh)
            if writing:
                host, is_bf16 = a
                if is_bf16:
                    bf16.append(i)
                with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, host, allow_pickle=False)
            del a
        if writing:
            zf.close()
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "paths": [list(p) for p in paths],
                           "bf16_leaves": bf16, "time": time.time()}, f)
            self._publish(final, tmp)
            self._gc()
        mesh.barrier()          # the snapshot is published for every rank

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
        paths, bf16, z = self._open(step)
        with z:
            leaves = [np.array(z[f"leaf_{i}"]) for i in range(len(paths))]
        return paths, leaves, bf16

    def restore(self, step: Optional[int] = None) -> Any:
        """The snapshot of `step` (default: the latest) with numpy leaves;
        numpy has no bfloat16, so those leaves come back as their uint16
        bits (`restore_tensors` views them back)."""
        paths, leaves, _ = self._load(step)
        return T.unflatten(paths, leaves)

    def _open(self, step: Optional[int]):
        """(paths, bf16 leaf indices, `_Leaves`) of a snapshot; the leaves
        are read when indexed."""
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
        return ([tuple(p) for p in manifest["paths"]],
                set(manifest["bf16_leaves"]),
                _Leaves(os.path.join(path, "arrays.npz")))

    def restore_tensors(self, step: Optional[int] = None,
                        device="cpu") -> Any:
        """The snapshot with every numeric leaf a tensor on `device`
        (bfloat16 leaves viewed back), strings left as numpy."""
        paths, leaves, bf16 = self._load(step)
        return T.unflatten(paths, [_tensor(a, i in bf16, device)
                                   for i, a in enumerate(leaves)])


def _tensor(a: np.ndarray, bf16: bool, device, sl=None):
    """A host leaf (or its slice `sl`) as a tensor of its own on `device`
    (bf16 bits viewed back; a string leaf stays numpy)."""
    if a.dtype.kind in "US":
        return a
    if sl is not None:
        a = a[sl]
    # a copy of its own (`a` may map the file); (np.ascontiguousarray
    # would make a 0-d leaf 1-d)
    t = torch.from_numpy(np.array(a, order="C", copy=True))
    if bf16:
        t = t.view(torch.bfloat16)
    return t.to(device)


class _Leaves:
    """The arrays of an ``arrays.npz`` by name (``z["leaf_3"]``): a stored
    (uncompressed) ``.npy`` member is memory-mapped at its offset in the
    file, so a reader that slices a leaf reads only its slice; anything
    else is read as `np.load` reads it."""

    def __init__(self, path: str):
        self.path = path
        self.zip = zipfile.ZipFile(path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.zip.close()

    def __getitem__(self, name: str) -> np.ndarray:
        info = self.zip.getinfo(name + ".npy")
        if info.compress_type == zipfile.ZIP_STORED:
            with open(self.path, "rb") as f:
                f.seek(info.header_offset)
                head = f.read(30)
                n_name, n_extra = struct.unpack("<HH", head[26:30])
                f.seek(info.header_offset + 30 + n_name + n_extra)
                version = np.lib.format.read_magic(f)
                read = {(1, 0): np.lib.format.read_array_header_1_0,
                        (2, 0): np.lib.format.read_array_header_2_0}.get(
                            version)
                if read is not None:
                    shape, fortran, dtype = read(f)
                    offset = f.tell()
                    if not (fortran or dtype.hasobject or
                            0 in shape or shape == ()):
                        return np.memmap(self.path, dtype=dtype, mode="r",
                                         offset=offset, shape=shape)
        with self.zip.open(info) as f:
            return np.lib.format.read_array(f, allow_pickle=False)


def _flatten_up_to(shardings: Any, tree: Any) -> List[Any]:
    """One sharding per leaf of `tree`: a dict of `shardings` follows the
    tree, anything else (a spec tuple, None) covers the whole subtree."""
    if isinstance(tree, dict):
        if isinstance(shardings, dict):
            return [s for k in sorted(tree)
                    for s in _flatten_up_to(shardings[k], tree[k])]
        return [shardings] * len(T.leaves(tree))
    return [shardings]


#: elements of a whole leaf gathered at once when it is saved
GATHER_CHUNK = 1 << 26


def _global_leaf(x: Any, spec, mesh):
    """The whole leaf of which `x` is this rank's shard under `spec`
    (None: held whole), as `_to_host` gives it on rank 0 (None
    elsewhere); collective.  A leaf whose leading dim is not split is
    gathered in runs of that dim of about `GATHER_CHUNK` elements."""
    from ..launch.shards import assemble, global_shape
    from ..pshard import spec_axes
    if spec is None or not isinstance(x, torch.Tensor) or not any(
            spec_axes(e) for e in spec):
        return _to_host(x) if mesh.rank == 0 else None
    shape = global_shape(tuple(x.shape), spec, mesh)
    if not x.dim() or spec_axes(spec[0]):
        full = assemble(x, shape, spec, mesh)
        return _to_host(full) if mesh.rank == 0 else None
    out = None
    row = max(1, int(np.prod(shape[1:], dtype=np.int64)))
    step = max(1, GATHER_CHUNK // row)
    for a in range(0, shape[0], step):
        b = min(shape[0], a + step)
        part = _to_host(assemble(x[a:b], (b - a,) + tuple(shape[1:]), spec,
                                 mesh))
        if mesh.rank == 0:
            if out is None:
                out = (np.empty(shape, part[0].dtype), part[1])
            out[0][a:b] = part[0]
    return out


def restore_resharded(ckpt: Checkpointer, shardings: Any,
                      step: Optional[int] = None, mesh=None):
    """Elastic restore: the snapshot placed with *new* shardings, possibly
    on another mesh shape than the one that saved it.  `shardings`: a
    spec tuple (or None: the leaf whole) per leaf or per subtree, on
    `mesh` (default: the ambient mesh); every rank reads the leaves one
    at a time and keeps its slice (`pshard.shard_slices`) on the mesh's
    device (the CPU without a mesh)."""
    from ..pshard import ambient_mesh, shard_slices
    mesh = mesh if mesh is not None else ambient_mesh()
    device = getattr(mesh, "device", "cpu")
    ckpt.wait()
    paths, bf16, z = ckpt._open(step)
    specs = _flatten_up_to(shardings, T.unflatten(paths, paths))
    out = []
    with z:
        for i, spec in enumerate(specs):
            a = z[f"leaf_{i}"]
            sl = None
            if spec is not None and mesh is not None:
                sl = shard_slices(a.shape, spec, mesh, mesh.coords)
            out.append(_tensor(a, i in bf16, device, sl))
            del a
    return T.unflatten(paths, out)
