"""Build the port's CUDA kernels and count their launches.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ctypes (no PyTorch
headers, so a build takes seconds, not minutes).  All missing libraries are
built in parallel, one ``nvcc`` per source, into ``<checkout>/build/
repro_torch`` (override with ``REPRO_TORCH_BUILD_DIR``).  A library's file
name carries a hash of its sources and flags, so an edited source rebuilds
and an unchanged one is reused.

Nothing is compiled or loaded at import time: the CPU tests import every
module of the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path
from typing import Dict, Optional, Tuple

__all__ = ["SOURCES", "build", "library", "library_path", "check",
           "count_launch", "launch_counts", "launch_shapes",
           "reset_launch_counts", "build_dir"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("diag_parity", "inject_scrub", "hsiao_secded", "tmr_vote",
           "flash_attention", "netlist_exec", "crossbar_nor")
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LAUNCHES: Counter = Counter()
_SHAPES: Counter = Counter()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels build only on a machine with the CUDA "
                           "toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> float:
    """Compile every missing library in parallel; returns the seconds the
    build took.  `verbose` rebuilds all with ``-Xptxas=-v`` and prints the
    compiler's register, spill and shared-memory report."""
    todo = [n for n in SOURCES if verbose or not _target(n).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, tmp, p in procs:
        out, _ = p.communicate()
        if verbose and out:
            print(f"[build] {n}:\n{out}")
        if p.returncode:
            failed.append(f"{n} (rc {p.returncode}):\n{out}")
        else:
            os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library_path(name: str) -> Path:
    """The shared library built from source `name` (builds everything
    missing)."""
    build()
    return _target(name)


def library(name: str) -> ctypes.CDLL:
    """The loaded library for source `name` (builds everything missing on
    first use)."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code:
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({lib.repro_error_string(code).decode()})")


def count_launch(name: str, shape: Optional[str] = None) -> None:
    """One launch of kernel `name`; `shape` also tallies it under (name,
    shape) -- a mode and size, say."""
    _LAUNCHES[name] += 1
    if shape is not None:
        _SHAPES[name, shape] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def launch_shapes() -> Dict[Tuple[str, str], int]:
    """Launches by (name, shape), for the wrappers that pass a shape."""
    return dict(_SHAPES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()
    _SHAPES.clear()
