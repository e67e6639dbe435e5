"""Opcode counts of the port's compiled kernels, from ``cuobjdump -sass``.

    python -m repro_torch.kernels.sass_report [--ptxas] [--match S] [--dump]
        [LIB ...]

For every kernel function in each shared library (default: the libraries
`_build` builds from this checkout's sources, building what is missing) it
prints the static count of each opcode family over the whole function and
over its main loop -- the widest range closed by a backward branch, the
loop a thread walks once per tile or block group -- so per-word figures
follow from the words one iteration covers.  `--ptxas` first rebuilds every
library with ``-Xptxas=-v`` and prints the compiler's registers, spills and
shared memory; `--match` keeps the functions whose demangled name contains
S; `--dump` prints each kept function's main loop.  Needs the CUDA toolkit
(``cuobjdump``, ``cu++filt``), so it runs on the machine with the card.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, List, Tuple

from . import _build

FAMILIES = ("POPC", "SHFL", "VOTE", "REDUX", "LOP3", "SHF", "PRMT", "IMAD",
            "IADD3", "LEA", "ISETP", "FLO", "BRA", "LDS", "STS", "LDG",
            "STG", "LDGSTS", "ATOMS", "RED")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")


def _tool(name: str) -> str:
    home = Path(_build._nvcc()).parent
    cand = home / name
    found = str(cand) if cand.exists() else shutil.which(name)
    if not found:
        raise RuntimeError(f"{name} not found next to nvcc")
    return found


def family(op: str) -> str:
    """Opcode family with the load/store width kept (LDG.128, LDS.32)."""
    head = op.split(".")[0]
    if head in ("LDG", "LDS", "STG", "STS"):
        width = next((p for p in op.split(".")[1:] if p in
                      ("8", "U8", "16", "U16", "64", "128")), "32")
        return f"{head}.{width}"
    return head


def functions(lib: Path) -> Dict[str, List[Tuple[int, str, str]]]:
    """{mangled name: [(address, opcode, operands)]} of a library's SASS."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    funcs: Dict[str, List[Tuple[int, str, str]]] = {}
    cur = None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return funcs


def main_loop(insns) -> Tuple[int, int]:
    """(first, last) address of the widest loop, or the whole function."""
    best = (insns[0][0], insns[-1][0]) if insns else (0, 0)
    width = -1
    for addr, op, args in insns:
        m = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            if addr - lo > width:
                best, width = (lo, addr), addr - lo
    return best


def demangle(names: List[str]) -> List[str]:
    try:
        out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        return out.stdout.splitlines()
    except (RuntimeError, subprocess.CalledProcessError):
        return names


def report(lib: Path, match: str = "", dump: bool = False) -> None:
    funcs = functions(lib)
    names = list(funcs)
    print(f"== {lib.name}")
    for mangled, pretty in zip(names, demangle(names)):
        if match and match not in pretty:
            continue
        insns = funcs[mangled]
        lo, hi = main_loop(insns)
        total = Counter(family(op) for _, op, _ in insns)
        loop = Counter(family(op) for a, op, _ in insns if lo <= a <= hi)
        n_loop = sum(loop.values())
        print(f"-- {pretty}\n   {len(insns)} instructions, main loop "
              f"[{lo:#x}, {hi:#x}] {n_loop}")
        keys = sorted(set(total) & {k for k in total
                                    if k.split(".")[0] in FAMILIES})
        print("   family        function  loop")
        for k in keys:
            print(f"   {k:<12} {total[k]:>9} {loop.get(k, 0):>5}")
        other = n_loop - sum(loop.get(k, 0) for k in keys)
        print(f"   {'other':<12} {len(insns) - sum(total[k] for k in keys):>9}"
              f" {other:>5}")
        if dump:
            for a, op, args in insns:
                if lo <= a <= hi:
                    print(f"   {a:#07x} {op}{args}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("libs", nargs="*", type=Path)
    ap.add_argument("--ptxas", action="store_true",
                    help="rebuild with -Xptxas=-v and print its report")
    ap.add_argument("--match", default="")
    ap.add_argument("--dump", action="store_true")
    a = ap.parse_args()
    if a.ptxas:
        _build.build(verbose=True)
    libs = a.libs or [_build.library_path(n) for n in _build.SOURCES]
    for lib in libs:
        report(lib, a.match, a.dump)


if __name__ == "__main__":
    main()
