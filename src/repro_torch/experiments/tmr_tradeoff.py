"""Paper §V: the protection schemes' latency/area/throughput trade-off
table (port of `benchmarks/tmr_tradeoff.py`).

For every `standard_grid()` scheme: its analytical `overhead()` beside its
mMPU projection (cycles and energy per token from `costmodel`, the paper
device), and for the TMR disciplines the crossbar simulator's cycle
accounting against the paper's `TMR_COSTS`: the 32-bit MultPIM
multiplier's gates (one cycle per vectored gate), three times over under
the serial discipline, plus the Min3 + NOT vote of its 64 output bits run
on a `core.crossbar.Crossbar`, whose `CycleCounter` counts them.  Then the
periphery-based alternative's 1024x latency the paper cites, and a wall
time of serial TMR against one execution of the 16-bit multiplier on the
device.

    python -m repro_torch.experiments.tmr_tradeoff [--device cpu]

One ``name,us,derived`` row a line, as the reference script prints.
"""
from __future__ import annotations

import argparse
import time
from typing import List

import numpy as np
import torch

from .. import costmodel as cm
from ..configs.mmpu_paper import get_device
from ..core import multpim
from ..core.crossbar import Crossbar
from ..core.tmr import TMR_COSTS
from ..device import resolve_device
from ..reliability import Tmr, standard_grid

__all__ = ["run", "vote_cycles"]

ROWS_PER_XBAR = 1024

#: execution multiplier per TMR discipline (copies run one after another
#: under serial, side by side otherwise)
_DISCIPLINE_CYCLES = {"serial": 3, "parallel": 1, "semi_parallel": 1}


def vote_cycles(copies: torch.Tensor) -> tuple:
    """Vote three copies' output bits on a crossbar simulator: copies
    (3, trials, n_out) bool, one trial a row.  Each output bit is a
    row-parallel Min3 of its three columns, then a NOT into the result
    column.  Returns (voted (trials, n_out) bool, the simulator's cycles)."""
    _, trials, n_out = copies.shape
    state = torch.zeros((trials, 5 * n_out), dtype=torch.bool,
                        device=copies.device)
    state[:, :3 * n_out] = copies.permute(1, 0, 2).reshape(trials, -1)
    xb = Crossbar(state)
    for j in range(n_out):
        xb = xb.row_gate("min3", [j, n_out + j, 2 * n_out + j],
                         3 * n_out + j)
        xb = xb.row_gate("not", [3 * n_out + j], 4 * n_out + j)
    return xb.state[:, 4 * n_out:], xb.counter.cycles


def _walltime_ms(fn, dev: torch.device, reps: int = 3) -> float:
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def run(device=None, walltime: bool = True) -> List[tuple]:
    """The table's rows ``(name, us, derived)``; `walltime` adds the timed
    row (the others are exact arithmetic and the simulator's counts)."""
    dev = resolve_device(device)
    rows = []
    nl = multpim.multiplier_netlist(32)
    base_cycles = nl.n_gates                       # 1 cycle per vectored gate

    # the vote on the simulator, over the fault-free products of three
    # copies: it must return the product and count two cycles a bit
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.integers(0, 2**32, 64).astype(np.int64),
                        device=dev)
    b = torch.as_tensor(rng.integers(0, 2**32, 64).astype(np.int64),
                        device=dev)
    prod = multpim.true_product_bits(a, b, 32)
    voted, vote_cyc = vote_cycles(torch.stack([prod] * 3))
    if not torch.equal(voted, prod):
        raise AssertionError("crossbar vote of three equal copies changed "
                             "the product")

    spec = get_device("paper")
    profile = cm.StepProfile(weight_words=1 << 16, macs_per_token=1 << 20,
                             tokens=1, mac_bits=8)
    mmpu = cm.evaluate_grid(standard_grid(), profile, spec, device=dev)
    for scheme in standard_grid():
        cost = scheme.overhead()
        proj = mmpu[scheme.name]
        derived = (cost.describe()
                   + f" mmpu_cycles_tok={proj.cycles_per_token:.4g}"
                   + f" mmpu_pj_tok={proj.energy_pj_per_token:.4g}")
        if isinstance(scheme, Tmr):
            cycles = (_DISCIPLINE_CYCLES[scheme.discipline] * base_cycles
                      + vote_cyc)
            paper = TMR_COSTS[scheme.discipline]
            derived += (f" sim_latency={cycles / base_cycles:.2f}x "
                        f"(paper: {paper.latency_x:.0f}x/"
                        f"{paper.area_x:.0f}x/{paper.throughput_x:.2f}x)")
        rows.append((f"tmr_tradeoff.{scheme.name}", 0.0, derived))
    rows.append(("tmr_tradeoff.periphery_alternative", 0.0,
                 f"latency={ROWS_PER_XBAR}x (paper: up to 1024x for 1024 "
                 f"rows)"))

    if walltime:
        a16 = torch.as_tensor(rng.integers(0, 2**16, 128).astype(np.int64),
                              device=dev)
        b16 = torch.as_tensor(rng.integers(0, 2**16, 128).astype(np.int64),
                              device=dev)
        t1 = _walltime_ms(lambda: multpim.multiply_bits(a16, b16, 16), dev)
        g = torch.Generator(device=dev)
        t3 = _walltime_ms(lambda: multpim.multiply_tmr_bits(
            a16, b16, 16, g.manual_seed(0), 0.0), dev)
        rows.append(("tmr_tradeoff.sim_walltime", t1 * 1e3,
                     f"serial_tmr/baseline={t3 / t1:.2f}x wall (3 executions "
                     f"+ voting on {dev.type})"))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    for name, us, derived in run(args.device):
        print(f"{name},{us:.3f},{derived}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
