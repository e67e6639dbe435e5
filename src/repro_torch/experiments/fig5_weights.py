"""Paper Fig. 5: expected corrupted weights over T batches, baseline against
mMPU ECC, for a range of per-access bit-corruption rates p_input (port of
`benchmarks/fig5_weights.py`).

Also checks the analytic model against a direct simulation of the
word-level `ReliableStore` (inject -> scrub each batch) at an accelerated
rate.

    python -m repro_torch.experiments.fig5_weights [--device cpu] [--smoke]
"""
from __future__ import annotations

import argparse
import time
from typing import List

import numpy as np
import torch

from ..core import analytics as A
from ..core.reliability import ReliableStore
from ..device import resolve_device
from ..faults import inject_bit_flips

__all__ = ["simulate_store", "run"]


def simulate_store(p_bit: float, batches: int, n_weights: int = 4096,
                   device=None, *, protected: bool = True) -> int:
    """Corrupt (and, when `protected`, scrub through a ReliableStore)
    `batches` times; returns how many weights end up corrupted.  The
    weights (standard normal fp32) and every batch's flips are drawn from
    one generator seeded 0, so protected=False replays the same flips on an
    unprotected copy."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    w0 = torch.randn(n_weights, generator=g, device=dev)
    if protected:
        store = ReliableStore.protect({"w": w0})    # the store's own copy
        for _ in range(batches):
            inject_bit_flips(store.params, g, p_bit)
            store, _ = store.scrub()
        w = store.params["w"]
    else:
        w = w0.clone()
        for _ in range(batches):
            inject_bit_flips({"w": w}, g, p_bit)
    return int((w != w0).sum())


def run(device=None, smoke: bool = False) -> List[tuple]:
    """The curve and headline rows, and the simulation's row (32 scrubs of
    4096 weights at p_bit 2e-6; smoke: 8 scrubs)."""
    dev = resolve_device(device)
    rows = []
    cs = A.AlexNetCaseStudy()
    T = np.logspace(3, 8, 6)
    for p_input in (1e-10, 1e-9, 1e-8):
        base = A.expected_corrupted_weights(
            A.weight_corruption_baseline(p_input, T), cs)
        ecc = A.expected_corrupted_weights(
            A.weight_corruption_ecc_refined(p_input, T), cs)
        for i, t in enumerate(T):
            rows.append((f"fig5.p{p_input:g}_T{t:.0e}", 0.0,
                         f"baseline={base[i]:.3e} ecc={ecc[i]:.3e}"))
    rows.append(("fig5.headline_1e7_batches_p1e-9", 0.0,
                 f"baseline={A.expected_corrupted_weights(A.weight_corruption_baseline(1e-9, np.array([1e7])), cs)[0]:.2e} "  # noqa: E501
                 f"ecc={A.expected_corrupted_weights(A.weight_corruption_ecc_refined(1e-9, np.array([1e7])), cs)[0]:.2f} "  # noqa: E501
                 f"(paper: ~1 corrupted weight)"))

    # accelerated end-to-end simulation against the analytics
    batches = 8 if smoke else 32
    t0 = time.perf_counter()
    corrupted = simulate_store(p_bit=2e-6, batches=batches, device=dev)
    us = (time.perf_counter() - t0) * 1e6 / batches
    rows.append((f"fig5.sim_store_{batches}scrubs_p2e-6", us,
                 f"corrupted_weights={corrupted} (expect ~0-2: double hits "
                 f"only)"))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    ap.add_argument("--smoke", action="store_true",
                    help="8 scrubs in the simulation instead of 32")
    args = ap.parse_args(argv)
    for name, us, derived in run(args.device, args.smoke):
        print(f"{name},{us:.3f},{derived}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
