"""Paper Fig. 4 (bottom): NN feed-forward misclassification against p_gate
(port of `benchmarks/fig4_nn.py`).

FloatPIM-style AlexNet/ImageNet accelerator: M = 612e6 multiplications a
sample, p_mask = 0.03% of soft errors flip the classification (G. Li et
al.); p_misclassify = 1 - (1 - p_mask * p_mult)^M.  The paper's headline:
74% baseline against ~2% with TMR at p_gate = 1e-9 (the network's inherent
error is ~27%, so the TMR residual is negligible).

    python -m repro_torch.experiments.fig4_nn [--device cpu] [--smoke]
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from ..core import analytics as A
from ..core import multpim
from ..device import resolve_device
from .campaign_mc import measure_alpha

__all__ = ["run"]


def run(device=None, smoke: bool = False, *,
        alpha: Optional[float] = None) -> List[tuple]:
    """The curve and headline rows ``(name, 0.0, derived)``.  alpha (the
    32-bit multiplier's single-fault masking fraction) is measured on
    `device` when None; smoke measures the 16-bit multiplier's instead."""
    dev = resolve_device(device)
    n_bits = 16 if smoke else 32
    nl = multpim.multiplier_netlist(n_bits)
    if alpha is None:
        alpha = measure_alpha(n_bits, dev)
    cs = A.AlexNetCaseStudy()
    pg = np.logspace(-12, -8, 9)
    base = A.nn_misclassification(A.p_mult_from_alpha(pg, alpha, nl.n_gates),
                                  cs)
    tmr = A.nn_misclassification(A.p_mult_tmr(pg, alpha, nl.n_gates), cs)
    rows = []
    for i, p in enumerate(pg):
        rows.append((f"fig4_nn.curve_p{p:.0e}", 0.0,
                     f"baseline={base[i]:.4f} tmr={tmr[i]:.4f}"))
    i9 = int(np.argmin(np.abs(pg - 1e-9)))
    rows.append(("fig4_nn.headline_1e-9", 0.0,
                 f"baseline={base[i9]:.3f} (paper ~0.74) "
                 f"tmr={tmr[i9]:.4f} (paper ~0.02) "
                 f"inherent_error={cs.inherent_error}"))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    ap.add_argument("--smoke", action="store_true",
                    help="the 16-bit multiplier's alpha")
    args = ap.parse_args(argv)
    for name, us, derived in run(args.device, args.smoke):
        print(f"{name},{us:.3f},{derived}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
