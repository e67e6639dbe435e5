"""Many-seed checks of a sampler's counts against Binomial(n, p).

A count from one generator seed says little about a sampler's bias: a
bias of a tenth of a standard deviation passes, and which seeds pass is
luck.  `fits_binomial` takes the counts of `SEEDS` independent draws
(generator seeds 0 .. SEEDS - 1) and holds their sample mean and sample
variance to the binomial's, so no single seed decides the result:

* the mean inside its normal `CONF` interval, n p +- z sqrt(n p q / S);
* (S - 1) s^2 / (n p q) inside the chi-square(S - 1) `CONF` interval (the
  counts are near normal at the means these tests draw, n p >= 100).
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from scipy import stats

#: independent draws per check (generator seeds 0 .. SEEDS - 1)
SEEDS = 200
#: confidence of each of the two intervals
CONF = 0.999


def counts_over_seeds(draw: Callable[[int], object], seeds: int = SEEDS):
    """[draw(seed) for seed in range(seeds)] as float64, one row a seed.

    The draws run on one intra-op thread: a few thousand small
    multi-threaded torch ops crawl (tens of times slower) when parallel
    test workers oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return np.asarray([draw(s) for s in range(seeds)], np.float64)
    finally:
        torch.set_num_threads(threads)


def fits_binomial(counts, n: int, p: float) -> None:
    """Assert that `counts` (one per seed) fit Binomial(n, p) in mean and
    variance; a zero-variance binomial must give its mean every time."""
    c = np.asarray(counts, np.float64)
    s = c.size
    mean, var = n * p, n * p * (1.0 - p)
    if var == 0.0:
        assert (c == mean).all(), (c, mean)
        return
    z = stats.norm.ppf(0.5 + CONF / 2)
    half = z * math.sqrt(var / s)
    assert abs(c.mean() - mean) <= half, \
        f"mean {c.mean():.2f} outside {mean:.2f} +- {half:.2f} ({s} seeds)"
    lo, hi = stats.chi2.interval(CONF, s - 1)
    ratio = c.var(ddof=1) / var
    assert lo / (s - 1) <= ratio <= hi / (s - 1), \
        (f"variance {c.var(ddof=1):.1f} against {var:.1f}: ratio "
         f"{ratio:.3f} outside [{lo / (s - 1):.3f}, {hi / (s - 1):.3f}] "
         f"({s} seeds)")
