"""Campaign statistics (port of `repro.faults.campaign`, only
`wilson_interval` so far: the Fig. 4 path reports its Monte Carlo estimates
with it; the campaign engine itself is still to be ported)."""
from __future__ import annotations

import math
from typing import Tuple

__all__ = ["wilson_interval"]


def wilson_interval(k: int, n: int, z: float = 1.96) -> Tuple[float, float]:
    """Wilson score interval for k failures in n Bernoulli trials.

    Preferred over the normal approximation because campaign operating
    points sit in the rare-event regime (k near 0), where Wald intervals
    collapse to a width-0 lie.
    """
    if n <= 0:
        return 0.0, 1.0
    p = k / n
    z2 = z * z
    denom = 1.0 + z2 / n
    center = (p + z2 / (2 * n)) / denom
    half = (z / denom) * math.sqrt(p * (1.0 - p) / n + z2 / (4.0 * n * n))
    return max(0.0, center - half), min(1.0, center + half)
