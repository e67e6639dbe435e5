"""Closed-form reliability analytics (port of `repro.core.analytics`, the
Fig. 4 subset: `p_mult_from_alpha` and `p_mult_tmr`).

* p_mult(p_gate): the exhaustive single-fault masking fraction alpha (the
  fraction of gate positions whose single fault corrupts the product,
  measured once with fault_gate = arange(G)) extrapolates
      p_mult ~= 1 - (1 - alpha * p_gate)^G.
* TMR: a voted output bit fails if >= 2 copies err on that bit, or voting
  itself errs, from the same per-copy failure probability and the
  voting-gate count (2 gates per output bit, non-ideal).
"""
from __future__ import annotations

import numpy as np

__all__ = ["p_mult_from_alpha", "p_mult_tmr"]


def p_mult_from_alpha(p_gate: np.ndarray, alpha: float,
                      n_gates: int) -> np.ndarray:
    """Unreliable-baseline multiplication failure probability.

    alpha = unmasked fraction from exhaustive single-fault injection.
    Exact for independent iid gate faults in the rare-fault regime; at high
    p_gate multi-fault cancellation makes this an upper bound (Monte Carlo
    there instead).
    """
    p_gate = np.asarray(p_gate, dtype=np.float64)
    return 1.0 - np.power(1.0 - alpha * p_gate, n_gates)


def p_mult_tmr(p_gate: np.ndarray, alpha: float, n_gates: int,
               n_out_bits: int = 64, alpha_vote: float = 1.0,
               ideal_voting: bool = False) -> np.ndarray:
    """TMR multiplication failure probability (per-bit voting).

    A voted result is wrong if (a) >= 2 of 3 copies produce a wrong value on
    some common bit, or (b) a voting gate errs.  Whole-word copy failure
    stands in for same-bit failure (an upper bound, as the paper's own
    word-level curves).  Voting uses 2 stateful gates per output bit.
    """
    p_gate = np.asarray(p_gate, dtype=np.float64)
    p_copy = 1.0 - np.power(1.0 - alpha * p_gate, n_gates)
    p_two_of_three = 3.0 * p_copy**2 * (1.0 - p_copy) + p_copy**3
    if ideal_voting:
        return p_two_of_three
    p_vote = 1.0 - np.power(1.0 - alpha_vote * p_gate, 2 * n_out_bits)
    return 1.0 - (1.0 - p_two_of_three) * (1.0 - p_vote)
