"""The (39,32) Hsiao SEC-DED code: H-matrix constants (the port's own copy
of `repro.kernels.hsiao_secded.code`, built by the same deterministic
selection; a test holds the two equal).

Every data column of H has odd weight (3 of 7 check bits), so single errors
(odd syndrome weight) and double errors (even, nonzero) are disjoint:
SEC-DED without an extra overall-parity row.  C(7,3) = 35 weight-3 columns
cover 32 data bits; three are dropped greedily to keep the row weights
balanced.  The 7 unit vectors protect the check bits themselves.

Layout over the packed arena: a block is 32 consecutive words; its check
row is 7 words, check bit j of word i at bit position i of word j.
"""
from __future__ import annotations

from typing import Tuple

__all__ = ["N_CHECKS", "DATA_BITS", "DATA_COLUMNS", "CHECK_MASKS"]

N_CHECKS = 7          # check bits per 32-bit data word
DATA_BITS = 32


def _select_columns() -> Tuple[int, ...]:
    cand = [c for c in range(1 << N_CHECKS) if bin(c).count("1") == 3]
    # drop 3 of the 35 candidates, each time the lexicographically first
    # column whose rows are currently the most loaded
    cols = list(cand)
    for _ in range(len(cand) - DATA_BITS):
        load = [sum((c >> j) & 1 for c in cols) for j in range(N_CHECKS)]
        worst = max(cols, key=lambda c: (sum(load[j] for j in range(N_CHECKS)
                                             if (c >> j) & 1), -c))
        cols.remove(worst)
    return tuple(cols)


#: syndrome of a single flip of data bit k (32 entries, odd weight,
#: pairwise distinct, none a unit vector)
DATA_COLUMNS: Tuple[int, ...] = _select_columns()

#: CHECK_MASKS[j]: the 32-bit data mask of check bit j (bit k set iff data
#: bit k participates in check j)
CHECK_MASKS: Tuple[int, ...] = tuple(
    sum(((col >> j) & 1) << k for k, col in enumerate(DATA_COLUMNS))
    for j in range(N_CHECKS))

assert len(set(DATA_COLUMNS)) == DATA_BITS
assert all(bin(c).count("1") == 3 for c in DATA_COLUMNS)
