"""Closed-form reliability analytics for the paper's case study (port of
`repro.core.analytics`, §VI).  All of it is float64 numpy arithmetic, the
reference's own, so results are identical, not merely close.

* p_mult(p_gate): the exhaustive single-fault masking fraction alpha (the
  fraction of gate positions whose single fault corrupts the product,
  measured once with fault_gate = arange(G)) extrapolates
      p_mult ~= 1 - (1 - alpha * p_gate)^G.
* TMR: a voted output bit fails if >= 2 copies err on that bit, or voting
  itself errs, from the same per-copy failure probability and the
  voting-gate count (2 gates per output bit, non-ideal).
* NN feed-forward (Fig. 4 bottom): with M multiplications per sample and
  masking fraction p_mask (G. Li et al.: 0.03% for AlexNet),
      p_misclassify = 1 - (1 - p_mask * p_mult)^M.
* Weight degradation (Fig. 5): accessing a bit corrupts it w.p. p_input per
  batch; a 32-bit weight survives a batch w.p. (1-p_input)^32; over T batches
  p_corrupt(T) = 1 - (1-q)^T.  With diagonal ECC scrubbed every batch, a
  block of m*m bits fails only on >= 2 errors per scrub interval.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np

__all__ = [
    "AlexNetCaseStudy", "p_mult_from_alpha", "p_mult_tmr",
    "nn_misclassification", "weight_corruption_baseline",
    "weight_corruption_ecc", "weight_corruption_ecc_refined",
    "expected_corrupted_weights", "ScrubTrajectory", "expected_scrub_rates",
]


@dataclasses.dataclass(frozen=True)
class AlexNetCaseStudy:
    """Constants from paper §VI (FloatPIM + AlexNet + ImageNet)."""

    M: float = 612e6          # multiplications per sample
    W: float = 62e6           # weights
    p_mask: float = 0.0003    # fraction of mult errors that flip classification
    inherent_error: float = 0.27  # AlexNet top-1 error (paper: ~27%)
    bits_per_weight: int = 32


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


def nn_misclassification(p_mult: np.ndarray, cs: AlexNetCaseStudy = AlexNetCaseStudy()) -> np.ndarray:
    """P[soft-error-induced misclassification of one sample] (Fig. 4 bottom)."""
    p_mult = np.asarray(p_mult, dtype=np.float64)
    # log1p form to stay stable for tiny probabilities at M = 6.1e8
    return -np.expm1(cs.M * np.log1p(-cs.p_mask * p_mult))


def weight_corruption_baseline(p_input: float, T: np.ndarray,
                               cs: AlexNetCaseStudy = AlexNetCaseStudy()) -> np.ndarray:
    """P[a given weight is corrupted after T batches], no ECC."""
    T = np.asarray(T, dtype=np.float64)
    q = -math.expm1(cs.bits_per_weight * math.log1p(-p_input))  # per-batch
    return -np.expm1(T * np.log1p(-q))


def weight_corruption_ecc(p_input: float, T: np.ndarray, m: int = 16,
                          cs: AlexNetCaseStudy = AlexNetCaseStudy()) -> np.ndarray:
    """P[a given weight is corrupted after T batches] with diagonal ECC,
    scrubbed every batch: a block (m*m bits) fails only if >= 2 of its bits
    flip within one scrub interval; the failing block corrupts the weights
    stored in it (bits_per_weight of its m*m bits belong to this weight)."""
    T = np.asarray(T, dtype=np.float64)
    n = m * m
    # P[>= 2 errors in a block in one batch]
    log_p0 = n * math.log1p(-p_input)
    p0 = math.exp(log_p0)
    p1 = n * p_input * math.exp((n - 1) * math.log1p(-p_input))
    p_block_fail = max(0.0, 1.0 - p0 - p1)
    # conservative: a block failure corrupts every weight stored in it
    p_weight_per_batch = p_block_fail
    return -np.expm1(T * np.log1p(-min(p_weight_per_batch, 1.0)))


def weight_corruption_ecc_refined(p_input: float, T: np.ndarray, m: int = 16,
                                  cs: AlexNetCaseStudy = AlexNetCaseStudy()) -> np.ndarray:
    """Refined ECC model: the *specific* weight is corrupted only if at least
    one of its own bits flips while the block is uncorrectable, i.e.
    (>=1 error in the weight's w bits) AND (>=1 more error elsewhere in the
    block), or >=2 errors within the weight itself.  First-order in p_input^2:

        p ~ w*p * (n-w)*p + C(w,2) p^2
    """
    T = np.asarray(T, dtype=np.float64)
    n, w = m * m, cs.bits_per_weight
    p = p_input
    p_weight_per_batch = w * p * (n - w) * p + (w * (w - 1) / 2) * p * p
    return -np.expm1(T * np.log1p(-min(p_weight_per_batch, 1.0)))


def expected_corrupted_weights(p_corrupt: np.ndarray,
                               cs: AlexNetCaseStudy = AlexNetCaseStudy()) -> np.ndarray:
    """E[# corrupted weights] (Fig. 5 y-axis)."""
    return cs.W * np.asarray(p_corrupt, dtype=np.float64)


# --------------------------------------------------------------------------
# scrub-engine telemetry (§IV mechanism observed live in the runtime)
# --------------------------------------------------------------------------

def expected_scrub_rates(p_bit: float, n_blocks: int,
                         words_per_block: int = 32,
                         bits_per_word: int = 32) -> Dict[str, float]:
    """Per-scrub expectations for the word-level code under iid bit flips.

    A 32-word block holds n = 32*32 data bits.  With per-bit flip
    probability p per scrub interval: a block is corrected if exactly one
    bit flipped, uncorrectable if >= 2 flipped (parity-word flips are not
    injected by inject_bit_flips, so parity_fixed ~ 0).
    """
    n = words_per_block * bits_per_word
    log_p0 = n * math.log1p(-p_bit) if p_bit < 1 else -math.inf
    p0 = math.exp(log_p0)
    p1 = n * p_bit * math.exp((n - 1) * math.log1p(-p_bit)) if p_bit < 1 else 0.0
    return {
        "corrected_per_scrub": n_blocks * p1,
        "uncorrectable_per_scrub": n_blocks * max(0.0, 1.0 - p0 - p1),
    }


@dataclasses.dataclass
class ScrubTrajectory:
    """Accumulates ScrubReport telemetry from the runtime loop and compares
    the observed correction stream against the closed-form model above."""

    n_blocks: int = 0
    steps: list = dataclasses.field(default_factory=list)
    corrected: list = dataclasses.field(default_factory=list)
    parity_fixed: list = dataclasses.field(default_factory=list)
    uncorrectable: list = dataclasses.field(default_factory=list)

    def add(self, step: int, corrected: int, parity_fixed: int,
            uncorrectable: int) -> None:
        self.steps.append(int(step))
        self.corrected.append(int(corrected))
        self.parity_fixed.append(int(parity_fixed))
        self.uncorrectable.append(int(uncorrectable))

    @property
    def n_scrubs(self) -> int:
        return len(self.steps)

    def totals(self) -> Dict[str, int]:
        return {"corrected": sum(self.corrected),
                "parity_fixed": sum(self.parity_fixed),
                "uncorrectable": sum(self.uncorrectable)}

    def observed_flip_rate(self) -> float:
        """MLE of the per-bit flip rate from the correction stream (valid in
        the sparse regime where nearly all flips are single-bit/block)."""
        if not self.n_scrubs or not self.n_blocks:
            return 0.0
        bits_scanned = self.n_scrubs * self.n_blocks * 32 * 32
        flips = sum(self.corrected) + 2 * sum(self.uncorrectable)
        return flips / bits_scanned

    def rate_per_scrub(self) -> float:
        """Observed correction *events* per scrub interval: corrected words
        plus double-weighted uncorrectable blocks (the flips-observed
        accounting shared with `observed_flip_rate` and the runtime's
        `obs.DriftDetector`)."""
        if not self.n_scrubs:
            return 0.0
        return (sum(self.corrected)
                + 2 * sum(self.uncorrectable)) / self.n_scrubs

    def drift_ratio(self, p_bit: float) -> float:
        """Observed-over-expected event rate for a known injection rate
        (1.0 = on-model).  Infinity when corrections appear with no model
        prior; 1.0 when both sides are silent."""
        observed = self.rate_per_scrub()
        if p_bit <= 0 or not self.n_blocks:
            return float("inf") if observed > 0 else 1.0
        exp = expected_scrub_rates(p_bit, self.n_blocks)
        expected = (exp["corrected_per_scrub"]
                    + 2 * exp["uncorrectable_per_scrub"])
        if expected == 0:
            return float("inf") if observed > 0 else 1.0
        return observed / expected

    def summary(self, p_bit: float = 0.0) -> Dict[str, float]:
        out: Dict[str, float] = dict(self.totals())
        out["n_scrubs"] = self.n_scrubs
        out["observed_flip_rate"] = self.observed_flip_rate()
        if p_bit > 0 and self.n_blocks:
            exp = expected_scrub_rates(p_bit, self.n_blocks)
            out["expected_corrected_per_scrub"] = exp["corrected_per_scrub"]
            out["expected_uncorrectable_per_scrub"] = exp["uncorrectable_per_scrub"]
            out["drift_ratio"] = self.drift_ratio(p_bit)
        return out
