"""Error-rate drift detection: observed correction stream vs the closed
forms (port of `repro.obs.drift`; host logic, no tensors).

The closed-form model (`core.analytics.expected_scrub_rates`) predicts how
many corrections and uncorrectable blocks each scrub interval should see
for a given per-bit fault rate.  The drift detector compares the *observed*
stream against that prior over a rolling window: a store whose correction
rate runs persistently hot signals device degradation (retention drift,
developing stuck-ats — the "threats and solutions" survey's escalation
path) long before an uncorrectable block forces a restore; a rate
persistently cold signals the injection/fault plumbing silently broke.

It is the *sensor* of the adaptive scrub controller
(`runtime.AdaptiveScrub`), which refuses to lengthen the scrub interval
while `DriftStatus.hot`.  It is a health signal, never a hard decision —
uncorrectable blocks keep their own path.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from ..core.analytics import expected_scrub_rates

__all__ = ["DriftDetector", "DriftStatus"]


@dataclasses.dataclass(frozen=True)
class DriftStatus:
    """Observed-vs-expected verdict over the detector's window."""

    observed_per_scrub: float
    expected_per_scrub: float
    ratio: float            # observed / expected (1.0 = on-model)
    n_scrubs: int
    drifting: bool          # outside [1/tol, tol] with enough evidence
    hot: bool               # drifting above the model (degradation signal)

    def as_dict(self) -> Dict[str, float]:
        return {"drift_observed_per_scrub": self.observed_per_scrub,
                "drift_expected_per_scrub": self.expected_per_scrub,
                "drift_ratio": self.ratio,
                "drift_n_scrubs": self.n_scrubs,
                "drifting": self.drifting,
                "drift_hot": self.hot}


class DriftDetector:
    """Rolling-window comparison of observed correction events against
    `expected_scrub_rates(p_bit, n_blocks)`.

    An *event* is one corrected word or (weighted double) one
    uncorrectable block — the same flips-observed accounting as
    `ScrubTrajectory.observed_flip_rate`.  The verdict needs
    `min_events` expected-or-observed events in the window before it can
    flag, so sparse-fault runs (expectation ~0.01 events/scrub) never
    fire spuriously.
    """

    def __init__(self, p_bit: float, n_blocks: int, *,
                 window: int = 32, tol_factor: float = 4.0,
                 min_events: float = 8.0):
        if p_bit < 0:
            raise ValueError("p_bit must be >= 0")
        self.p_bit = float(p_bit)
        self.n_blocks = int(n_blocks)
        self.window = int(window)
        self.tol_factor = float(tol_factor)
        self.min_events = float(min_events)
        exp = expected_scrub_rates(p_bit, n_blocks) if p_bit > 0 else None
        #: expected correction events per scrub under the closed form
        self.expected_per_scrub = (
            exp["corrected_per_scrub"] + 2 * exp["uncorrectable_per_scrub"]
            if exp else 0.0)
        self._events: Deque[float] = deque(maxlen=self.window)

    def observe(self, corrected: int, uncorrectable: int = 0) -> DriftStatus:
        """Ingest one scrub interval's counts and return the verdict."""
        self._events.append(float(corrected) + 2.0 * float(uncorrectable))
        return self.status()

    def evidence(self) -> float:
        """The evidence mass behind the current verdict: the larger of the
        observed and expected per-scrub event rates times the window
        occupancy — the exact quantity `status()` holds against
        ``min_events`` before it may flag.  Exposed so consumers (the
        adaptive scrub controller) can distinguish "on-model" from "too
        early to tell" without re-deriving the floor."""
        n = len(self._events)
        observed = sum(self._events) / n if n else 0.0
        return max(observed, self.expected_per_scrub) * n

    @property
    def confident(self) -> bool:
        """Has the window accumulated enough evidence for `status()` to be
        meaningful?  False during cold start (few scrubs ingested) and for
        sparse-fault runs whose expectation never clears the floor — in
        both cases ``drifting`` is structurally False, and callers making
        *decisions* (not just reading flags) must treat the verdict as
        "unknown", not "healthy"."""
        return self.evidence() >= self.min_events

    def status(self) -> DriftStatus:
        n = len(self._events)
        observed = sum(self._events) / n if n else 0.0
        expected = self.expected_per_scrub
        evidence = max(observed, expected) * n
        if expected > 0:
            ratio = observed / expected
        else:
            # no model prior: any observed corrections are unexplained
            ratio = float("inf") if observed > 0 else 1.0
        drifting = (evidence >= self.min_events
                    and not (1.0 / self.tol_factor <= ratio
                             <= self.tol_factor))
        return DriftStatus(observed_per_scrub=observed,
                           expected_per_scrub=expected,
                           ratio=ratio, n_scrubs=n, drifting=drifting,
                           hot=drifting and ratio > 1.0)

    @classmethod
    def from_trajectory(cls, trajectory, p_bit: float,
                        **kw) -> Tuple["DriftDetector", DriftStatus]:
        """Replay a `core.analytics.ScrubTrajectory` through a fresh
        detector (offline analysis of a finished run)."""
        det = cls(p_bit, trajectory.n_blocks, **kw)
        status = det.status()
        for c, u in zip(trajectory.corrected, trajectory.uncorrectable):
            status = det.observe(c, u)
        return det, status
