"""Telemetry-driven adaptive scrub controller (port of
`repro.runtime.adaptive`; host logic, no tensors).

Fixed-interval scrubbing prices reliability at the *worst-case* fault
rate: a serving engine scrubbing every N ticks pays the same maintenance
tax whether the device is storming or silent.  The controller here makes
scrub cadence **pay-as-you-fault**: it watches the correction counts each
scrub actually returns and moves the interval inside
``[min_interval, max_interval]`` with a hysteresis band —

* ``events > high_events`` (or ANY uncorrectable block) — the store is
  hotter than one scrub per interval can absorb: **halve** the interval
  immediately.  Uncorrectables slam regardless of the band because every
  missed one is a potential silent corruption (SEC codes) or a restore
  (the runtime's RESTART path).
* ``events < low_events`` for ``patience`` consecutive scrubs — the
  store is quiet: **double** the interval.  The patience streak is the
  hysteresis; a single quiet scrub after a storm never relaxes cadence.
* otherwise the interval holds and the quiet streak resets.

``events`` is the drift detector's accounting: one corrected word, or
two per uncorrectable block (`obs.DriftDetector`, `ScrubTrajectory`).

The controller is **deterministic and replay-exact**: its state is a
pure function of the configuration and the sequence of
``record(index, counts)`` calls, with no clocks or randomness, so a
replay that presents the same counts at the same indices reproduces the
same scrub schedule bit-for-bit (tests/test_torch_adaptive.py holds it
against the reference's on the same record sequences).  Scrub *decisions*
happen on the host — the controller never traces into jit.

Priors: `from_prior(p_bit, n_blocks)` seeds the initial interval from
the closed-form expectation (`core.analytics.expected_scrub_rates`) so a
run with a known fault-rate estimate starts near its steady state, and
`from_trajectory` replays a finished run's `ScrubTrajectory` as the
prior — yesterday's telemetry is today's interval0.  An optional
`obs.DriftDetector` gates *relaxation*: while the detector's verdict is
hot (observed corrections running above the model with enough evidence),
the controller refuses to lengthen the interval even through a lucky
quiet streak.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

__all__ = ["AdaptiveScrubConfig", "AdaptiveScrub"]


@dataclasses.dataclass(frozen=True)
class AdaptiveScrubConfig:
    """Controller law parameters (hysteresis band + bounds).

    interval0     : initial scrub interval (ticks/steps between scrubs).
    min_interval  : floor — the storm-mode cadence.
    max_interval  : ceiling — how far a silent store may back off.
    low_events    : quiet threshold (events/scrub) for lengthening.
    high_events   : hot threshold (events/scrub) for immediate halving.
    patience      : consecutive quiet scrubs required before lengthening
                    (the hysteresis width).
    """

    interval0: int = 32
    min_interval: int = 1
    max_interval: int = 1024
    low_events: float = 0.5
    high_events: float = 4.0
    patience: int = 3

    def __post_init__(self):
        if not (1 <= self.min_interval <= self.interval0
                <= self.max_interval):
            raise ValueError(
                f"need 1 <= min_interval <= interval0 <= max_interval: "
                f"{self}")
        if self.low_events > self.high_events:
            raise ValueError(f"low_events > high_events: {self}")
        if self.patience < 1:
            raise ValueError(f"patience must be >= 1: {self}")


class AdaptiveScrub:
    """Hysteresis-bounded scrub-interval controller (module doc).

    Protocol, from the owning loop/scheduler::

        ctl = AdaptiveScrub.from_prior(p_bit, n_blocks)
        ...
        if ctl.due(index):                   # index = step/tick counter
            counts = pool.scrub()            # or scheme.scrub(...)
            ctl.record(index, corrected, uncorrectable)

    `due` is pure (no state change); `record` applies the law and
    schedules the next scrub at ``index + interval``.
    """

    def __init__(self, cfg: AdaptiveScrubConfig = AdaptiveScrubConfig(),
                 detector=None, feed_detector: bool = True):
        self.cfg = cfg
        self.detector = detector        # optional obs.DriftDetector
        #: does `record` ingest counts into the detector?  Set False when
        #: another consumer (`HeartbeatMonitor.record_scrub`) already feeds
        #: the same detector instance, or every scrub would count twice in
        #: its window
        self.feed_detector = feed_detector
        self.interval = cfg.interval0
        self._next = cfg.interval0
        self._quiet = 0
        #: (index, events, interval-after-update) per recorded scrub
        self.history: List[Tuple[int, float, int]] = []

    # -- priors ---------------------------------------------------------------

    @classmethod
    def from_prior(cls, p_bit: float, n_blocks: int, *,
                   target_events: float = 2.0, detector=None,
                   feed_detector: bool = True,
                   **cfg_kw) -> "AdaptiveScrub":
        """Seed interval0 from the closed-form fault model: pick the
        interval whose expected events/scrub sits mid-band
        (``target_events``), assuming one model exposure unit per
        step/tick.  Unknown or zero p_bit keeps the configured default."""
        cfg = AdaptiveScrubConfig(**cfg_kw)
        per_step = _expected_events_per_exposure(p_bit, n_blocks)
        if per_step > 0:
            i0 = max(cfg.min_interval,
                     min(cfg.max_interval,
                         int(round(target_events / per_step)) or 1))
            cfg = dataclasses.replace(cfg, interval0=i0)
        return cls(cfg, detector=detector, feed_detector=feed_detector)

    @classmethod
    def from_trajectory(cls, trajectory, *, target_events: float = 2.0,
                        detector=None, feed_detector: bool = True,
                        **cfg_kw) -> "AdaptiveScrub":
        """Seed interval0 from a finished run's observed correction
        stream (`core.analytics.ScrubTrajectory`): events per recorded
        step become the exposure rate the prior interval is sized for."""
        cfg = AdaptiveScrubConfig(**cfg_kw)
        steps = list(getattr(trajectory, "steps", ()))
        if steps:
            span = max(steps) - min(steps) + 1
            events = (sum(trajectory.corrected)
                      + 2.0 * sum(trajectory.uncorrectable))
            per_step = events / span if span > 0 else 0.0
            if per_step > 0:
                i0 = max(cfg.min_interval,
                         min(cfg.max_interval,
                             int(round(target_events / per_step)) or 1))
                cfg = dataclasses.replace(cfg, interval0=i0)
        return cls(cfg, detector=detector, feed_detector=feed_detector)

    # -- the law --------------------------------------------------------------

    @property
    def next_due(self) -> int:
        """The index at which the next scrub fires."""
        return self._next

    def due(self, index: int) -> bool:
        """Should the caller scrub at this step/tick?  Pure — repeated
        calls at the same index agree."""
        return index >= self._next

    def record(self, index: int, corrected: int, uncorrectable: int = 0,
               parity_fixed: int = 0) -> int:
        """Ingest one scrub's fetched counts, apply the hysteresis law,
        and schedule the next scrub.  Returns the (possibly updated)
        interval.  ``parity_fixed`` is accepted for report-shape
        uniformity; parity-row heals are maintenance, not data events,
        so they never move the interval."""
        events = float(corrected) + 2.0 * float(uncorrectable)
        if self.detector is not None and self.feed_detector:
            self.detector.observe(int(corrected), int(uncorrectable))
        if uncorrectable > 0 or events > self.cfg.high_events:
            self.interval = max(self.cfg.min_interval, self.interval // 2)
            self._quiet = 0
        elif events < self.cfg.low_events:
            self._quiet += 1
            if self._quiet >= self.cfg.patience and not self._hot():
                self.interval = min(self.cfg.max_interval,
                                    self.interval * 2)
                self._quiet = 0
        else:
            self._quiet = 0
        self._next = index + self.interval
        self.history.append((int(index), events, self.interval))
        return self.interval

    def _hot(self) -> bool:
        """Drift-detector veto on relaxation: only an *evidenced* hot
        verdict blocks (DriftStatus.hot requires the evidence floor —
        `DriftDetector.confident` — by construction, so cold-start
        windows never pin the interval)."""
        return self.detector is not None and self.detector.status().hot

    def summary(self) -> dict:
        """Host-side summary for logs/benchmarks."""
        return {"interval": self.interval, "next_due": self._next,
                "n_scrubs": len(self.history),
                "intervals": [i for _, _, i in self.history]}


def _expected_events_per_exposure(p_bit: float, n_blocks: int) -> float:
    """Expected correction events from ONE exposure unit (dt=1) over an
    n_blocks arena — the drift detector's events accounting applied to
    `expected_scrub_rates`."""
    if not p_bit or p_bit <= 0 or n_blocks <= 0:
        return 0.0
    from ..core.analytics import expected_scrub_rates
    exp = expected_scrub_rates(p_bit, n_blocks)
    return (exp["corrected_per_scrub"]
            + 2.0 * exp["uncorrectable_per_scrub"])
