"""Heartbeat / straggler / integrity monitoring (port of
`repro.runtime.monitor`; host logic, no tensors).

At 1000+ nodes the failure model is: slow nodes (stragglers), dead nodes
(preemption/hardware), and silent data corruption (the paper's subject).
The monitor tracks per-step wall times, flags statistical stragglers,
ingests the scrub engine's ScrubReport telemetry, and exposes a decision:
CONTINUE / CHECKPOINT_NOW / RESTART.  An uncorrectable ECC block is the one
signal that demands RESTART — the stored weights are known-corrupt beyond
repair, so the only safe move is a checkpoint restore.  In a real
deployment the same policy runs per-host and feeds the cluster scheduler;
here it drives the TrainLoop's simulated fault handling and is unit-tested.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from ..obs import DriftDetector, ScrubMetrics

__all__ = ["HeartbeatMonitor", "StragglerPolicy", "Decision"]


class Decision:
    CONTINUE = "continue"
    CHECKPOINT_NOW = "checkpoint_now"
    RESTART = "restart"


@dataclasses.dataclass
class StragglerPolicy:
    window: int = 32            # steps in the rolling window
    slow_factor: float = 2.0    # step slower than factor x median -> straggler
    max_consecutive_slow: int = 5
    heartbeat_timeout_s: float = 300.0


class HeartbeatMonitor:
    def __init__(self, policy: StragglerPolicy = StragglerPolicy(),
                 drift: Optional[DriftDetector] = None):
        self.policy = policy
        self.times: Deque[float] = deque(maxlen=policy.window)
        self.consecutive_slow = 0
        self.last_heartbeat = time.monotonic()
        self.flags: List[str] = []
        self.scrubs = 0
        self.bits_corrected = 0
        self.parity_fixed = 0
        self.uncorrectable = 0
        self.vote_disagreements = 0
        self.faults_injected = 0
        #: optional obs.DriftDetector — observed correction rates vs the
        #: closed-form model; attached by TrainLoop.attach_scheme when the
        #: loop injects at a known p_bit (or set directly)
        self.drift = drift
        self._was_drifting = False

    def record_step(self, seconds: float) -> str:
        self.last_heartbeat = time.monotonic()
        med = self.median()
        self.times.append(seconds)
        if med is not None and seconds > self.policy.slow_factor * med:
            self.consecutive_slow += 1
            self.flags.append(f"straggler step ({seconds:.3f}s vs median {med:.3f}s)")
        else:
            self.consecutive_slow = 0
        if self.consecutive_slow >= self.policy.max_consecutive_slow:
            # persistent slowness: snapshot so the scheduler can migrate us
            return Decision.CHECKPOINT_NOW
        return Decision.CONTINUE

    def record_scrub(self, record: ScrubMetrics) -> str:
        """Ingest one scrub interval's `obs.ScrubMetrics`; uncorrectable
        blocks demand RESTART."""
        self.scrubs += 1
        self.bits_corrected += record.corrected
        self.parity_fixed += record.parity_fixed
        self.uncorrectable += record.uncorrectable
        self.vote_disagreements += record.vote_disagreements
        self.faults_injected += record.injected
        if self.drift is not None:
            status = self.drift.observe(record.corrected,
                                        record.uncorrectable)
            if status.drifting and not self._was_drifting:
                self.flags.append(
                    f"correction-rate drift: observed "
                    f"{status.observed_per_scrub:.3g}/scrub vs expected "
                    f"{status.expected_per_scrub:.3g} "
                    f"({'hot' if status.hot else 'cold'})")
            self._was_drifting = status.drifting
        if record.uncorrectable > 0:
            self.flags.append(
                f"uncorrectable ECC: {record.uncorrectable} blocks")
            return Decision.RESTART
        return Decision.CONTINUE

    def heartbeat_ok(self) -> bool:
        return (time.monotonic() - self.last_heartbeat) < self.policy.heartbeat_timeout_s

    def median(self) -> Optional[float]:
        if not self.times:
            return None
        s = sorted(self.times)
        return s[len(s) // 2]

    def summary(self) -> Dict:
        out = {"median_step_s": self.median(),
               "consecutive_slow": self.consecutive_slow,
               "n_flags": len(self.flags),
               "scrubs": self.scrubs,
               "bits_corrected": self.bits_corrected,
               "parity_fixed": self.parity_fixed,
               "uncorrectable": self.uncorrectable,
               "vote_disagreements": self.vote_disagreements,
               "faults_injected": self.faults_injected}
        if self.drift is not None:
            out["drift"] = self.drift.status().as_dict()
        return out
