"""Latency tails: TTFT/TPOT histograms from host timestamps (port of
`repro.obs.latency`, numpy only).

The server's batcher marks a request's `LatencyTimeline` after each launch
that makes its tokens available: a `torch.cuda.synchronize` (a sync point,
not a device->host data transfer) followed by a `time.perf_counter()`
read.  From the marks:

* **TTFT** -- the first mark (admission prefill + first token);
* **TPOT** -- per-token-position deltas from the remaining marks, one
  sample per token position so chunk sizes weight correctly;
* `Histogram` -- p50/p95/p99 tails over any sample stream.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["Histogram", "LatencyTimeline"]


class Histogram:
    """A sample accumulator with percentile tails.  Keeps raw samples
    (serving horizons are small — thousands of tokens, not billions); the
    summary reports p50/p95/p99, mean, and extremes."""

    def __init__(self, samples: Optional[Sequence[float]] = None):
        self._samples: List[float] = (
            [float(v) for v in samples] if samples is not None else [])

    def record(self, value: float) -> None:
        self._samples.append(float(value))

    def extend(self, values: Sequence[float]) -> None:
        self._samples.extend(float(v) for v in values)

    def merge(self, other: "Histogram") -> "Histogram":
        return Histogram(self._samples + other._samples)

    def __len__(self) -> int:
        return len(self._samples)

    @property
    def samples(self) -> np.ndarray:
        return np.asarray(self._samples, dtype=np.float64)

    def percentile(self, q: float) -> float:
        if not self._samples:
            return float("nan")
        return float(np.percentile(self.samples, q))

    def summary(self) -> Dict[str, float]:
        if not self._samples:
            return {"count": 0}
        s = self.samples
        return {"count": len(s), "mean": float(s.mean()),
                "min": float(s.min()), "max": float(s.max()),
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


@dataclasses.dataclass
class LatencyTimeline:
    """Per-chunk completion timestamps for one generation.

    `begin()` starts the clock, `mark(tokens)` records that `tokens` more
    token positions became available (host wall time, no transfers).
    """

    start: Optional[float] = None
    marks: List[tuple] = dataclasses.field(default_factory=list)

    def begin(self) -> None:
        self.start = time.perf_counter()
        self.marks = []

    def mark(self, tokens: int) -> None:
        if self.start is None:
            raise RuntimeError("LatencyTimeline.mark() before begin()")
        self.marks.append((time.perf_counter(), int(tokens)))

    # -- derived tails -----------------------------------------------------

    @property
    def ttft_s(self) -> float:
        """Time to first token: start -> first mark."""
        if self.start is None or not self.marks:
            return float("nan")
        return self.marks[0][0] - self.start

    def tpot_samples(self) -> np.ndarray:
        """Per-token-position seconds after the first mark: each chunk of
        n tokens taking dt contributes n samples of dt/n, so percentiles
        weight by tokens, not by launches."""
        out: List[float] = []
        for (t_prev, _), (t, n) in zip(self.marks, self.marks[1:]):
            if n > 0:
                out.extend([(t - t_prev) / n] * n)
        return np.asarray(out, dtype=np.float64)

    def total_s(self) -> float:
        if self.start is None or not self.marks:
            return float("nan")
        return self.marks[-1][0] - self.start

    def tokens(self) -> int:
        return sum(n for _, n in self.marks)

    def histograms(self) -> Dict[str, Histogram]:
        return {"ttft_s": Histogram([self.ttft_s]),
                "tpot_s": Histogram(self.tpot_samples())}

    def summary(self) -> Dict[str, float]:
        tpot = Histogram(self.tpot_samples())
        out = {"ttft_s": self.ttft_s, "total_s": self.total_s(),
               "tokens": self.tokens()}
        for k, v in tpot.summary().items():
            out[f"tpot_{k}" if not k.startswith("tpot") else k] = v
        return out
