"""On-device telemetry (port of `repro.obs`: the registry, latency tails,
the tracer and the drift detector).

* `MetricsRegistry` / `SCHEMA` -- named, schema-validated on-device
  counters; `fetch_telemetry` is the single device->host transfer;
  `ScrubMetrics` is one scrub interval's fetched record.
* `Tracer` -- span-based tracing: Chrome-trace JSON plus a JSONL metrics
  log, no device syncs.
* `LatencyTimeline` / `Histogram` -- TTFT/TPOT tails from host timestamps.
* `count_host_transfers` -- the transfer guard: counts the host reads of
  a region (one per `fetch_telemetry`).
* `DriftDetector` -- observed correction rates against the closed-form
  model, the sensor of the adaptive scrub controller.
"""
from .drift import DriftDetector, DriftStatus
from .guard import TransferLedger, count_host_transfers
from .latency import Histogram, LatencyTimeline
from .registry import (DEFAULT_REGISTRY, SCHEMA, MetricSpec, MetricsRegistry,
                       ScrubMetrics, fetch_telemetry)
from .trace import NULL_TRACER, Tracer

__all__ = [
    "DEFAULT_REGISTRY", "SCHEMA", "MetricSpec", "MetricsRegistry",
    "fetch_telemetry", "ScrubMetrics",
    "Tracer", "NULL_TRACER",
    "Histogram", "LatencyTimeline",
    "DriftDetector", "DriftStatus",
    "TransferLedger", "count_host_transfers",
]
