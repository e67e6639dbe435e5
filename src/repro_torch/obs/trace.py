"""Span-based launch tracing: a Chrome-trace (Perfetto-loadable) timeline
plus a JSONL metrics log, with zero device syncs (port of
`repro.obs.trace`; no framework imports).

Spans are host wall-time brackets around launches -- prepare, warmup,
serve, telemetry fetch -- recorded with `time.perf_counter()` and a list
append.  Nothing here touches a device tensor, so tracing never adds a
host sync to a timed region.

    tracer = Tracer()
    with tracer.trace("serve", requests=8):
        results = batcher.run(trace, realtime=True)
    tracer.write_chrome("trace.json")        # load in Perfetto / chrome://tracing
    tracer.write_jsonl("metrics.jsonl")

A disabled tracer (``Tracer(enabled=False)``, or the shared `NULL_TRACER`)
makes every call a no-op, so instrumented paths cost a truthiness check
when observability is off.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

__all__ = ["Tracer", "NULL_TRACER"]


class Tracer:
    """Collects Chrome-trace events (complete spans, instants, counters)
    and JSONL metric records.  Thread-safe appends; write once at exit."""

    def __init__(self, enabled: bool = True, pid: int = 0):
        self.enabled = enabled
        self.pid = pid if pid else os.getpid()
        self.events: List[Dict[str, Any]] = []
        self.records: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _tid(self) -> int:
        return threading.get_ident() % 2 ** 31

    # -- event emission ----------------------------------------------------

    @contextlib.contextmanager
    def trace(self, name: str, **args: Any):
        """Span a region: emits one Chrome complete ('ph': 'X') event."""
        if not self.enabled:
            yield self
            return
        ts = self._now_us()
        try:
            yield self
        finally:
            dur = self._now_us() - ts
            with self._lock:
                self.events.append(
                    {"name": name, "ph": "X", "ts": ts, "dur": dur,
                     "pid": self.pid, "tid": self._tid(),
                     **({"args": args} if args else {})})

    def instant(self, name: str, **args: Any) -> None:
        """A zero-duration marker (heartbeats, decisions, restores)."""
        if not self.enabled:
            return
        with self._lock:
            self.events.append(
                {"name": name, "ph": "i", "s": "t", "ts": self._now_us(),
                 "pid": self.pid, "tid": self._tid(),
                 **({"args": args} if args else {})})

    def counter(self, name: str, value: float) -> None:
        """A Chrome counter track sample (step times, correction counts)."""
        if not self.enabled:
            return
        with self._lock:
            self.events.append(
                {"name": name, "ph": "C", "ts": self._now_us(),
                 "pid": self.pid, "tid": 0, "args": {name: float(value)}})

    def metrics(self, record: Dict[str, Any], kind: str = "metrics") -> None:
        """Append one structured record to the JSONL metrics log (fetched
        telemetry snapshots, latency summaries, bench rows)."""
        if not self.enabled:
            return
        with self._lock:
            self.records.append({"t_us": self._now_us(), "kind": kind,
                                 **_jsonable(record)})

    # -- output ------------------------------------------------------------

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace document: valid for Perfetto and
        chrome://tracing (``traceEvents`` array of phase events)."""
        with self._lock:
            return {"traceEvents": list(self.events),
                    "displayTimeUnit": "ms"}

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def write_jsonl(self, path: str,
                    extra: Optional[Iterable[Dict[str, Any]]] = None) -> None:
        with self._lock:
            records = list(self.records)
        if extra:
            records += [_jsonable(r) for r in extra]
        with open(path, "w") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")


def _jsonable(record: Dict[str, Any]) -> Dict[str, Any]:
    """Coerce numpy scalars and arrays (already fetched) to plain JSON
    types; leaves everything else alone."""
    out = {}
    for k, v in record.items():
        if hasattr(v, "tolist"):
            v = v.tolist()
        elif hasattr(v, "item"):
            v = v.item()
        out[k] = v
    return out


#: Shared disabled tracer: instrumented code paths default to this so the
#: no-observability configuration pays only a truthiness check.
NULL_TRACER = Tracer(enabled=False)
