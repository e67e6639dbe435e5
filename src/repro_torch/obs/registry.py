"""The metrics registry: one fixed, named schema for every on-device
reliability counter (port of `repro.obs.registry`, without the mesh
reduction).

Every metric has a name, a kind (``counter`` | ``series`` | ``gauge``) and
a docstring, and `fetch` refuses unknown names, so a telemetry dict that
reaches the host is interpretable.  Metrics accumulate on the device --
`zeros()` builds the int32 accumulator dict, `accumulate()` adds counter
updates and stacks series updates as device ops -- and `fetch()` moves
the whole dict to the host in ONE transfer after timing stops.  Nothing
here synchronises implicitly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["MetricSpec", "MetricsRegistry", "SCHEMA", "DEFAULT_REGISTRY",
           "fetch_telemetry", "ScrubMetrics"]

KINDS = ("counter", "series", "gauge")


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One named metric: ``counter`` accumulates by integer addition,
    ``series`` stacks per-step samples along axis 0, ``gauge`` holds the
    last written value."""

    name: str
    kind: str = "counter"
    doc: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"metric kind must be one of {KINDS}, "
                             f"got {self.kind!r}")


#: The fixed schema, the reference's names and kinds in the reference's
#: order.
SCHEMA: Tuple[MetricSpec, ...] = (
    MetricSpec("ecc_corrected", "counter",
               "arena words corrected by the diagonal-parity code"),
    MetricSpec("ecc_parity_fixed", "counter",
               "parity-word (check-row) flips repaired during scrub"),
    MetricSpec("ecc_uncorrectable", "counter",
               "blocks with >= 2 flips -- beyond the single-error code"),
    MetricSpec("ecc_injected", "counter",
               "bit flips injected by the fused inject+scrub kernel"),
    # write-back-on-read serving: corrections on the read path (pages
    # repaired before the tick reads them), kept apart from the scrub
    # counters so the two disciplines stay attributable
    MetricSpec("ecc_read_corrected", "counter",
               "arena words corrected by write-back-on-read page repair"),
    MetricSpec("ecc_read_parity_fixed", "counter",
               "parity rows healed on the write-back-on-read path"),
    MetricSpec("ecc_read_uncorrectable", "counter",
               "uncorrectable blocks encountered on the read path"),
    MetricSpec("tmr_step_disagreements", "series",
               "per-decode-step token positions where the 3 copies differ"),
    MetricSpec("tmr_final_disagreements", "counter",
               "token positions voted on in the final sequences"),
    MetricSpec("faults_injected", "counter",
               "fault-model corruption events applied to held data copies"),
    MetricSpec("tokens_emitted", "counter",
               "tokens produced by the generation engine"),
    MetricSpec("mmpu_cycles_per_token", "gauge",
               "projected mMPU occupancy cycles per emitted token"),
    MetricSpec("mmpu_energy_pj_per_token", "gauge",
               "projected mMPU switching energy (pJ) per emitted token"),
    MetricSpec("mmpu_events", "gauge",
               "compiled MmpuEvent bundles in the step's event stream"),
)


class MetricsRegistry:
    """Schema-validated registry of on-device metrics (see module doc)."""

    def __init__(self, schema: Iterable[MetricSpec] = SCHEMA):
        self._by_name: Dict[str, MetricSpec] = {}
        for spec in schema:
            if spec.name in self._by_name:
                raise ValueError(f"duplicate metric name {spec.name!r}")
            self._by_name[spec.name] = spec

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self._by_name)

    def spec(self, name: str) -> MetricSpec:
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(
                f"unknown metric {name!r}; the schema defines "
                f"{sorted(self._by_name)} (extend obs.registry.SCHEMA to "
                f"add metrics -- ad-hoc telemetry keys are rejected)"
            ) from None

    def validate(self, telemetry: Mapping[str, Any]) -> None:
        for name in telemetry:
            self.spec(name)

    # -- device-side accumulation -------------------------------------------

    def zeros(self, names: Optional[Iterable[str]] = None,
              device: Any = "cpu") -> Dict[str, torch.Tensor]:
        """Fresh accumulator dict on `device`: int32 zero scalars for
        counters/gauges, empty (0,) int32 tensors for series."""
        out: Dict[str, torch.Tensor] = {}
        for name in (names if names is not None else self.names):
            shape = (0,) if self.spec(name).kind == "series" else ()
            out[name] = torch.zeros(shape, dtype=torch.int32, device=device)
        return out

    def accumulate(self, metrics: Mapping[str, torch.Tensor],
                   updates: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """Fold `updates` into a new dict -- counter adds, series
        concatenation, gauge overwrite -- all device ops."""
        self.validate(updates)
        out = dict(metrics)
        for name, val in updates.items():
            kind = self.spec(name).kind
            val = torch.as_tensor(val)
            if kind == "series":
                val = torch.atleast_1d(val)
                out[name] = (torch.cat([out[name], val.to(out[name].dtype)])
                             if name in out else val)
            elif kind == "gauge" or name not in out:
                out[name] = val
            else:
                out[name] = out[name] + val
        return out

    def from_report(self, report: Any,
                    injected: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
        """A `core.reliability.ScrubReport`'s device counters under the
        schema's names; `injected` adds the inject_scrub kernel's fourth
        counter when there is one."""
        out = {"ecc_corrected": report.corrected,
               "ecc_parity_fixed": report.parity_fixed,
               "ecc_uncorrectable": report.uncorrectable}
        if injected is not None:
            out["ecc_injected"] = injected
        return out

    def psum(self, metrics: Mapping[str, torch.Tensor], mesh,
             axes: Any) -> Dict[str, torch.Tensor]:
        """Cross-rank reduce (the reference's psum inside a shard_map
        body): every counter summed over the ranks of `mesh`'s `axes` by
        an integer all-reduce, so the totals equal the single-device
        counts bit for bit (DESIGN.md §14).  Returns new tensors; the
        inputs stay as they were."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        out = {}
        for k, v in metrics.items():
            v = torch.as_tensor(v)
            if v.is_floating_point():
                raise TypeError(f"psum sums integer counters; {k!r} is "
                                f"{v.dtype}")
            out[k] = mesh.all_reduce(v.clone(), axes)
        return out

    # -- the single host sync -------------------------------------------------

    def fetch(self, telemetry: Mapping[str, Any]) -> Dict[str, np.ndarray]:
        """THE device->host transfer: schema-validate, then move every
        device counter to the host in one copy (integers as int64, floats
        as float64, each kind concatenated once); host values pass
        through as numpy."""
        self.validate(telemetry)
        out: Dict[str, np.ndarray] = {}
        groups: Dict[bool, list] = {}
        for k, v in telemetry.items():
            if isinstance(v, torch.Tensor):
                groups.setdefault(v.is_floating_point(), []).append(k)
            else:
                out[k] = np.asarray(v)
        for is_float, keys in groups.items():
            dt = torch.float64 if is_float else torch.int64
            flat = torch.cat([telemetry[k].reshape(-1).to(dt) for k in keys])
            host, at = flat.cpu().numpy(), 0
            for k in keys:
                shape = tuple(telemetry[k].shape)
                n = int(np.prod(shape)) if shape else 1
                out[k] = host[at:at + n].reshape(shape)
                at += n
        return {k: out[k] for k in telemetry}


DEFAULT_REGISTRY = MetricsRegistry()


def fetch_telemetry(telemetry: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Schema-validated single-transfer fetch against the default
    registry."""
    return DEFAULT_REGISTRY.fetch(telemetry)



@dataclasses.dataclass(frozen=True)
class ScrubMetrics:
    """Host-side record of one scrub interval: what
    `runtime.HeartbeatMonitor` ingests and the drift detector samples."""

    corrected: int
    parity_fixed: int = 0
    uncorrectable: int = 0
    injected: int = 0
    vote_disagreements: int = 0

    @classmethod
    def from_fetched(cls, stats: Mapping[str, Any]) -> "ScrubMetrics":
        """Build from an already-fetched telemetry dict (schema names);
        array values (a series) are summed."""
        def get(name):
            return int(np.asarray(stats.get(name, 0)).sum())
        return cls(corrected=get("ecc_corrected"),
                   parity_fixed=get("ecc_parity_fixed"),
                   uncorrectable=get("ecc_uncorrectable"),
                   injected=get("ecc_injected"),
                   vote_disagreements=get("tmr_final_disagreements")
                   + get("tmr_step_disagreements"))
