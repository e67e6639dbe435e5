"""Cost evaluator: fold MmpuEvent streams into cycles / energy / per-token
(port of `repro.costmodel.evaluate`).

The fold is a weighted dot product over the packed event arrays:

* latency cycles    = sum(count * cycles[kind] * weight)
* occupancy cycles  = sum(count * cycles[kind] * xbars * weight)
* energy (pJ)       = sum(cells * pJ[kind]     * weight)

``cycles_per_token`` reports *occupancy* -- device-normalized crossbar-
cycles -- so a discipline that runs 1x as long on 3x the arrays
(tmr-parallel) costs exactly what one that runs 3x as long on 1x does
(tmr-serial): that matches ``CostReport.latency_x * area_x /
throughput_x`` from ``Scheme.overhead()`` and is the paper's
reliability-vs-throughput axis.  Wall-clock projections use latency.

The fold runs in float64 torch on the caller's device (CUDA unless the
caller asks for the CPU).  The reference folds in float32 (its
``jnp.asarray`` of float64 arrays becomes float32 with x64 off), so the two
agree to float32 rounding, not bit for bit.  :func:`evaluate_grid` folds
the zero-padded (S, N) stack of a whole scheme grid as one batched
reduction.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .device import DeviceSpec
from .events import EventArrays, MmpuEvent, stack_streams

__all__ = ["MmpuCost", "fold", "fold_arrays", "evaluate_grid",
           "project_macs"]

_FIELDS = ("kind", "count", "cells", "xbars", "weight")


@dataclasses.dataclass(frozen=True)
class MmpuCost:
    """Folded cost of one event stream (per `tokens` emitted tokens)."""
    latency_cycles: float     # critical-path device cycles
    occupancy_cycles: float   # crossbar-cycles (latency x arrays occupied)
    energy_pj: float
    tokens: float
    clock_hz: float
    n_events: int

    @property
    def cycles_per_token(self) -> float:
        return self.occupancy_cycles / self.tokens

    @property
    def energy_pj_per_token(self) -> float:
        return self.energy_pj / self.tokens

    @property
    def latency_s(self) -> float:
        return self.latency_cycles / self.clock_hz

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / max(self.latency_s, 1e-30)

    def describe(self) -> str:
        return (f"cycles/token={self.cycles_per_token:.4g} "
                f"energy/token={self.energy_pj_per_token:.4g}pJ "
                f"latency={self.latency_s * 1e3:.4g}ms "
                f"({self.n_events} events)")


def _fold_terms(kind, count, cells, xbars, weight, cycle_vec, energy_vec):
    """Three weighted dots over the last axis of the packed arrays."""
    cyc = cycle_vec[kind] * count * weight
    return (cyc.sum(-1), (cyc * xbars).sum(-1),
            (energy_vec[kind] * cells * weight).sum(-1))


def _fold_tensors(fields: Dict[str, np.ndarray], spec: DeviceSpec, device):
    """(latency, occupancy, energy) float64 tensors of the packed arrays
    `fields` ((N,) or (S, N) each), folded on `device`."""
    dev = resolve_device(device)
    t = {f: torch.as_tensor(np.asarray(fields[f]),
                            dtype=torch.int64 if f == "kind"
                            else torch.float64).to(dev) for f in _FIELDS}
    vec = [torch.tensor(v, dtype=torch.float64, device=dev)
           for v in (spec.cycle_vector(), spec.energy_vector())]
    return _fold_terms(t["kind"], t["count"], t["cells"], t["xbars"],
                       t["weight"], *vec)


def fold_arrays(arrays: EventArrays, spec: DeviceSpec, *,
                tokens: float = 1.0, device=None) -> MmpuCost:
    lat, occ, pj = (float(x) for x in _fold_tensors(
        {f: getattr(arrays, f) for f in _FIELDS}, spec, device))
    return MmpuCost(latency_cycles=lat, occupancy_cycles=occ, energy_pj=pj,
                    tokens=float(tokens), clock_hz=spec.clock_hz,
                    n_events=len(arrays))


def fold(events: Sequence[MmpuEvent], spec: DeviceSpec, *,
         tokens: float = 1.0, device=None) -> MmpuCost:
    """Fold a plain event stream (order-independent by construction)."""
    events = tuple(events)
    return fold_arrays(EventArrays.from_events(events), spec,
                       tokens=tokens, device=device)


def evaluate_grid(schemes: Iterable, profile, spec: DeviceSpec, *,
                  device=None) -> Dict[str, MmpuCost]:
    """Price every scheme's step stream with ONE batched fold.

    Streams are ragged, so they are zero-padded to a common width
    (padding events have count=cells=0 and contribute nothing); the fold
    reduces the (S, N) stack along N in one call and moves the (3, S)
    result to the host once.
    """
    from .compile import lower_step
    schemes = list(schemes)
    streams = [lower_step(s, profile, spec) for s in schemes]
    stacked = stack_streams(streams)
    out3 = torch.stack(_fold_tensors(
        {f: np.stack([getattr(a, f) for a in stacked]) for f in _FIELDS},
        spec, device)).cpu().tolist()
    return {s.name: MmpuCost(latency_cycles=out3[0][i],
                             occupancy_cycles=out3[1][i],
                             energy_pj=out3[2][i],
                             tokens=float(profile.tokens),
                             clock_hz=spec.clock_hz, n_events=len(stream))
            for i, (s, stream) in enumerate(zip(schemes, streams))}


def project_macs(macs: int, weight_words: int, spec: DeviceSpec, *,
                 tokens: int = 1, mac_bits: int = 8,
                 device=None) -> MmpuCost:
    """Redundancy-free projection for roofline-style consumers: price a
    step of `macs` total MACs over `weight_words` resident words."""
    from .compile import StepProfile, base_step_events
    profile = StepProfile(weight_words=max(1, weight_words),
                          macs_per_token=max(1, macs), tokens=1,
                          mac_bits=mac_bits)
    return fold(base_step_events(profile, spec), spec, tokens=tokens,
                device=device)
