"""Typed mMPU event streams: the IR between compiler and evaluator (port
of `repro.costmodel.events`).

An :class:`MmpuEvent` is one *bundle* of identical row-parallel
primitive issues:

* ``kind``   — primitive name from ``device.EVENT_KINDS``;
* ``count``  — sequential issues (multiplied by the spec's per-kind
  cycle latency to get device cycles);
* ``cells``  — total cells (bits) touched across all issues
  (multiplied by the spec's per-kind pJ/cell to get energy);
* ``xbars``  — crossbars concurrently occupied while the bundle runs
  (latency x xbars = occupancy, the device-normalized cost used for
  cycles/token — a scheme that runs 1x as long on 3x the arrays costs
  the mMPU exactly as much as one that runs 3x as long on 1x);
* ``weight`` — amortization factor: periodic work (scrub-interval ECC
  checks, TMR store votes) carries ``weight=1/interval`` so per-step
  streams stay integral while the fold charges the amortized share;
* ``tag``    — provenance string (``"netlist.level3"``, ``"ecc.syndrome"``,
  ``"tmr.vote"``) for offline analysis of JSONL dumps.

Streams are plain tuples of events — deterministic, order-preserving,
trivially JSONL-serializable — plus a packed struct-of-arrays form
(:class:`EventArrays`) the evaluator folds over.
"""
from __future__ import annotations

import dataclasses
import json
from typing import IO, Iterable, List, Sequence, Tuple, Union

import numpy as np

from .device import EVENT_KINDS, KIND_INDEX


@dataclasses.dataclass(frozen=True)
class MmpuEvent:
    kind: str
    count: int
    cells: int
    xbars: int = 1
    weight: float = 1.0
    tag: str = ""

    def __post_init__(self):
        if self.kind not in KIND_INDEX:
            raise ValueError(
                f"unknown event kind {self.kind!r}; expected one of "
                f"{EVENT_KINDS}")
        if self.count < 0 or self.cells < 0 or self.xbars < 1:
            raise ValueError(f"malformed event: {self}")
        if self.weight <= 0:
            raise ValueError(f"event weight must be positive: {self}")

    def scaled(self, count_x: float = 1, cells_x: float = 1,
               xbars_x: int = 1, weight_x: float = 1.0,
               tag: str | None = None) -> "MmpuEvent":
        """A copy with multiplied fields (counts round up, never to 0)."""
        def _up(v, x):
            return int(np.ceil(v * x)) if v else 0
        return MmpuEvent(
            kind=self.kind,
            count=_up(self.count, count_x),
            cells=_up(self.cells, cells_x),
            xbars=self.xbars * xbars_x,
            weight=self.weight * weight_x,
            tag=self.tag if tag is None else tag)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


EventStream = Tuple[MmpuEvent, ...]


def scale_stream(events: Iterable[MmpuEvent], repeats: float,
                 tag: str | None = None) -> EventStream:
    """Repeat a whole stream `repeats` times (e.g. steps per generation)."""
    return tuple(e.scaled(count_x=repeats, cells_x=repeats, tag=tag)
                 for e in events)


# ---------------------------------------------------------------- JSONL

def dump_jsonl(events: Iterable[MmpuEvent],
               fp: Union[str, IO[str]]) -> int:
    """Write one JSON object per event; returns the event count."""
    own = isinstance(fp, (str, bytes))
    f = open(fp, "w") if own else fp
    n = 0
    try:
        for e in events:
            f.write(json.dumps(e.to_dict(), sort_keys=True) + "\n")
            n += 1
    finally:
        if own:
            f.close()
    return n


def load_jsonl(fp: Union[str, IO[str]]) -> EventStream:
    own = isinstance(fp, (str, bytes))
    f = open(fp) if own else fp
    try:
        return tuple(MmpuEvent(**json.loads(line))
                     for line in f if line.strip())
    finally:
        if own:
            f.close()


# ------------------------------------------------------- packed arrays

@dataclasses.dataclass(frozen=True)
class EventArrays:
    """Struct-of-arrays event stream for vectorized folds.

    Padding rows (for stacking ragged scheme grids) use count=cells=0,
    which contribute exactly nothing to any fold.
    """
    kind: np.ndarray     # int32 (N,), index into EVENT_KINDS
    count: np.ndarray    # float64 (N,)
    cells: np.ndarray    # float64 (N,)
    xbars: np.ndarray    # float64 (N,)
    weight: np.ndarray   # float64 (N,)

    def __len__(self) -> int:
        return int(self.kind.shape[0])

    @classmethod
    def from_events(cls, events: Sequence[MmpuEvent],
                    pad_to: int | None = None) -> "EventArrays":
        n = len(events)
        width = n if pad_to is None else max(pad_to, n)
        kind = np.zeros(width, np.int32)
        count, cells = np.zeros(width), np.zeros(width)
        xbars, weight = np.ones(width), np.ones(width)
        for i, e in enumerate(events):
            kind[i] = KIND_INDEX[e.kind]
            count[i] = e.count
            cells[i] = e.cells
            xbars[i] = e.xbars
            weight[i] = e.weight
        return cls(kind, count, cells, xbars, weight)


def stack_streams(streams: Sequence[Sequence[MmpuEvent]]) -> List[EventArrays]:
    """Pad a ragged list of streams to a common length for stacking/vmap."""
    width = max((len(s) for s in streams), default=0)
    return [EventArrays.from_events(tuple(s), pad_to=width) for s in streams]
