"""Event-stream compiler: lower the repo's two workload IRs to MmpuEvents
(port of `repro.costmodel.compile`).

Two entry points, one per IR:

* :func:`lower_schedule` — a levelized netlist ``Schedule``
  (core/scheduler.py) becomes one init+min3 bundle per level, each
  width-capped by the crossbar: level l with ``widths[l]`` gates costs
  ``ceil(widths[l] / spec.rows)`` row-parallel issues (HIPE-MAGIC's
  technology mapping, arXiv:2006.03269).  Trials beyond the crossbar's
  ``cols`` bitlines multiply the issue count, not the cells-per-issue.

* :func:`lower_step` — one generation/train step under a reliability
  ``Scheme`` becomes weight reads + MAC kernel cycles (the in-memory
  fixed-point multiplier netlist, re-used *as its own cost source* via
  ``lower_schedule``) + the scheme's redundancy traffic, attached by
  ``Scheme.cost_events``: diagonal-parity encode/syndrome/correct
  (Leitersdorf et al., arXiv:2105.04212), TMR 3x execution + Min3+NOT
  vote per discipline, all periodic work amortized by
  ``weight = 1/scrub_interval``.

Everything here is host-side integer arithmetic over static shapes --
no tensors -- so streams are deterministic, hashable inputs for the
evaluator and cheap enough to build inside a serving engine
(`launch/engine.py` builds one stream per batch geometry, never per
token).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

from .device import DeviceSpec
from .events import EventStream, MmpuEvent

__all__ = ["lower_schedule", "mac_kernel_events", "StepProfile",
           "base_step_events", "lower_step", "ecc_events", "tmr_transform",
           "vote_events"]


# ------------------------------------------------- netlist schedule path

def lower_schedule(sch, spec: DeviceSpec, *, trials: int = 1,
                   n_outputs: int = 0, load_inputs: bool = True,
                   tag: str = "netlist") -> EventStream:
    """Lower a levelized ``Schedule`` into per-level row-parallel events.

    Each MAGIC/FELIX gate needs its output cell initialized (``init``)
    then the ``min3`` evaluation; both are row-parallel, so a level of W
    gates costs ``ceil(W / spec.rows)`` issues of each.  ``trials``
    independent input vectors occupy one column each; more than
    ``spec.cols`` trials wrap into extra column rounds (more issues,
    same per-issue width).
    """
    if trials < 1:
        raise ValueError(f"trials must be >= 1, got {trials}")
    col_rounds = math.ceil(trials / spec.cols)
    events: List[MmpuEvent] = []
    n_inputs = sch.base - 2          # remap rows [2, base) are the inputs
    if load_inputs and n_inputs > 0:
        events.append(MmpuEvent(
            kind="write", count=spec.row_issues(n_inputs) * col_rounds,
            cells=n_inputs * trials, tag=f"{tag}.load"))
    level_issues = sch.issue_counts(spec.rows)
    for lvl, w in enumerate(int(w) for w in sch.widths):
        if w <= 0:
            continue
        issues = int(level_issues[lvl]) * col_rounds
        cells = w * trials
        events.append(MmpuEvent(kind="init", count=issues, cells=cells,
                                tag=f"{tag}.level{lvl}"))
        events.append(MmpuEvent(kind="min3", count=issues, cells=cells,
                                tag=f"{tag}.level{lvl}"))
    if n_outputs > 0:
        events.append(MmpuEvent(
            kind="read", count=spec.row_issues(n_outputs) * col_rounds,
            cells=n_outputs * trials, tag=f"{tag}.readout"))
    return tuple(events)


@functools.lru_cache(maxsize=None)
def mac_kernel_events(n_bits: int, spec: DeviceSpec) -> EventStream:
    """Cost of ONE crossbar-wide MAC round: the n_bits fixed-point
    multiplier netlist executed column-parallel, `spec.cols` independent
    multiplications at once (one per bitline)."""
    from ..core.multpim import multiplier_netlist
    from ..core.scheduler import schedule
    sch = schedule(multiplier_netlist(n_bits))
    return lower_schedule(sch, spec, trials=spec.cols,
                          n_outputs=2 * n_bits, tag=f"mac{n_bits}")


# ------------------------------------------------------ model step path

@dataclasses.dataclass(frozen=True)
class StepProfile:
    """Static shape summary of one generation/train step.

    The compiler works from this — not from live arrays — so streams
    can be built for dryrun configs, abstract sweeps, or a serving
    engine's batch geometry alike.
    """
    weight_words: int          # packed arena words holding the weights
    macs_per_token: int        # multiply-accumulates per emitted token
    tokens: int = 1            # tokens emitted per step (batch size)
    mac_bits: int = 8          # fixed-point width of the in-memory MAC
    scrub_interval: int = 32   # steps between scrub/store-vote passes
    out_bits_per_token: int = 32

    def __post_init__(self):
        if min(self.weight_words, self.macs_per_token, self.tokens,
               self.mac_bits, self.scrub_interval) < 1:
            raise ValueError(f"StepProfile fields must be >= 1: {self}")

    @property
    def n_blocks(self) -> int:
        from ..core import arena
        return math.ceil(self.weight_words / arena.BLOCK)

    @classmethod
    def from_model_config(cls, cfg, *, batch: int = 1, mac_bits: int = 8,
                          scrub_interval: int = 32,
                          dtype="float32") -> "StepProfile":
        """Analytic profile from a ModelConfig: arena words via the same
        block-padded packing `core.arena` applies to real params (the
        layout of the spec tree, nothing allocated), MACs as one multiply
        per matrix-weight entry per token."""
        from ..core import tree as T
        from ..models.params import layout
        from ..models.transformer import model_specs
        specs = model_specs(cfg)
        words = layout(specs, dtype).n_words
        macs = sum(math.prod(s.shape) for s in T.leaves(specs)
                   if len(s.shape) >= 2)
        return cls(weight_words=words, macs_per_token=max(1, macs),
                   tokens=batch, mac_bits=mac_bits,
                   scrub_interval=scrub_interval)


def base_step_events(profile: StepProfile, spec: DeviceSpec) -> EventStream:
    """Redundancy-free cost of one step: weight operand reads, MAC
    kernel rounds across the crossbar fleet, token write-out."""
    events: List[MmpuEvent] = []
    events.append(MmpuEvent(
        kind="read", count=spec.row_issues(profile.weight_words),
        cells=profile.weight_words * 32, tag="step.weights"))
    macs = profile.macs_per_token * profile.tokens
    # one MAC round = spec.cols multiplications on one crossbar; the
    # fleet runs n_crossbars rounds concurrently
    rounds_total = math.ceil(macs / spec.cols)
    xbars = max(1, min(spec.n_crossbars, rounds_total))
    rounds_seq = math.ceil(rounds_total / xbars)
    for ev in mac_kernel_events(profile.mac_bits, spec):
        events.append(MmpuEvent(
            kind=ev.kind, count=ev.count * rounds_seq,
            cells=int(math.ceil(ev.cells / spec.cols)) * macs,
            xbars=xbars, tag=f"step.{ev.tag}"))
    out_bits = profile.out_bits_per_token * profile.tokens
    events.append(MmpuEvent(
        kind="write", count=spec.row_issues(out_bits),
        cells=out_bits, tag="step.emit"))
    return tuple(events)


def ecc_events(profile: StepProfile, spec: DeviceSpec,
               slopes: Sequence[int], *, copies: int = 1,
               tag: str = "ecc") -> EventStream:
    """Diagonal-parity redundancy traffic, amortized over the scrub
    interval (arXiv:2105.04212 §IV: per block, each of the S slopes is
    a (BLOCK-1)-XOR reduction; blocks are row-parallel).

    Three phases per scrub pass over ``copies * n_blocks`` blocks:
    encode (parity recompute + parity write), syndrome (same reduction
    against the stored parity), correct (worst case one word rewrite
    per block).
    """
    from ..core import arena
    n_blocks = profile.n_blocks * copies
    n_slopes = len(slopes)
    if n_blocks < 1 or n_slopes < 1:
        return ()
    w = 1.0 / profile.scrub_interval
    block_rounds = spec.row_issues(n_blocks)
    red_cells = n_slopes * (arena.BLOCK - 1) * 32 * n_blocks
    reduction = lambda phase: MmpuEvent(       # noqa: E731
        kind="xor", count=(arena.BLOCK - 1) * n_slopes * block_rounds,
        cells=red_cells, weight=w, tag=f"{tag}.{phase}")
    return (
        reduction("encode"),
        MmpuEvent(kind="write", count=n_slopes * block_rounds,
                  cells=n_slopes * 32 * n_blocks, weight=w,
                  tag=f"{tag}.parity_write"),
        reduction("syndrome"),
        MmpuEvent(kind="write", count=block_rounds, cells=32 * n_blocks,
                  weight=w, tag=f"{tag}.correct"),
    )


def secded_events(profile: StepProfile, spec: DeviceSpec, *,
                  n_checks: int = 7, copies: int = 1,
                  tag: str = "hsiao") -> EventStream:
    """Hsiao SEC-DED redundancy traffic: the same four-phase structure as
    `ecc_events` (encode, parity write, syndrome, correct) with
    ``n_checks`` masked-parity families per word instead of the 3
    diagonal slopes — the denser H matrix is what buys per-word
    correction and double-error detection, so the code zoo's cost
    ordering (off < ecc < hsiao < tmr-*) falls out of the family count.
    """
    return ecc_events(profile, spec, tuple(range(n_checks)), copies=copies,
                      tag=tag)


def tmr_transform(events: Sequence[MmpuEvent], discipline: str,
                  tag: str = "tmr") -> EventStream:
    """Triplicate an execution stream per TMR discipline (paper §V).

    serial        — the three copies run back-to-back on the same
                    arrays: 3x issues, 3x cells, same xbars;
    parallel      — copies run concurrently on 3x the arrays: same
                    issue count, 3x cells, 3x xbars;
    semi_parallel — copies share the original arrays' rows, so the 3x
                    work serializes into 3x issues (1/3 throughput at
                    1x area): 3x issues, 3x cells, same xbars.
    """
    if discipline == "parallel":
        return tuple(e.scaled(cells_x=3, xbars_x=3, tag=f"{tag}.{e.tag}")
                     for e in events)
    if discipline in ("serial", "semi_parallel"):
        return tuple(e.scaled(count_x=3, cells_x=3, tag=f"{tag}.{e.tag}")
                     for e in events)
    raise ValueError(f"unknown TMR discipline: {discipline!r}")


def vote_events(profile: StepProfile, spec: DeviceSpec,
                tag: str = "tmr") -> EventStream:
    """Majority vote = Min3 + NOT per bit (core/tmr.py): per-step over
    the emitted token bits, plus a store-wide vote amortized at the
    scrub cadence."""
    out_bits = profile.out_bits_per_token * profile.tokens
    store_bits = profile.weight_words * 32
    w = 1.0 / profile.scrub_interval
    ev = []
    for kind in ("min3", "not"):
        ev.append(MmpuEvent(kind=kind, count=spec.row_issues(
            math.ceil(out_bits / spec.cols)), cells=out_bits,
            tag=f"{tag}.vote"))
        ev.append(MmpuEvent(kind=kind, count=spec.row_issues(
            profile.weight_words), cells=store_bits, weight=w,
            tag=f"{tag}.store_vote"))
    return tuple(ev)


def lower_step(scheme, profile: StepProfile, spec: DeviceSpec) -> EventStream:
    """One step under `scheme`: the base stream extended/transformed by
    the scheme's `cost_events` hookup (reliability/scheme.py)."""
    return tuple(scheme.cost_events(base_step_events(profile, spec),
                                    profile, spec))
