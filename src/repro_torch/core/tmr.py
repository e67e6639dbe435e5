"""Triple modular redundancy with per-bit voting (port of `repro.core.tmr`,
paper §V): the voters, the disciplines' cost table and the `tmr` wrapper.

Three execution disciplines, identical output semantics, different cost:

* serial        -- 3x latency, ~1x area (inputs and intermediates reused)
* parallel      -- 1x latency, 3x area (memristive partitions)
* semi-parallel -- 1x latency, 1x area, 1/3 throughput (repeat across rows)

Voting is per bit, the Minority3 gate's majority: any single corrupted copy
is corrected exactly, including NaN-producing flips in float words.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from . import prng
from . import tree as T
from .seeds import derive_seed

__all__ = ["TmrCost", "TMR_COSTS", "vote_bits", "vote_words", "vote_array",
           "tmr"]


@dataclasses.dataclass(frozen=True)
class TmrCost:
    latency_x: float
    area_x: float
    throughput_x: float


#: paper §V trade-off surface, relative to the unreliable baseline (the one
#: definition: `reliability.scheme` reads it for `Tmr.overhead`)
TMR_COSTS = {
    "serial": TmrCost(latency_x=3.0, area_x=1.0, throughput_x=1.0),
    "parallel": TmrCost(latency_x=1.0, area_x=3.0, throughput_x=1.0),
    "semi_parallel": TmrCost(latency_x=1.0, area_x=1.0,
                             throughput_x=1.0 / 3.0),
}


def vote_bits(a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor) -> torch.Tensor:
    """Per-bit majority of three boolean bit-planes."""
    return (a & b) | (b & c) | (a & c)


def vote_words(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """Per-bit majority on integer words."""
    return (a & b) | (b & c) | (a & c)


_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
         torch.float16: torch.int16, torch.float64: torch.int64}


def vote_array(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """Per-bit majority of arbitrary tensors; floats vote on their raw bits
    (a bit view, so bf16 votes exactly as the reference's u16 path)."""
    if a.dtype == torch.bool:
        return vote_bits(a, b, c)
    if a.dtype in _BITS:
        bits = _BITS[a.dtype]
        return vote_words(a.view(bits), b.view(bits),
                          c.view(bits)).view(a.dtype)
    return vote_words(a, b, c)


def tmr(fn: Callable, mode: str = "serial", voter: Optional[Callable] = None,
        device=None) -> Callable:
    """Wrap `fn(generator, *args) -> tree` with triple modular redundancy.

    `fn` takes a `torch.Generator` or a `core.prng` key first (its copy's
    fault stream).  The wrapper is called as wrapped(seed, *args): it runs
    `fn` three times, on generators seeded derive_seed(seed, 0..2) on
    `device` (CUDA unless the caller passes the CPU), and votes every leaf
    of the outputs per bit.  Called with a key in place of the seed, the
    copies take ``split(key, 3)``, the reference's keys.
    `voter` defaults to the registry's ``tmr_vote`` (on a CUDA tensor the
    kernel).  Every mode evaluates the copies one after another (the
    reference vmaps parallel and semi_parallel); the voted bits are the
    same and `wrapped.cost` reports the mode's accounting.
    """
    if mode not in TMR_COSTS:
        raise ValueError(f"mode must be one of {sorted(TMR_COSTS)}")
    from ..device import resolve_device
    dev = resolve_device(device)
    if voter is None:
        from ..reliability import backend
        voter = backend.dispatch("tmr_vote")

    def wrapped(seed, *args):
        if prng.is_key(seed):
            sources = list(prng.split(seed, 3))
        else:
            sources = [torch.Generator(device=dev).manual_seed(
                derive_seed(seed, i)) for i in range(3)]
        outs = [fn(g, *args) for g in sources]
        return T.map_tree(voter, *outs)

    wrapped.cost = TMR_COSTS[mode]
    return wrapped
