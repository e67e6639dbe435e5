"""Fault models (port of `repro.faults.models`: `FaultModel` with its
word, pytree, boolean-state and packed-trial surfaces, `TransientBitFlips`,
`TransientGateFaults`, `pack_flip_mask` and `inject_bit_flips`).

Sampling takes an explicit `torch.Generator`.  The reference draws a dense
(n_words, 32) Bernoulli plane per leaf; at phi3-mini width the largest leaf
(w_up, 1.6e9 words) would need 5e10 booleans, so `TransientBitFlips`
samples sparsely instead: a binomial flip count per leaf, then that many
distinct uniform bit positions, XORed in place.  `TransientGateFaults`
does the same over a netlist's whole (gates, trials) plane at once (the
reference draws one Bernoulli plane per gate: 1.4e10 draws for the 32-bit
multiplier at 2^20 trials).  That is the same distribution, not the same
bits as the reference's threefry stream; the tests feed JAX's own masks.

Where the reference returns a corrupted copy, `corrupt` flips the bits of
the given tree in place (its leaves are views of an arena) and returns it.
A bf16 leaf keeps the reference's word view: a mask over its packed words,
whose unused top half in an odd-length leaf is dropped.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from ..core import arena
from ..core import tree as T
from ..core.bitops import PACK, as_i32, pack_trials

__all__ = ["FaultModel", "TransientBitFlips", "TransientGateFaults",
           "flip_random_bits_", "pack_flip_mask", "inject_bit_flips"]


def _p_interval(p: float, dt: float) -> float:
    """Per-interval flip probability for a per-unit-time rate p over dt."""
    if dt == 1.0 or p <= 0.0:
        return p
    if p >= 1.0:
        return 1.0
    return -math.expm1(dt * math.log1p(-p))


def pack_flip_mask(flips: torch.Tensor) -> torch.Tensor:
    """Pack a (..., 32) bool flip plane, bit i of a word at [..., i], into
    a (...,) int32 XOR mask (the reference's uint32 bits)."""
    shifts = torch.arange(arena.BLOCK, dtype=torch.int64,
                          device=flips.device)
    return as_i32((flips.to(torch.int64) << shifts).sum(-1))


def _bits_view(x: torch.Tensor) -> torch.Tensor:
    """Flat integer view of a leaf's stored bits (int32 or, for bf16,
    int16 half-words)."""
    if not x.is_contiguous():
        raise ValueError("corrupt: leaves must be contiguous views")
    bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    return x.view(bits).view(-1)


def _distinct_positions(total: int, p: float,
                        generator: torch.Generator) -> Optional[torch.Tensor]:
    """A Binomial(total, p) count of distinct uniform positions in
    [0, total), sorted int64 on the generator's device; None when the count
    is 0.  The count is read back to the host once."""
    if p <= 0.0 or total == 0:
        return None
    dev = generator.device
    k = int(torch.binomial(
        torch.tensor(float(total), dtype=torch.float64, device=dev),
        torch.tensor(min(p, 1.0), dtype=torch.float64, device=dev),
        generator=generator).item())
    if k == 0:
        return None
    pos = torch.unique(torch.randint(0, total, (k,), generator=generator,
                                     device=dev))
    while pos.numel() < k:      # distinct positions: redraw duplicates
        more = torch.randint(0, total, (k - pos.numel(),),
                             generator=generator, device=dev)
        pos = torch.unique(torch.cat([pos, more]))
    return pos


def _xor_bits_(flat: torch.Tensor, elem: torch.Tensor,
               bit: torch.Tensor) -> None:
    """flat[elem] ^= 1 << bit for distinct (elem, bit) pairs, in place."""
    elem, inverse = torch.unique(elem, return_inverse=True)
    # distinct bits of one element: their sum is their OR
    masks = torch.zeros(elem.numel(), dtype=torch.int64, device=flat.device)
    masks.index_add_(0, inverse, torch.ones_like(bit) << bit)
    flat[elem] ^= masks.to(flat.dtype)


def flip_random_bits_(bits: torch.Tensor, p: float,
                      generator: torch.Generator) -> int:
    """Flip each bit of the flat int16/int32 tensor `bits` independently
    with probability p, in place: a Binomial(n_bits, p) count of distinct
    uniform positions.  Draws on the generator's device.  Returns the flip
    count (a host int; the count is read once per call)."""
    width = bits.element_size() * 8
    pos = _distinct_positions(bits.numel() * width, p, generator)
    if pos is None:
        return 0
    pos = pos.to(bits.device)
    _xor_bits_(bits, pos // width, pos % width)
    return pos.numel()


class FaultModel:
    """Abstract error process over stored bits.  Subclasses are frozen
    dataclasses; sampling draws from the caller's generator."""

    # -- boolean-state surface (crossbar cells, netlist gate outputs) ------

    def bit_flips(self, generator: torch.Generator, shape: Tuple[int, ...],
                  dt: float = 1.0) -> torch.Tensor:
        """Bool XOR plane on the generator's device: True where a stored
        bit flips during dt."""
        raise NotImplementedError(
            f"{type(self).__name__} is data-dependent; use corrupt_bits")

    def corrupt_bits(self, bits: torch.Tensor, generator: torch.Generator,
                     dt: float = 1.0) -> torch.Tensor:
        return bits ^ self.bit_flips(generator, tuple(bits.shape),
                                     dt).to(bits.device)

    # -- packed-trial surface (netlist execution engines) -------------------

    def gate_lane_masks(self, generator: torch.Generator, n_gates: int,
                        trials: int, dt: float = 1.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every gate's output corruption as lane masks over trial-packed
        words: gate g's packed column (core/bitops.pack_trials layout)
        corrupts as ``(val & keep[g]) ^ flip[g]``.  Returns (keep, flip),
        int32 (n_gates, ceil(trials/32)) on the generator's device; keep
        may be a broadcast view.  Padding lanes are don't-care.  The
        netlist engines of the port all draw their gate faults here, so
        for one generator state they corrupt the same (gate, trial)
        pairs."""
        flip = pack_trials(self.bit_flips(generator, (trials, n_gates), dt))
        return torch.full_like(flip.T, -1), flip.T.contiguous()

    def word_mask(self, generator: torch.Generator, words: torch.Tensor,
                  dt: float = 1.0) -> torch.Tensor:
        """int32 XOR mask over the packed words of one leaf."""
        raise NotImplementedError

    def corrupt_leaf_(self, x: torch.Tensor, generator: torch.Generator,
                      dt: float = 1.0) -> None:
        """Corrupt one leaf in place through `word_mask` over its words."""
        bits = _bits_view(x)
        mask = self.word_mask(generator, arena.leaf_to_words(x), dt)
        mask = mask.to(bits.device)
        if x.dtype == torch.bfloat16:    # word mask -> LSB-first halves
            m = mask.to(torch.int64) & 0xFFFFFFFF
            halves = torch.stack([m & 0xFFFF, m >> 16], -1).reshape(-1)
            mask = halves[:bits.numel()].to(torch.int16)
        bits ^= mask

    def corrupt(self, params: Any, generator: torch.Generator,
                dt: float = 1.0) -> Any:
        """Corrupt every leaf of a tree in place (leaf order = the
        reference's flatten order) and return the tree."""
        for x in T.leaves(params):
            self.corrupt_leaf_(x, generator, dt)
        return params


@dataclasses.dataclass(frozen=True)
class TransientBitFlips(FaultModel):
    """Indirect soft errors: each stored bit flips i.i.d. w.p. p_bit per
    interval (read disturb / access corruption, paper §II-B)."""

    p_bit: float = 0.0

    def word_mask(self, generator, words, dt: float = 1.0):
        mask = torch.zeros_like(words)
        flip_random_bits_(mask.view(-1), _p_interval(self.p_bit, dt),
                          generator)
        return mask

    def corrupt_leaf_(self, x, generator, dt: float = 1.0) -> None:
        flip_random_bits_(_bits_view(x), _p_interval(self.p_bit, dt),
                          generator)


@dataclasses.dataclass(frozen=True)
class TransientGateFaults(FaultModel):
    """Direct soft errors: a stateful gate writes the wrong output w.p.
    p_gate per evaluation (independently per row/column, paper §II-B)."""

    p_gate: float = 0.0

    def bit_flips(self, generator, shape, dt: float = 1.0):
        plane = torch.zeros(math.prod(shape), dtype=torch.bool,
                            device=generator.device)
        pos = _distinct_positions(plane.numel(),
                                  _p_interval(self.p_gate, dt), generator)
        if pos is not None:
            plane[pos] = True
        return plane.reshape(shape)

    def gate_lane_masks(self, generator, n_gates: int, trials: int,
                        dt: float = 1.0):
        """Sparse: one Binomial(n_gates * trials, p) count over the whole
        (gate, trial) plane, then that many distinct (gate, trial) pairs;
        keep is all ones (a broadcast view)."""
        tw = -(-trials // PACK)
        dev = generator.device
        flip = torch.zeros((n_gates, tw), dtype=torch.int32, device=dev)
        pos = _distinct_positions(n_gates * trials,
                                  _p_interval(self.p_gate, dt), generator)
        if pos is not None:
            g, t = pos // trials, pos % trials
            _xor_bits_(flip.view(-1), g * tw + t // PACK, t % PACK)
        keep = torch.full((1, 1), -1, dtype=torch.int32,
                          device=dev).expand(n_gates, tw)
        return keep, flip


def inject_bit_flips(params: Any, generator: torch.Generator,
                     p_bit: float) -> Any:
    """Flip each stored bit of every leaf with probability p_bit, in place
    (`TransientBitFlips(p_bit).corrupt`); returns the tree.  The reference
    returns a corrupted copy."""
    return TransientBitFlips(p_bit).corrupt(params, generator)
