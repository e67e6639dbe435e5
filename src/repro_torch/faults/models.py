"""Fault models (port of `repro.faults.models`: `FaultModel` with its
word, pytree, boolean-state and packed-trial surfaces, `TransientBitFlips`,
`TransientGateFaults`, `StuckAtFaults`, `RetentionDrift`,
`CompositeFault`, `pack_flip_mask` and `inject_bit_flips`).

Sampling takes an explicit `torch.Generator` or a `core.prng` key.

With a key, every surface makes exactly the reference's draws: the same
splits (one per leaf, one per `CompositeFault` member), the same per-gate
`fold_in(key, gid)` in `gate_lane_masks`, and the same dense Bernoulli and
uniform planes, computed chunk by chunk (`prng.word_plane`,
`prng.lane_plane`) and packed into words, so the masks and lanes equal
the reference's bit for bit and no plane exists whole.  That route draws
every bit: about 175 int64 passes an element, so an arena-scale plane is
not on the card's default path.

With a generator, the port samples sparsely.  The reference draws a dense
(n_words, 32) Bernoulli plane per leaf; at phi3-mini width the largest leaf
(w_up, 1.6e9 words) would need 5e10 booleans, so `TransientBitFlips`
samples sparsely instead: a binomial flip count per leaf, then that many
distinct uniform bit positions, XORed in place.  `TransientGateFaults`
does the same over a netlist's whole (gates, trials) plane at once (the
reference draws one Bernoulli plane per gate: 1.4e10 draws for the 32-bit
multiplier at 2^20 trials).  `RetentionDrift` is the same sampler at the
per-interval drift probability.  `StuckAtFaults` is sparse too: a
Binomial(n_bits, p0 + p1) count of distinct defective positions, each
stuck-at-1 with probability p1 / (p0 + p1), else stuck-at-0, then those
bits cleared or set in place (the reference draws a uniform per bit: 1.2e11
draws for one phi3-mini arena copy).  `CompositeFault` applies its members
in order from one generator where the reference splits keys.  The bits
differ from the reference's, and so does the rate below 2**-23: the
reference's Bernoulli compares a 23-bit uniform with p rounded to float32,
so it flips at ``ceil(float32(p) * 2**23) / 2**23`` (2**-23 at p = 1e-9,
and `StuckAtFaults(p/2, p/2)` there gives stuck-at-0 cells at 2**-23 and
no stuck-at-1 cell), where the generator route keeps the nominal p that
the paper and the configs mean.  The key route reproduces the reference's
rate.  Tests of the generator route feed JAX's own masks
(`StuckAtFaults.stick_bits`, `stuck_word_mask`, `lane_masks_from`,
`CompositeFault.compose_lane_masks`).

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

from ..core import arena, prng
from ..core import tree as T
from ..core.bitops import PACK, as_i32, pack_trials

__all__ = ["FaultModel", "TransientBitFlips", "TransientGateFaults",
           "StuckAtFaults", "RetentionDrift", "CompositeFault",
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


def _gate_keys(key: torch.Tensor, n_gates: int) -> torch.Tensor:
    """Gate g's key, (n_gates, 2): `fold_in(key, g)` for one key (the
    reference's netlist engines); a (n_gates, 2) batch is taken as is."""
    if key.dim() == 2:
        return key
    return prng.fold_in(key, torch.arange(n_gates, device=key.device))


def _ones_like(flip: torch.Tensor) -> torch.Tensor:
    """An all-ones keep mask the shape of `flip`: a broadcast view, which
    the engines read as "no AND" (`scheduler._all_ones_broadcast`)."""
    return torch.full((1, 1), -1, dtype=torch.int32,
                      device=flip.device).expand(*flip.shape)


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


def _payload(mask: torch.Tensor, a: int, leaf) -> torch.Tensor:
    """A word mask over words [a, a + len) of `leaf` with the unused top
    half of an odd-length bf16 leaf's last word cleared (`corrupt_leaf_`
    drops that half's flips)."""
    n = math.prod(leaf.shape)
    if leaf.dtype != torch.bfloat16 or n % 2 == 0 \
            or a + mask.numel() < leaf.n_words:
        return mask
    mask = mask.clone()
    mask[-1] &= 0xFFFF
    return mask


def _window_bits(pos: torch.Tensor, leaf, a: int, b: int):
    """Positions among a leaf's stored bits (int16 halves for bf16, the
    words otherwise) as (word index from a, bit in the int32 word, which
    positions fall in its words [a, b)), the first two of those only."""
    if leaf.dtype == torch.bfloat16:
        half = pos // 16
        word, bit = half // 2, (half % 2) * 16 + pos % 16
    else:
        word, bit = pos // 32, pos % 32
    keep = (word >= a) & (word < b)
    return word[keep] - a, bit[keep], keep


def _leaf_bits(leaf) -> int:
    """The stored bits of one leaf (`_bits_view`'s elements x width)."""
    n = math.prod(leaf.shape)
    return n * (16 if leaf.dtype == torch.bfloat16 else 32)


def _xor_bits_(flat: torch.Tensor, elem: torch.Tensor,
               bit: torch.Tensor) -> None:
    """flat[elem] ^= 1 << bit for distinct (elem, bit) pairs, in place."""
    elem, inverse = torch.unique(elem, return_inverse=True)
    # distinct bits of one element: their sum is their OR
    masks = torch.zeros(elem.numel(), dtype=torch.int64, device=flat.device)
    masks.index_add_(0, inverse, torch.ones_like(bit) << bit)
    flat[elem] ^= masks.to(flat.dtype)


def _stick_bits_(flat: torch.Tensor, elem: torch.Tensor, bit: torch.Tensor,
                 set_: torch.Tensor) -> None:
    """Bit `bit` of flat[elem] := set_ for distinct (elem, bit) pairs, in
    place (stuck-at-1 where set_, stuck-at-0 elsewhere)."""
    elem, inverse = torch.unique(elem, return_inverse=True)
    one = torch.ones_like(bit) << bit
    ones = torch.zeros(elem.numel(), dtype=torch.int64, device=flat.device)
    clear = torch.zeros_like(ones)
    ones.index_add_(0, inverse, torch.where(set_, one, 0))
    clear.index_add_(0, inverse, torch.where(set_, 0, one))
    flat[elem] = ((flat[elem].to(torch.int64) & ~clear) | ones).to(flat.dtype)


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
    dataclasses; sampling draws from the caller's generator, or from a
    `core.prng` key as the reference does (module doc)."""

    @property
    def permanent(self) -> bool:
        """True when the model describes a fixed device property (defect
        maps) rather than an exposure process: a consumer that corrupts
        repeatedly must then reseed its generator the same way each time,
        or the defects would move with every draw."""
        return False

    # -- boolean-state surface (crossbar cells, netlist gate outputs) ------

    def bit_flips(self, generator: torch.Generator, shape: Tuple[int, ...],
                  dt: float = 1.0) -> torch.Tensor:
        """Bool XOR plane on the generator's device: True where a stored
        bit flips during dt."""
        raise NotImplementedError(
            f"{type(self).__name__} is data-dependent; use corrupt_bits")

    def corrupt_bits(self, bits: torch.Tensor, generator: torch.Generator,
                     dt: float = 1.0) -> torch.Tensor:
        if prng.is_key(generator):       # a keyed draw runs where the data is
            generator = generator.to(bits.device)
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
        pairs.  With a key, gate g draws the reference's `gate_lane_masks`
        under `fold_in(key, g)` (or under row g of a (n_gates, 2) batch of
        keys): the subclasses' own."""
        flip = pack_trials(self.bit_flips(generator, (trials, n_gates), dt))
        return torch.full_like(flip.T, -1), flip.T.contiguous()

    def word_mask(self, generator: torch.Generator, words: torch.Tensor,
                  dt: float = 1.0) -> torch.Tensor:
        """int32 XOR mask over the packed words of one leaf."""
        raise NotImplementedError

    def corrupt_words(self, words: torch.Tensor, generator: torch.Generator,
                      dt: float = 1.0) -> torch.Tensor:
        """A corrupted copy of int32 `words`."""
        return words ^ self.word_mask(generator, words, dt).to(words.device)

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
        reference's flatten order) and return the tree.  A key is split
        once per leaf, as the reference splits it."""
        leaves = T.leaves(params)
        if prng.is_key(generator):
            for x, k in zip(leaves, prng.split(generator, len(leaves))):
                self.corrupt_leaf_(x, k, dt)
            return params
        for x in leaves:
            self.corrupt_leaf_(x, generator, dt)
        return params

    def skip(self, params: Any, generator: torch.Generator,
             dt: float = 1.0) -> None:
        """Draw what `corrupt(params)` draws and apply none of it (the
        empty range of `corrupt_range`).  A key has no state to advance."""
        self.corrupt_range(torch.empty(0, dtype=torch.int32),
                           arena.arena_spec(params), 0, generator, dt)

    def corrupt_range(self, words: torch.Tensor, spec: arena.ArenaSpec,
                      lo: int, generator: torch.Generator,
                      dt: float = 1.0) -> torch.Tensor:
        """What `corrupt` does to words [lo, lo + words.numel()) of an
        arena laid out as `spec`, done to `words` (int32, those words
        alone; in place), and returned.  Every leaf draws what `corrupt`
        draws for it, in flatten order -- a generator advances past the
        leaves and positions outside the range too, a key is split once
        per leaf -- and only what lands in the range is applied, so the
        words equal that range of the whole corrupted arena whatever the
        range: a mesh rank corrupts its block range without the rest of
        the arena, and an empty range is `skip`."""
        hi = lo + words.numel()
        n = len(spec.leaves)
        sources = prng.split(generator, n) if prng.is_key(generator) \
            else [generator] * n
        for leaf, g in zip(spec.leaves, sources):
            a = min(max(lo - leaf.offset, 0), leaf.n_words)
            b = min(max(hi - leaf.offset, a), leaf.n_words)
            if a == b and prng.is_key(g):
                continue                 # nothing to draw, nothing to skip
            w = words[leaf.offset + a - lo:leaf.offset + b - lo] if b > a \
                else words[:0]
            self.corrupt_window_(w, a, leaf, g, dt)
        return words

    def corrupt_window_(self, w: torch.Tensor, a: int, leaf: arena.LeafSpec,
                        generator: torch.Generator, dt: float = 1.0) -> None:
        """Words [a, a + w.numel()) of one leaf's payload, corrupted in
        place as `corrupt_leaf_` corrupts the whole leaf (the leaf's every
        draw is made).  Here through `word_mask` over a whole leaf of
        words, zero outside the window: a model whose draws follow the
        flat index overrides it and draws the window alone."""
        full = torch.zeros(leaf.n_words, dtype=torch.int32, device=w.device)
        full[a:a + w.numel()] = w
        mask = self.word_mask(generator, full, dt).to(w.device)
        w ^= _payload(mask[a:a + w.numel()], a, leaf)


class _IidFlips(FaultModel):
    """Each stored bit flips independently with the per-interval
    probability `_rate(dt)`, sampled sparsely: a binomial count of distinct
    uniform positions."""

    def _rate(self, dt: float) -> float:
        raise NotImplementedError

    def bit_flips(self, generator, shape, dt: float = 1.0):
        if prng.is_key(generator):
            return prng.bernoulli(generator, self._rate(dt), shape)
        plane = torch.zeros(math.prod(shape), dtype=torch.bool,
                            device=generator.device)
        pos = _distinct_positions(plane.numel(), self._rate(dt), generator)
        if pos is not None:
            plane[pos] = True
        return plane.reshape(shape)

    def word_mask(self, generator, words, dt: float = 1.0):
        if prng.is_key(generator):
            t = prng.threshold(self._rate(dt))
            return prng.word_plane(generator.to(words.device), words.numel(),
                                   lambda m: m < t).view(words.shape)
        mask = torch.zeros_like(words)
        flip_random_bits_(mask.view(-1), self._rate(dt), generator)
        return mask

    def corrupt_leaf_(self, x, generator, dt: float = 1.0) -> None:
        if prng.is_key(generator):
            return super().corrupt_leaf_(x, generator, dt)
        flip_random_bits_(_bits_view(x), self._rate(dt), generator)

    def corrupt_window_(self, w, a, leaf, generator, dt: float = 1.0):
        if prng.is_key(generator):
            t = prng.threshold(self._rate(dt))
            mask = prng.word_plane(generator.to(w.device), w.numel(),
                                   lambda m: m < t, start=a)
            w ^= _payload(mask, a, leaf)
            return
        # every position of the leaf drawn, those in the window flipped
        pos = _distinct_positions(_leaf_bits(leaf), self._rate(dt),
                                  generator)
        if pos is not None and w.numel():
            word, bit, _ = _window_bits(pos.to(w.device), leaf, a,
                                        a + w.numel())
            if word.numel():
                _xor_bits_(w, word, bit)

    def gate_lane_masks(self, generator, n_gates: int, trials: int,
                        dt: float = 1.0):
        """Sparse: one Binomial(n_gates * trials, p) count over the whole
        (gate, trial) plane, then that many distinct (gate, trial) pairs;
        keep is all ones (a broadcast view).  With a key, each gate's dense
        plane under fold_in(key, g), as the reference draws it."""
        if prng.is_key(generator):
            t = prng.threshold(self._rate(dt))
            flip = prng.lane_plane(_gate_keys(generator, n_gates), trials,
                                   lambda m: m < t)
            return _ones_like(flip), flip
        tw = -(-trials // PACK)
        dev = generator.device
        flip = torch.zeros((n_gates, tw), dtype=torch.int32, device=dev)
        pos = _distinct_positions(n_gates * trials, self._rate(dt),
                                  generator)
        if pos is not None:
            g, t = pos // trials, pos % trials
            _xor_bits_(flip.view(-1), g * tw + t // PACK, t % PACK)
        return _ones_like(flip), flip


@dataclasses.dataclass(frozen=True)
class TransientBitFlips(_IidFlips):
    """Indirect soft errors: each stored bit flips i.i.d. w.p. p_bit per
    interval (read disturb / access corruption, paper §II-B)."""

    p_bit: float = 0.0

    def _rate(self, dt: float) -> float:
        return _p_interval(self.p_bit, dt)


@dataclasses.dataclass(frozen=True)
class TransientGateFaults(_IidFlips):
    """Direct soft errors: a stateful gate writes the wrong output w.p.
    p_gate per evaluation (independently per row/column, paper §II-B)."""

    p_gate: float = 0.0

    def _rate(self, dt: float) -> float:
        return _p_interval(self.p_gate, dt)


@dataclasses.dataclass(frozen=True)
class RetentionDrift(_IidFlips):
    """Time-dependent conductance drift (the paper's long-term axis): a
    stored bit decays w.p. 1 - (1 - p_unit)^dt over an interval of length
    dt -- the continuous-time process behind `Crossbar.drift`."""

    p_unit: float = 0.0

    def _rate(self, dt: float) -> float:
        return _p_interval(self.p_unit, dt)


@dataclasses.dataclass(frozen=True)
class StuckAtFaults(FaultModel):
    """Permanent defects: each cell is stuck-at-0 w.p. p_stuck0 and
    stuck-at-1 w.p. p_stuck1 (disjoint events).  The defect map ignores dt
    and is a function of the generator's state alone: the same seed gives
    the same map, so repeated corruption is idempotent.

    Sampled sparsely (module doc): a cell whose stored bit already equals
    its stuck value is a defect that makes no error."""

    p_stuck0: float = 0.0
    p_stuck1: float = 0.0

    @property
    def permanent(self) -> bool:
        return True

    def _defects(self, total: int, generator: torch.Generator):
        """(distinct sorted positions in [0, total), stuck-at-1 flags) on
        the generator's device, or None when no cell is defective."""
        p = self.p_stuck0 + self.p_stuck1
        pos = _distinct_positions(total, p, generator)
        if pos is None:
            return None
        u = torch.rand(pos.numel(), generator=generator,
                       device=generator.device, dtype=torch.float64)
        return pos, u < self.p_stuck1 / p

    def _planes(self, m: torch.Tensor):
        """The reference's (sa0, sa1) of 23-bit uniform mantissas:
        ``u < p0`` and ``p0 <= u < p0 + p1``, p rounded to float32."""
        t0 = prng.threshold(self.p_stuck0)
        t01 = prng.threshold(self.p_stuck0 + self.p_stuck1)
        return m < t0, (m >= t0) & (m < t01)

    def stuck_masks(self, generator: torch.Generator,
                    shape: Tuple[int, ...]):
        """(sa0, sa1) bool defect maps of `shape` on the generator's
        device; disjoint by construction.  With a key, the reference's
        maps from one uniform plane."""
        if prng.is_key(generator):
            b = prng.bits(generator, shape)
            return self._planes(b >> 9)
        n = math.prod(shape)
        sa0 = torch.zeros(n, dtype=torch.bool, device=generator.device)
        sa1 = torch.zeros_like(sa0)
        found = self._defects(n, generator)
        if found is not None:
            pos, one = found
            sa1[pos[one]] = True
            sa0[pos[~one]] = True
        return sa0.reshape(shape), sa1.reshape(shape)

    @staticmethod
    def stick_bits(bits: torch.Tensor, sa0: torch.Tensor,
                   sa1: torch.Tensor) -> torch.Tensor:
        """Given defect maps applied to a bool plane: ``(bits & ~sa0) |
        sa1`` (the reference's `corrupt_bits` for its masks)."""
        return (bits & ~sa0) | sa1

    @staticmethod
    def stuck_word_mask(words: torch.Tensor, sa0: torch.Tensor,
                        sa1: torch.Tensor) -> torch.Tensor:
        """The int32 XOR mask that given (..., 32) bool defect planes make
        over `words` (the reference's `word_mask` for its masks): set bits
        stuck at 0 and clear bits stuck at 1 flip."""
        sa0w, sa1w = pack_flip_mask(sa0), pack_flip_mask(sa1)
        return (words & sa0w) | (~words & sa1w)

    @staticmethod
    def lane_masks_from(sa0: torch.Tensor, sa1: torch.Tensor):
        """(keep, flip) lane masks of given (n_gates, trials) defect maps:
        ``(v & ~sa0) | sa1 == (v & ~(sa0 | sa1)) ^ sa1`` (disjoint)."""
        sa1w = pack_trials(sa1.T).T.contiguous()
        return ~(pack_trials(sa0.T).T | sa1w), sa1w

    def _stick_flat_(self, flat: torch.Tensor,
                     generator: torch.Generator) -> None:
        width = flat.element_size() * 8
        found = self._defects(flat.numel() * width, generator)
        if found is None:
            return
        pos, one = (t.to(flat.device) for t in found)
        _stick_bits_(flat, pos // width, pos % width, one)

    def corrupt_bits(self, bits, generator, dt: float = 1.0):
        if prng.is_key(generator):
            sa0, sa1 = self.stuck_masks(generator.to(bits.device),
                                        tuple(bits.shape))
            return self.stick_bits(bits, sa0, sa1)
        out = bits.clone().reshape(-1)
        found = self._defects(out.numel(), generator)
        if found is not None:
            pos, one = (t.to(out.device) for t in found)
            out[pos] = one
        return out.reshape(bits.shape)

    def corrupt_words(self, words, generator, dt: float = 1.0):
        if prng.is_key(generator):
            return words ^ self.word_mask(generator, words, dt)
        out = words.clone()
        self._stick_flat_(out.view(-1), generator)
        return out

    def word_mask(self, generator, words, dt: float = 1.0):
        if prng.is_key(generator):
            sa0w, sa1w = (w.view(words.shape) for w in prng.word_plane(
                generator.to(words.device), words.numel(), self._planes))
            return (words & sa0w) | (~words & sa1w)
        return self.corrupt_words(words, generator, dt) ^ words

    def corrupt_leaf_(self, x, generator, dt: float = 1.0) -> None:
        if prng.is_key(generator):
            return super().corrupt_leaf_(x, generator, dt)
        self._stick_flat_(_bits_view(x), generator)

    def corrupt_window_(self, w, a, leaf, generator, dt: float = 1.0):
        if prng.is_key(generator):
            sa0w, sa1w = prng.word_plane(generator.to(w.device), w.numel(),
                                         self._planes, start=a)
            w ^= _payload((w & sa0w) | (~w & sa1w), a, leaf)
            return
        found = self._defects(_leaf_bits(leaf), generator)
        if found is not None and w.numel():
            pos, one = (t.to(w.device) for t in found)
            word, bit, keep = _window_bits(pos, leaf, a, a + w.numel())
            if word.numel():
                _stick_bits_(w, word, bit, one[keep])

    def gate_lane_masks(self, generator, n_gates: int, trials: int,
                        dt: float = 1.0):
        if prng.is_key(generator):
            # (v & ~sa0) | sa1 == (v & ~(sa0 | sa1)) ^ sa1: disjoint maps
            sa0w, sa1w = prng.lane_plane(_gate_keys(generator, n_gates),
                                         trials, self._planes)
            return ~(sa0w | sa1w), sa1w
        tw = -(-trials // PACK)
        dev = generator.device
        stuck = torch.zeros((n_gates, tw), dtype=torch.int32, device=dev)
        flip = torch.zeros_like(stuck)
        found = self._defects(n_gates * trials, generator)
        if found is not None:
            pos, one = found
            g, t = pos // trials, pos % trials
            idx, bit = g * tw + t // PACK, t % PACK
            _xor_bits_(stuck.view(-1), idx, bit)
            if bool(one.any()):
                _xor_bits_(flip.view(-1), idx[one], bit[one])
        return ~stuck, flip


@dataclasses.dataclass(frozen=True)
class CompositeFault(FaultModel):
    """Sequential composition: the members corrupt in order, each drawing
    from the same generator after the one before it.  A key is split once
    per member, as the reference splits it."""

    models: Tuple[FaultModel, ...] = ()

    @property
    def permanent(self) -> bool:
        return bool(self.models) and all(m.permanent for m in self.models)

    def corrupt_bits(self, bits, generator, dt: float = 1.0):
        for m, g in zip(self.models,
                        prng.streams(generator, len(self.models))):
            bits = m.corrupt_bits(bits, g, dt)
        return bits

    def corrupt_words(self, words, generator, dt: float = 1.0):
        for m, g in zip(self.models,
                        prng.streams(generator, len(self.models))):
            words = m.corrupt_words(words, g, dt)
        return words

    def word_mask(self, generator, words, dt: float = 1.0):
        return self.corrupt_words(words, generator, dt) ^ words

    def corrupt_leaf_(self, x, generator, dt: float = 1.0) -> None:
        for m, g in zip(self.models,
                        prng.streams(generator, len(self.models))):
            m.corrupt_leaf_(x, g, dt)

    def corrupt_window_(self, w, a, leaf, generator, dt: float = 1.0):
        for m, g in zip(self.models,
                        prng.streams(generator, len(self.models))):
            m.corrupt_window_(w, a, leaf, g, dt)

    @staticmethod
    def compose_lane_masks(pairs, n_gates: int, tw: int, device=None):
        """Fold members' (keep, flip) lane masks in order: f2(f1(v)) with
        f = (v & K) ^ F gives K = K1 & K2, F = (F1 & K2) ^ F2."""
        keep = torch.full((n_gates, tw), -1, dtype=torch.int32,
                          device=device)
        flip = torch.zeros_like(keep)
        for k2, f2 in pairs:
            keep = keep & k2
            flip = (flip & k2) ^ f2
        return keep, flip

    def gate_lane_masks(self, generator, n_gates: int, trials: int,
                        dt: float = 1.0):
        if prng.is_key(generator):       # member j: split(fold_in(key, g))[j]
            keys = prng.split(_gate_keys(generator, n_gates),
                              len(self.models))
            sources = [keys[:, j] for j in range(len(self.models))]
        else:
            sources = [generator] * len(self.models)
        return self.compose_lane_masks(
            (m.gate_lane_masks(g, n_gates, trials, dt)
             for m, g in zip(self.models, sources)),
            n_gates, -(-trials // PACK), generator.device)


def inject_bit_flips(params: Any, generator: torch.Generator,
                     p_bit: float) -> Any:
    """Flip each stored bit of every leaf with probability p_bit, in place
    (`TransientBitFlips(p_bit).corrupt`, from a generator or a key); returns
    the tree.  The reference returns a corrupted copy."""
    return TransientBitFlips(p_bit).corrupt(params, generator)
