"""Word-level diagonal-parity code (port of `repro.core.reliability`): the
word functions, the plain version behind `kernels/diag_parity/ref.py`;
`ReliableStore`, the ECC-protected parameter tree over the packed arena;
the per-leaf path (`protect_leaves`, `scrub_leaves`); and `tmr_serve`.

A block is 32 consecutive words, a 32 x 32 bit matrix; the slope-s parity
word is ``XOR_i rotl32(w_i, s*i)``.  Slopes (1, 2) locate a single flipped
bit, every other slope must agree with that location.  Words are int32
storage; the arithmetic runs in int64 masked to 32 bits (`core.bitops`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from . import arena
from . import tree as T
from .arena import BLOCK
from .bitops import MASK32, as_i32, as_u64, popcount32, rotl32

__all__ = ["WordEccConfig", "ScrubReport", "encode_words", "syndrome_words",
           "correct_words", "ReliableStore", "protect_leaves",
           "scrub_leaves", "tmr_serve"]


@dataclasses.dataclass(frozen=True)
class WordEccConfig:
    slopes: Tuple[int, ...] = (1, 2, -1)

    @property
    def n_parity_words(self) -> int:
        return len(self.slopes)


class ScrubReport(NamedTuple):
    corrected: torch.Tensor      # int32: blocks with a single bit corrected
    parity_fixed: torch.Tensor   # int32: blocks where a check word was fixed
    uncorrectable: torch.Tensor  # int32: blocks with >= 2 errors


def _xor_reduce_rows(x: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis (length a power of two) by halving."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] ^ x[..., half:]
    return x[..., 0]


def _encode_u64(blocks: torch.Tensor, slopes: Tuple[int, ...]) -> torch.Tensor:
    i = torch.arange(BLOCK, dtype=torch.int64, device=blocks.device)
    return torch.stack([_xor_reduce_rows(rotl32(blocks, (s * i) % BLOCK))
                        for s in slopes], dim=-1)


def _blocks(words: torch.Tensor) -> torch.Tensor:
    if words.ndim != 1 or words.numel() % BLOCK:
        raise ValueError(f"expected a flat word buffer of whole blocks, "
                         f"got shape {tuple(words.shape)}")
    return as_u64(words).view(-1, BLOCK)


def encode_words(words: torch.Tensor,
                 cfg: WordEccConfig = WordEccConfig()) -> torch.Tensor:
    """Parity words of a flat int32 buffer: (n_blocks, n_families) int32.

    parity[b, f] = XOR_i rotl32(words[b*32 + i], slopes[f] * i)"""
    return as_i32(_encode_u64(_blocks(words), cfg.slopes))


def syndrome_words(words: torch.Tensor, parity: torch.Tensor,
                   cfg: WordEccConfig = WordEccConfig()) -> torch.Tensor:
    return encode_words(words, cfg) ^ parity


def correct_words(words: torch.Tensor, parity: torch.Tensor,
                  cfg: WordEccConfig = WordEccConfig()):
    """Locate and correct one flipped bit per 32-word block.

    For an error in data word i0, bit j0 the slope-s syndrome is one-hot at
    k_s = (j0 + s*i0) mod 32; slopes (1, 2) give i0 = k_2 - k_1 and
    j0 = k_1 - i0.  Returns new (words, parity, ScrubReport); the inputs are
    not modified."""
    slopes = list(cfg.slopes)
    blocks = _blocks(words)
    syn = _encode_u64(blocks, cfg.slopes) ^ as_u64(parity)     # (B, F)
    pop = popcount32(syn)
    hot = popcount32((syn - 1) & MASK32).to(torch.int64)       # one-hot index
    nonzero = pop > 0
    onehot = pop == 1
    n_nonzero = nonzero.sum(-1)

    ia, ib = slopes.index(1), slopes.index(2)
    i0 = (hot[:, ib] - hot[:, ia]) % BLOCK
    j0 = (hot[:, ia] - i0) % BLOCK
    consistent = torch.ones_like(nonzero[:, 0])
    for f, s in enumerate(slopes):
        consistent &= hot[:, f] == (j0 + s * i0) % BLOCK

    data_err = (n_nonzero == len(slopes)) & onehot.all(-1) & consistent
    parity_err = (n_nonzero == 1) & (onehot | ~nonzero).all(-1)
    uncorrectable = (n_nonzero > 0) & ~data_err & ~parity_err

    flip = torch.where(data_err, torch.ones_like(j0) << j0,
                       torch.zeros_like(j0))
    row = torch.arange(BLOCK, device=words.device)[None, :] == i0[:, None]
    fixed = blocks ^ (row.to(torch.int64) * flip[:, None])
    parity_fix = torch.where(parity_err[:, None] & nonzero, syn,
                             torch.zeros_like(syn))
    report = ScrubReport(
        corrected=data_err.sum(dtype=torch.int32),
        parity_fixed=parity_err.sum(dtype=torch.int32),
        uncorrectable=uncorrectable.sum(dtype=torch.int32))
    return (as_i32(fixed.reshape(-1)),
            as_i32(as_u64(parity) ^ parity_fix), report)


# --------------------------------------------------------------------------
# parameter-store integration (arena-backed)
# --------------------------------------------------------------------------

def _ecc(cfg: WordEccConfig, backend: str):
    """The scheme a ReliableStore delegates to (one implementation of pack,
    encode and scrub, in `reliability.scheme`)."""
    if backend not in ("kernel", "torch"):
        raise ValueError(f"backend must be 'kernel' or 'torch', got "
                         f"{backend!r}")
    from ..reliability.scheme import DiagParityEcc
    return DiagParityEcc(slopes=cfg.slopes, impl=backend)


class ReliableStore:
    """ECC-protected parameter tree (the paper's §IV at datacenter scale).

    `protect` packs the tree into one arena (`core.arena`) and encodes its
    (n_blocks, 3) parity table in one launch; `params` are views of that
    arena.  `scrub()` runs the fused encode -> syndrome -> locate -> correct
    over the whole arena in one launch, in place (the reference returns a
    new store): it returns the store, whose params now hold the corrected
    bits, and a ScrubReport.  `refresh(params)` re-protects after the
    weights were rewritten.  A store built from params and a parity table
    (`ReliableStore(params, parity)`) scrubs the params' own arena in place
    when they are views laid out over one, else a packed copy.

    backend="kernel" (default) dispatches the CUDA kernels on CUDA tensors
    (their plain versions on CPU tensors); backend="torch" runs the plain
    versions on any device.  Both give the same bits.
    """

    def __init__(self, params: Any, parity: torch.Tensor,
                 cfg: WordEccConfig = WordEccConfig(),
                 backend: str = "kernel"):
        _ecc(cfg, backend)
        self.params = params
        self.parity = parity
        self.cfg = cfg
        self.backend = backend

    @staticmethod
    def protect(params: Any, cfg: WordEccConfig = WordEccConfig(),
                backend: str = "kernel") -> "ReliableStore":
        prot = _ecc(cfg, backend).protect(params)
        return ReliableStore(prot.payload, prot.redundancy, cfg, backend)

    def refresh(self, new_params: Any) -> "ReliableStore":
        return ReliableStore.protect(new_params, self.cfg, self.backend)

    def scrub(self) -> Tuple["ReliableStore", ScrubReport]:
        scheme = _ecc(self.cfg, self.backend)
        fixed, report = scheme.scrub(scheme.adopt(self.params, self.parity))
        return ReliableStore(fixed.payload, fixed.redundancy, self.cfg,
                             self.backend), report

    @property
    def n_blocks(self) -> int:
        return int(self.parity.shape[0])


# --------------------------------------------------------------------------
# per-leaf path: one encode or scrub a leaf, the pre-arena layout
# --------------------------------------------------------------------------

def _pad_leaf_words(x: torch.Tensor) -> torch.Tensor:
    words = arena.leaf_to_words(x)
    pad = (-words.numel()) % BLOCK
    return torch.cat([words, words.new_zeros(pad)]) if pad else words


def protect_leaves(params: Any, cfg: WordEccConfig = WordEccConfig()) -> Any:
    """Per-leaf parity tree (the pre-arena layout): one encode a leaf."""
    return T.map_tree(lambda x: encode_words(_pad_leaf_words(x), cfg), params)


def scrub_leaves(params: Any, parity_tree: Any,
                 cfg: WordEccConfig = WordEccConfig()):
    """Per-leaf scrub (the pre-arena path): one plain scrub a leaf.
    Returns new (params, parity tree, summed ScrubReport); the inputs are
    not modified."""
    leaves, pleaves = T.leaves(params), T.leaves(parity_tree)
    out_p, out_c, reps = [], [], []
    for x, par in zip(leaves, pleaves):
        fixed, par2, rep = correct_words(_pad_leaf_words(x), par, cfg)
        n_words = arena.words_for(x.shape, x.dtype)
        spec = arena.LeafSpec(offset=0, n_words=n_words, pad_words=0,
                              dtype=x.dtype, shape=tuple(x.shape))
        out_p.append(arena.words_to_leaf(fixed[:n_words], spec))
        out_c.append(par2)
        reps.append(rep)
    total = ScrubReport(*(sum(r[i] for r in reps) for i in range(3)))
    paths = T.paths(params)
    return T.unflatten(paths, out_p), T.unflatten(paths, out_c), total


def tmr_serve(serve_fn, mode: str = "serial", use_kernel: bool = True):
    """TMR-voted serving through `reliability.Tmr.wrap` (the reference's
    deprecated shim): wrapped(p1, p2, p3, *inputs) with the three copies'
    parameters; mode is 'serial', 'parallel' or 'semi_parallel';
    use_kernel=False votes with the plain version."""
    from ..reliability.scheme import Tmr
    return Tmr(discipline=mode,
               impl=None if use_kernel else "torch").wrap(serve_fn)
