"""Packed parameter arena (port of `repro.core.arena`).

One contiguous int32 word buffer holds every leaf of a parameter tree:

    [ leaf0 words | pad | leaf1 words | pad | ... ]

Every leaf starts on a 32-word (ECC block) boundary and pad words are zero,
exactly as in the reference, so the same tree gives the same words, the
same parity and the same counters in both packages.  Leaf order is the
reference's flatten order (sorted dict keys, `core.tree`).

Unlike the reference, the arena IS the storage: `unpack` returns views
(float32 leaves as int32 -> float32 views; bfloat16 leaves as a bfloat16
view, since the reference packs bf16 LSB-half first, which is the
little-endian layout).  Corrupt, scrub and vote act on the words the model
reads, with no pack/unpack copies.  A (C, n_words) arena of C same-layout
copies unpacks to per-leaf (C, *shape) strided views.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from . import tree as T

__all__ = ["BLOCK", "LeafSpec", "ArenaSpec", "arena_spec", "words_for",
           "leaf_to_words", "words_to_leaf", "pack", "unpack", "words_of",
           "backing", "torch_dtype"]

BLOCK = 32  # words per ECC block == bits per word

_NP_TO_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int32": torch.int32}


def torch_dtype(dtype: Any) -> torch.dtype:
    """torch dtype of a torch dtype, numpy dtype or dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _NP_TO_TORCH:
        raise TypeError(f"arena: unsupported dtype {dtype}")
    return _NP_TO_TORCH[name]


def _n_elems(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def words_for(shape, dtype) -> int:
    """Payload words of a leaf (bfloat16 packs two halves per word)."""
    n = _n_elems(shape)
    return (n + 1) // 2 if torch_dtype(dtype) == torch.bfloat16 else n


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Placement of one leaf inside the arena (host-side constants)."""
    offset: int          # word offset of the leaf start (block-aligned)
    n_words: int         # payload words (bf16 halves packed two per word)
    pad_words: int       # zero words up to the next block boundary
    dtype: torch.dtype
    shape: Tuple[int, ...]

    @property
    def n_blocks(self) -> int:
        return (self.n_words + self.pad_words) // BLOCK


@dataclasses.dataclass(frozen=True)
class ArenaSpec:
    leaves: Tuple[LeafSpec, ...]
    paths: Tuple[Tuple[str, ...], ...]   # the tree structure (flatten order)
    n_words: int                         # multiple of BLOCK

    @property
    def n_blocks(self) -> int:
        return self.n_words // BLOCK


def arena_spec(tree: Any) -> ArenaSpec:
    """Layout of a tree whose leaves carry `.shape` and `.dtype`."""
    specs, offset = [], 0
    for x in T.leaves(tree):
        dt = torch_dtype(x.dtype)
        n_words = words_for(x.shape, dt)
        pad = (-n_words) % BLOCK
        specs.append(LeafSpec(offset=offset, n_words=n_words, pad_words=pad,
                              dtype=dt, shape=tuple(int(s) for s in x.shape)))
        offset += n_words + pad
    return ArenaSpec(leaves=tuple(specs), paths=tuple(T.paths(tree)),
                     n_words=offset)


def leaf_to_words(x: torch.Tensor) -> torch.Tensor:
    """One leaf as its flat int32 payload words (no block padding); bf16
    pairs LSB-half first, an odd-length leaf ends in a zero half-word.  A
    view where the layout allows, else a copy."""
    flat = x.reshape(-1)
    if x.dtype == torch.bfloat16:
        if flat.numel() % 2:
            flat = torch.cat([flat, flat.new_zeros(1)])
        return flat.view(torch.int32)
    if x.dtype in (torch.float32, torch.int32):
        return flat.view(torch.int32)
    raise TypeError(f"arena: unsupported dtype {x.dtype}")


def words_to_leaf(words: torch.Tensor, spec: LeafSpec) -> torch.Tensor:
    """The leaf viewed out of its payload words (a view, no copy).  `words`
    is (n_words,) or (C, n_words) with unit stride along the words; the
    result is (*shape) or (C, *shape)."""
    lead = tuple(words.shape[:-1])
    n = _n_elems(spec.shape)
    if spec.dtype == torch.bfloat16:
        vals = words.view(torch.bfloat16)[..., :n]
    else:
        vals = words.view(spec.dtype)
    return vals.view(lead + spec.shape)


def pack(tree: Any) -> Tuple[torch.Tensor, ArenaSpec]:
    """Copy a tree into a fresh arena: (int32 words, spec)."""
    spec = arena_spec(tree)
    xs = T.leaves(tree)
    device = xs[0].device if xs else torch.device("cpu")
    words = torch.zeros(spec.n_words, dtype=torch.int32, device=device)
    for x, l in zip(xs, spec.leaves):
        words_to_leaf(words[l.offset:l.offset + l.n_words], l).copy_(x)
    return words, spec


def unpack(words: torch.Tensor, spec: ArenaSpec) -> Any:
    """The tree as views into `words` ((n_words,) or (C, n_words))."""
    views = [words_to_leaf(words[..., l.offset:l.offset + l.n_words], l)
             for l in spec.leaves]
    return T.unflatten(spec.paths, views)


def backing(tree: Any, copies: int = 0) -> Optional[Tuple[torch.Tensor,
                                                          ArenaSpec]]:
    """The arena behind a tree of arena views, laid out as `arena_spec`
    places them ((words, spec), no copy), or None when there is none;
    `copies` as in `words_of`."""
    xs = T.leaves(tree)
    if not xs or not all(isinstance(x, torch.Tensor) for x in xs):
        return None
    per_copy = T.map_tree(lambda x: x[0], tree) if copies else tree
    spec = arena_spec(per_copy)
    storage = xs[0].untyped_storage()
    base = xs[0].data_ptr()
    row = xs[0].stride(0) * xs[0].element_size() if copies else 0
    for x, l in zip(xs, spec.leaves):
        inner = x[0] if copies else x
        if (x.untyped_storage().data_ptr() != storage.data_ptr()
                or x.data_ptr() != base + 4 * l.offset
                or not inner.is_contiguous()):
            return None
        if copies and (x.shape[0] != copies
                       or x.stride(0) * x.element_size() != row):
            return None
    start = base - storage.data_ptr()
    if start % 4 or row % 4:
        return None
    shape = (copies, spec.n_words) if copies else (spec.n_words,)
    stride = (row // 4, 1) if copies else (1,)
    end = start + 4 * ((copies - 1) * (row // 4) if copies else 0) \
        + 4 * spec.n_words
    if end > storage.nbytes():
        return None
    words = torch.empty(0, dtype=torch.int32, device=xs[0].device)
    words.set_(storage, start // 4, shape, stride)
    return words, spec


def words_of(tree: Any, copies: int = 0) -> Tuple[torch.Tensor, ArenaSpec]:
    """The arena behind a tree of arena views, without copying.

    `copies=0`: leaves are plain views of one (n_words,) arena; `copies=C`:
    leaves are (C, *shape) views of a (C, n_words) arena.  A tree that is
    not laid out over one arena exactly as `arena_spec` places it is
    packed into a fresh arena instead (a copy, as the reference's `pack`).
    """
    found = backing(tree, copies)
    if found is not None:
        return found
    if copies:
        rows = [pack(T.map_tree(lambda x, i=i: x[i], tree))
                for i in range(copies)]
        return torch.stack([w for w, _ in rows]), rows[0][1]
    return pack(tree)
