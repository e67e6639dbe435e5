"""Deterministic synthetic token pipeline (port of `repro.data.synthetic`;
numpy, so the tokens are the reference's bit for bit).

A hash-based stream (splitmix-style counter hashing) so that (a) every data-
parallel rank reads a disjoint deterministic shard without coordination,
(b) restarts resume exactly from the step counter (fault tolerance without a
data-state checkpoint), and (c) the stream has enough structure for the loss
to fall (a learnable n-gram-ish mixture rather than pure noise).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from ..models.config import ModelConfig
from ..models.params import Spec

__all__ = ["SyntheticLM", "make_batch_specs"]


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass
class SyntheticLM:
    """Deterministic LM batches: tokens[t+1] depends on tokens[t] (Markov
    structure a model can learn), seeded per (step, rank)."""

    vocab: int
    seq_len: int
    batch_per_rank: int
    rank: int = 0
    world: int = 1
    seed: int = 1234

    def batch_at(self, step: int) -> np.ndarray:
        B, S = self.batch_per_rank, self.seq_len
        ctr = (np.uint64(self.seed) + np.uint64(step) * np.uint64(self.world)
               + np.uint64(self.rank))
        base = np.arange(B * S, dtype=np.uint64).reshape(B, S)
        h = _splitmix64(base + ctr * np.uint64(0x51ED2701))
        noise = (h % np.uint64(self.vocab)).astype(np.int64)
        # Markov backbone: x[t+1] = (a * x[t] + c) mod V with rare resets
        out = np.empty((B, S), np.int64)
        out[:, 0] = noise[:, 0]
        a, c = 31, 17
        reset = (h % np.uint64(13)) == 0
        for t in range(1, S):
            nxt = (a * out[:, t - 1] + c) % self.vocab
            out[:, t] = np.where(reset[:, t], noise[:, t], nxt)
        return out.astype(np.int32)

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch_specs(cfg: ModelConfig, global_batch: int, seq_len: int,
                     mem_len: int = 0) -> Dict[str, Spec]:
    """Spec tree for one training batch (used by dry-run input_specs)."""
    specs = {"tokens": Spec((global_batch, seq_len), ("batch", "seq"), dtype="int32")}
    if cfg.family == "vlm":
        specs["vis_emb"] = Spec((global_batch, mem_len or cfg.vis_tokens,
                                 cfg.vis_dim), ("batch", None, None))
    if cfg.family == "encdec":
        specs["enc_emb"] = Spec((global_batch, mem_len or seq_len,
                                 cfg.d_model), ("batch", None, "model_dim"))
    return specs
