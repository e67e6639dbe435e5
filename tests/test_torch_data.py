"""The port's data pipeline (`repro_torch.data`) against the JAX
package's: the synthetic LM stream is numpy in both, so every token must
match bit for bit, for every rank, world size, seed and step."""
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.data import Prefetcher as JPrefetcher
from repro.data import ShardedLoader as JLoader
from repro.data import SyntheticLM as JSynthetic
from repro.data import make_batch_specs as j_batch_specs
from repro_torch.configs import get_config
from repro_torch.data import (Prefetcher, ShardedLoader, SyntheticLM,
                              make_batch_specs)

CASES = [dict(vocab=100, seq_len=32, batch_per_rank=4, seed=7),
         dict(vocab=32064, seq_len=256, batch_per_rank=8, seed=0),
         dict(vocab=50, seq_len=16, batch_per_rank=2, rank=1, world=4),
         dict(vocab=1000, seq_len=64, batch_per_rank=3, rank=3, world=4,
              seed=1234)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"V{c['vocab']}")
@pytest.mark.parametrize("step", [0, 5, 123456])
def test_tokens_match_reference_bit_for_bit(case, step):
    got = SyntheticLM(**case).batch_at(step)
    want = JSynthetic(**case).batch_at(step)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_determinism():
    a = SyntheticLM(vocab=100, seq_len=32, batch_per_rank=4, seed=7)
    b = SyntheticLM(vocab=100, seq_len=32, batch_per_rank=4, seed=7)
    assert np.array_equal(a.batch_at(5), b.batch_at(5))
    assert not np.array_equal(a.batch_at(5), a.batch_at(6))


def test_ranks_disjoint():
    r0 = SyntheticLM(vocab=100, seq_len=32, batch_per_rank=4, rank=0, world=4)
    r1 = SyntheticLM(vocab=100, seq_len=32, batch_per_rank=4, rank=1, world=4)
    assert not np.array_equal(r0.batch_at(0), r1.batch_at(0))


def test_learnable_structure():
    """Most transitions follow the Markov rule (a learnable backbone)."""
    b = SyntheticLM(vocab=1000, seq_len=256, batch_per_rank=8).batch_at(0)
    follows = (b[:, 1:] == (31 * b[:, :-1] + 17) % 1000).mean()
    assert follows > 0.7


def test_tokens_in_range():
    b = SyntheticLM(vocab=50, seq_len=16, batch_per_rank=2).batch_at(3)
    assert b.min() >= 0 and b.max() < 50


def test_iterator_walks_the_steps():
    d = SyntheticLM(vocab=64, seq_len=8, batch_per_rank=2, seed=3)
    it = iter(d)
    for step in range(3):
        np.testing.assert_array_equal(next(it), d.batch_at(step))


def test_prefetcher_preserves_order_and_closes():
    pf = Prefetcher(iter(range(10)), depth=3)
    assert list(pf) == list(JPrefetcher(iter(range(10)), depth=3))
    pf2 = Prefetcher(iter(range(1000)), depth=2)
    next(pf2)
    pf2.close()


def test_prefetcher_surfaces_source_errors():
    def source():
        yield 1
        raise ValueError("source failed")

    pf = Prefetcher(source(), depth=2)
    assert next(pf) == 1
    with pytest.raises(ValueError, match="source failed"):
        next(pf)


def test_sharded_loader_matches_reference():
    make = lambda cls: (lambda r, w: cls(vocab=100, seq_len=8,
                                         batch_per_rank=2, rank=r, world=w))
    got = ShardedLoader(make(SyntheticLM), world=3).batch_at(4)
    want = JLoader(make(JSynthetic), world=3).batch_at(4)
    assert got.shape == (6, 8)
    np.testing.assert_array_equal(got, want)


def test_batch_specs_match_reference():
    got = make_batch_specs(get_config("phi3-mini-3.8b"), 8, 256)
    want = j_batch_specs(jax_config("phi3-mini-3.8b"), 8, 256)
    assert got.keys() == want.keys() == {"tokens"}
    s, w = got["tokens"], want["tokens"]
    assert (s.shape, s.axes, s.dtype) == (w.shape, w.axes, w.dtype)
