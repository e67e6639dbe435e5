"""The port's sparse transient-fault sampler (repro_torch.faults): a
Binomial(n_bits, p) count of distinct uniform bit positions, flipped in
place.  It has the reference's distribution, not its bits (the JAX
cross-checks feed JAX's masks instead), so it is held to the distribution
here.  `pack_flip_mask` is held to the JAX package's bit for bit, and
`inject_bit_flips` to `TransientBitFlips.corrupt`."""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import arena
from repro_torch.faults import (TransientBitFlips, flip_random_bits_,
                                inject_bit_flips, pack_flip_mask)

try:    # without JAX (as on a GPU machine) only the JAX-free cases run
    import jax.numpy as jnp
    from repro.faults.models import pack_flip_mask as j_pack_flip_mask
except ImportError:
    jnp = None


def _popcount(x: torch.Tensor) -> int:
    b = x.contiguous().view(torch.uint8).numpy()
    return int(np.unpackbits(b).sum())


@pytest.mark.parametrize("dtype", [torch.int32, torch.int16])
@pytest.mark.parametrize("p", [1e-4, 3e-3])
def test_flip_count_is_binomial_and_positions_distinct(dtype, p):
    n = 1 << 16
    g = torch.Generator().manual_seed(int(p * 1e6) + n)
    counts = []
    for _ in range(20):
        bits = torch.zeros(n, dtype=dtype)
        k = flip_random_bits_(bits, p, g)
        assert _popcount(bits) == k             # distinct positions
        counts.append(k)
    total = n * bits.element_size() * 8
    mean, sd = total * p, math.sqrt(total * p * (1 - p))
    # the mean of 20 draws lies within 5 standard errors of n p
    assert abs(np.mean(counts) - mean) < 5 * sd / math.sqrt(20)


def test_positions_are_uniform_over_words_and_bits():
    g = torch.Generator().manual_seed(0)
    bits = torch.zeros(4096, dtype=torch.int32)
    flip_random_bits_(bits, 0.5, g)
    plane = np.unpackbits(bits.view(torch.uint8).numpy()).reshape(4096, 32)
    # fair coins: each bit lane (4096 draws, sd 0.008) and each run of 64
    # words (2048 draws, sd 0.011) is hit half the time, within 0.05
    assert np.abs(plane.mean(0) - 0.5).max() < 0.05
    assert np.abs(plane.reshape(64, -1).mean(1) - 0.5).max() < 0.05


def test_corrupt_is_in_place_and_spares_bf16_padding():
    tree = {"w": torch.zeros(33, dtype=torch.float32),
            "h": torch.zeros(7, dtype=torch.bfloat16)}
    words, spec = arena.pack(tree)
    views = arena.unpack(words, spec)
    g = torch.Generator().manual_seed(1)
    out = TransientBitFlips(0.5).corrupt(views, g)
    assert out is views and _popcount(words) > 0     # flipped the arena
    h = spec.leaves[spec.paths.index(("h",))]
    last = words[h.offset + h.n_words - 1].item()
    assert (last >> 16) & 0xFFFF == 0                # odd leaf: pad half 0
    for leaf in spec.leaves:                         # block padding stays 0
        end = leaf.offset + leaf.n_words
        assert int(words[end:end + leaf.pad_words].abs().sum()) == 0


def test_zero_rate_draws_nothing():
    g = torch.Generator().manual_seed(2)
    state = g.get_state()
    bits = torch.zeros(100, dtype=torch.int32)
    assert flip_random_bits_(bits, 0.0, g) == 0
    assert torch.equal(g.get_state(), state) and int(bits.abs().sum()) == 0


@pytest.mark.skipif(jnp is None, reason="needs the JAX package")
@pytest.mark.parametrize("shape", [(32,), (5, 32), (3, 7, 32)])
@pytest.mark.parametrize("density", [0.0, 0.1, 0.5, 1.0])
def test_pack_flip_mask_matches_jax(shape, density):
    flips = np.random.default_rng(len(shape)).random(shape) < density
    got = pack_flip_mask(torch.from_numpy(flips))
    assert got.dtype == torch.int32 and got.shape == shape[:-1]
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(j_pack_flip_mask(
                                      jnp.asarray(flips))))


def test_inject_bit_flips_is_corrupt_in_place():
    tree = {"w": torch.zeros(4096, dtype=torch.float32),
            "h": torch.zeros(1001, dtype=torch.bfloat16)}
    words, spec = arena.pack(tree)
    views = arena.unpack(words, spec)
    g = torch.Generator().manual_seed(4)
    state = g.get_state()
    out = inject_bit_flips(views, g, 3e-3)
    assert out is views and _popcount(words) > 0
    ref_words, _ = arena.pack(tree)
    g.set_state(state)
    TransientBitFlips(3e-3).corrupt(arena.unpack(ref_words, spec), g)
    assert torch.equal(words, ref_words)             # the same draws
    n_bits = (4096 * 32 + 1001 * 16)
    assert abs(_popcount(words) - 3e-3 * n_bits) < 5 * math.sqrt(
        3e-3 * n_bits)


def test_store_sized_draws_keep_their_count_and_int64_positions():
    """The Fig. 5 store's draw (1.984e9 bits at 5e-4) keeps its binomial
    count, and positions past 2**31 stay exact int64."""
    from repro_torch.faults.models import _distinct_positions
    g = torch.Generator().manual_seed(6)
    total, p = 62_000_000 * 32, 5e-4
    pos = _distinct_positions(total, p, g)
    assert pos.dtype == torch.int64 and int(pos.max()) < total
    assert abs(pos.numel() - total * p) < 5 * math.sqrt(total * p)
    big = 4 * total                                  # 7.9e9 bits
    pos = _distinct_positions(big, 1e-6, g)
    assert pos.dtype == torch.int64 and int(pos.max()) < big
    assert int(pos.max()) > 2**32 and pos.unique().numel() == pos.numel()
