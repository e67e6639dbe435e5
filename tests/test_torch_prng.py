"""`repro_torch.core.prng` against `jax.random` (jax 0.9.0, its default
partitionable threefry, x64 off) on the CPU, bit for bit: keys of seeds 0,
1, 2**31 - 1 and -1, `split`, `fold_in`, `bits`, `uniform`, `bernoulli` and
`randint` (several ranges) over empty, scalar and odd shapes and across
chunk edges; the hash and the (hi, lo) counter words past 2**32 against
`threefry2x32_p` bound with explicit counts; `normal` over 2**20 draws.
And the floor: at p = 1e-9 the reference's and the port's keyed Bernoulli
agree bit for bit over 2**26 draws and flip at 2**-23 (a 99% Wilson
interval), where the generator route keeps the nominal rate."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax._src import prng as jprng
from repro_torch.core import prng
from repro_torch.faults.models import _distinct_positions
from repro_torch.faults.campaign import wilson_interval

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the draws are many small elementwise ops, which
    threads slow down when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
SEEDS = [0, 1, 2**31 - 1, -1]
SHAPES = [(), (0,), (1,), (7,), (3, 5), (2, 3, 4), (0, 3)]


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.key(seed, CPU)


def _i64(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def _f32_bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in(seed):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(tk.numpy(), _i64(jk))
    for n in (1, 2, 3, 7):
        np.testing.assert_array_equal(prng.split(tk, n).numpy(),
                                      _i64(jax.random.split(jk, n)))
    for d in (0, 1, 100, 2**31, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(tk, d).numpy(),
                                      _i64(jax.random.fold_in(jk, d)))
    # nested: a split of a fold_in of a split
    np.testing.assert_array_equal(
        prng.split(prng.fold_in(prng.split(tk, 3)[2], 5), 4).numpy(),
        _i64(jax.random.split(jax.random.fold_in(
            jax.random.split(jk, 3)[2], 5), 4)))


def test_batched_keys_split_and_fold_in():
    """A (G, 2) batch of keys splits each; a 1-D tensor of data folds each."""
    jk, tk = _keys(3)
    data = np.arange(9)
    ref = jax.vmap(lambda d: jax.random.fold_in(jk, d))(jnp.asarray(data))
    got = prng.fold_in(tk, torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), _i64(ref))
    np.testing.assert_array_equal(
        prng.split(got, 3).numpy(),
        _i64(jax.vmap(lambda k: jax.random.split(k, 3))(ref)))


def test_seed_is_taken_mod_2_32():
    """x64 off: the seed is an int32, the key [0, seed mod 2**32]."""
    for seed in (2**32 + 5, -(2**31), 4_000_000_000):
        np.testing.assert_array_equal(prng.key(seed, CPU).numpy(),
                                      _i64(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_uniform_bernoulli(seed, shape):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(prng.bits(tk, shape).numpy(),
                                  _i64(jax.random.bits(jk, shape)))
    np.testing.assert_array_equal(
        _f32_bits(prng.uniform(tk, shape).numpy()),
        _f32_bits(jax.random.uniform(jk, shape)))
    np.testing.assert_array_equal(
        _f32_bits(prng.uniform(tk, shape, -0.3, 1.7).numpy()),
        _f32_bits(jax.random.uniform(jk, shape, minval=-0.3, maxval=1.7)))
    for p in (0.0, 1e-9, 3e-8, 0.1, 0.5, 0.999, 1.0):
        np.testing.assert_array_equal(
            prng.bernoulli(tk, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(jk, p, shape)), err_msg=str(p))


RANGES = [(0, 10), (-5, 7), (0, 1), (3, 3), (5, 2), (0, 65536), (0, 65537),
          (0, 1 << 20), (0, 2**31 - 1), (-2**31, 2**31 - 1), (-100, -3)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", RANGES)
def test_randint(seed, lo, hi):
    jk, tk = _keys(seed)
    for shape in ((), (13,), (4, 6)):
        np.testing.assert_array_equal(
            prng.randint(tk, shape, lo, hi).numpy(),
            np.asarray(jax.random.randint(jk, shape, lo, hi)))


def test_chunk_edges(monkeypatch):
    """Draws cut into chunks of 5 and 32 elements equal one whole draw."""
    jk, tk = _keys(1)
    shape = (3, 37)
    for chunk in (5, 32):
        monkeypatch.setattr(prng, "CHUNK", chunk)
        np.testing.assert_array_equal(prng.bits(tk, shape).numpy(),
                                      _i64(jax.random.bits(jk, shape)))
        np.testing.assert_array_equal(
            prng.randint(tk, shape, -7, 1000).numpy(),
            np.asarray(jax.random.randint(jk, shape, -7, 1000)))
        np.testing.assert_array_equal(
            prng.bernoulli(tk, 0.3, shape).numpy(),
            np.asarray(jax.random.bernoulli(jk, 0.3, shape)))
        np.testing.assert_array_equal(
            _f32_bits(prng.normal(tk, shape).numpy()),
            _f32_bits(jax.random.normal(jk, shape)))
        words = prng.word_plane(tk, 41, lambda m: m < prng.threshold(0.2))
        flips = np.asarray(jax.random.bernoulli(jk, 0.2, (41, 32)))
        ref = (flips.astype(np.uint64) << np.arange(32, dtype=np.uint64)
               ).sum(-1).astype(np.uint32)
        np.testing.assert_array_equal(words.numpy().view(np.uint32), ref)


@pytest.mark.parametrize("seed", [0, 2**31 - 1])
def test_hash_matches_threefry_primitive(seed):
    rng = np.random.default_rng(seed)
    k0, k1, x0, x1 = (rng.integers(0, 2**32, 257, dtype=np.uint64
                                   ).astype(np.uint32) for _ in range(4))
    r0, r1 = jprng.threefry2x32_p.bind(*(jnp.asarray(a)
                                          for a in (k0, k1, x0, x1)))
    t = [torch.from_numpy(a.astype(np.int64)) for a in (k0, k1, x0, x1)]
    g0, g1 = prng.threefry2x32(*t)
    np.testing.assert_array_equal(g0.numpy(), _i64(r0))
    np.testing.assert_array_equal(g1.numpy(), _i64(r1))


@pytest.mark.parametrize("start", [2**32 - 3, 2**32, 3 * 2**32 + 11,
                                   2**40 - 2])
def test_counter_words_past_2_32(start):
    """Element i hashes (i >> 32, i & 0xFFFFFFFF): the port's range past
    2**32 against the primitive bound with those count words."""
    jk, tk = _keys(7)
    idx = np.arange(start, start + 9, dtype=np.uint64)
    hi, lo = (idx >> np.uint64(32)).astype(np.uint32), \
        (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    k = np.asarray(jk)
    b1, b2 = jprng.threefry2x32_p.bind(
        jnp.full(9, k[0], jnp.uint32), jnp.full(9, k[1], jnp.uint32),
        jnp.asarray(hi), jnp.asarray(lo))
    ref = _i64(np.asarray(b1) ^ np.asarray(b2))
    np.testing.assert_array_equal(prng._bits_range(tk, start, 9).numpy(), ref)
    # the same counters below 2**32 are the reference's own bits
    np.testing.assert_array_equal(prng._bits_range(tk, 0, 9).numpy(),
                                  _i64(jax.random.bits(jk, (9,))))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_over_2_pow_20_draws(seed):
    """Both branches of the erfinv polynomial (|u| > 0.9966 takes the
    square-root one), bit for bit."""
    jk, tk = _keys(seed)
    n = 1 << 20
    np.testing.assert_array_equal(_f32_bits(prng.normal(tk, (n,)).numpy()),
                                  _f32_bits(jax.random.normal(jk, (n,))))


def test_bernoulli_floor_at_2_pow_minus_23():
    """p = 1e-9: the reference's keyed Bernoulli and the port's agree bit
    for bit over 2**26 draws, and flip at ceil(float32(p) * 2**23) / 2**23
    = 2**-23 (inside the count's 99% Wilson interval; 1e-9 is not).  The
    generator route flips at the nominal p: over 64 seeds of 2**26 bits,
    1e-9 is inside its interval and 2**-23 is not."""
    p, n = 1e-9, 1 << 26
    jk, tk = _keys(0)
    ref = np.flatnonzero(np.asarray(jax.random.bernoulli(jk, p, (n,))))
    got = np.flatnonzero(prng.bernoulli(tk, p, (n,)).numpy())
    np.testing.assert_array_equal(got, ref)
    lo, hi = wilson_interval(len(got), n, 2.576)
    assert lo <= 2.0**-23 <= hi and not lo <= p <= hi, (len(got), lo, hi)

    # the generator route's sampler (what TransientBitFlips.bit_flips
    # draws): a binomial count of distinct positions
    flips = 0
    for s in range(64):
        pos = _distinct_positions(n, p, torch.Generator().manual_seed(s))
        flips += 0 if pos is None else pos.numel()
    lo, hi = wilson_interval(flips, 64 * n, 2.576)
    assert lo <= p <= hi and not lo <= 2.0**-23 <= hi, (flips, lo, hi)
