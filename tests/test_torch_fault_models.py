"""The port's stuck-at, retention-drift and composite fault models
(`repro_torch.faults.models`) against the JAX package's.

Given the reference's masks, bit for bit: `StuckAtFaults.stick_bits`,
`stuck_word_mask` and `lane_masks_from` fed JAX's `stuck_masks` equal
JAX's `corrupt_bits`, `word_mask`/`corrupt_words` and `gate_lane_masks`;
`CompositeFault` over members that replay JAX's per-member masks equals
JAX's `CompositeFault` (same member order, the reference's key split);
`compose_lane_masks` over JAX's member lane masks equals JAX's composite
lane masks; the engine's prepared stores, counters and tokens under
`--fault stuckat` equal JAX's given JAX's masks.  The port's own sparse
samplers draw other bits from a `torch.Generator`: their counts over 200
seeds must fit the binomial's mean and variance (`_binomial`, 99.9%
intervals), the stuck-at map is a function of the generator's seed (a
second corruption after reseeding changes nothing) and `permanent` says
so."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _binomial import counts_over_seeds, fits_binomial
from repro.configs import get_config
from repro.core import arena as jarena
from repro.faults import models as jm
from repro.launch.engine import GenerationEngine as JEngine
from repro.launch.engine import fetch_telemetry as j_fetch
from repro.models import params as JP
from repro.models import transformer as JT
from repro.reliability import parse_scheme as j_parse
from repro_torch.core import arena
from repro_torch.core.bitops import PACK
from repro_torch.faults import (CompositeFault, FaultModel, RetentionDrift,
                                StuckAtFaults, TransientBitFlips,
                                TransientGateFaults)
from repro_torch.faults.models import _p_interval, pack_flip_mask
from repro_torch.launch.engine import GenerationEngine, fetch_telemetry
from repro_torch.models.params import from_numpy
from repro_torch.reliability import parse_scheme

def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.int32).copy())


def _words(n, seed):
    return np.random.default_rng(seed).integers(
        0, 2**32, n, dtype=np.uint64).astype(np.uint32)


# -- given the reference's masks: bit for bit ---------------------------------

STUCK = [(0.01, 0.02), (0.05, 0.0), (0.0, 0.03)]


@pytest.mark.parametrize("p0,p1", STUCK)
@pytest.mark.parametrize("seed", [0, 1])
def test_stick_bits_matches_jax(p0, p1, seed):
    model = jm.StuckAtFaults(p0, p1)
    key = jax.random.PRNGKey(seed)
    bits = np.random.default_rng(seed).random((64, 48)) < 0.5
    sa0, sa1 = (torch.from_numpy(np.asarray(m).copy())
                for m in model.stuck_masks(key, bits.shape))
    want = np.asarray(model.corrupt_bits(jnp.asarray(bits), key))
    got = StuckAtFaults.stick_bits(torch.from_numpy(bits), sa0, sa1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p0,p1", STUCK)
@pytest.mark.parametrize("seed", [0, 1])
def test_stuck_word_mask_matches_jax(p0, p1, seed):
    model = jm.StuckAtFaults(p0, p1)
    key = jax.random.PRNGKey(seed)
    words = _words(777, seed)
    sa0, sa1 = (torch.from_numpy(np.asarray(m).copy())
                for m in model.stuck_masks(key, words.shape + (32,)))
    w = _i32(words)
    mask = StuckAtFaults.stuck_word_mask(w, sa0, sa1)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(model.word_mask(key, jnp.asarray(words)))
        .view(np.int32))
    np.testing.assert_array_equal(
        (w ^ mask).numpy(),
        np.asarray(model.corrupt_words(jnp.asarray(words), key))
        .view(np.int32))


@pytest.mark.parametrize("p0,p1", STUCK)
@pytest.mark.parametrize("trials", [32, 100])
def test_stuck_lane_masks_match_jax(p0, p1, trials):
    """Gate g's lane masks under JAX's key for gate g."""
    model = jm.StuckAtFaults(p0, p1)
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    planes = [model.stuck_masks(k, (trials,)) for k in keys]
    sa0 = torch.from_numpy(np.stack([np.asarray(a) for a, _ in planes]))
    sa1 = torch.from_numpy(np.stack([np.asarray(b) for _, b in planes]))
    keep, flip = StuckAtFaults.lane_masks_from(sa0, sa1)
    for g, k in enumerate(keys):
        jk, jf = model.gate_lane_masks(k, trials)
        np.testing.assert_array_equal(keep[g].numpy(),
                                      np.asarray(jk).view(np.int32))
        np.testing.assert_array_equal(flip[g].numpy(),
                                      np.asarray(jf).view(np.int32))


@pytest.mark.parametrize("trials", [32, 70])
def test_compose_lane_masks_matches_jax(trials):
    """K = K1 & K2, F = (F1 & K2) ^ F2 over JAX's member masks (drawn under
    JAX's split of the composite key) equals JAX's composite masks."""
    members = (jm.StuckAtFaults(0.05, 0.05), jm.TransientGateFaults(0.1),
               jm.StuckAtFaults(0.0, 0.02))
    key = jax.random.PRNGKey(7)
    pairs = [tuple(_i32(x)[None] for x in m.gate_lane_masks(k, trials))
             for m, k in zip(members, jax.random.split(key, len(members)))]
    keep, flip = CompositeFault.compose_lane_masks(
        pairs, 1, -(-trials // PACK))
    jk, jf = jm.CompositeFault(members).gate_lane_masks(key, trials)
    np.testing.assert_array_equal(keep[0].numpy(),
                                  np.asarray(jk).view(np.int32))
    np.testing.assert_array_equal(flip[0].numpy(),
                                  np.asarray(jf).view(np.int32))


class _GivenStuck(FaultModel):
    """Replays JAX's stuck-at defect maps (bool planes or word planes)."""

    def __init__(self, sa0, sa1):
        self.sa0, self.sa1 = sa0, sa1

    def corrupt_bits(self, bits, generator, dt=1.0):
        return StuckAtFaults.stick_bits(bits, self.sa0, self.sa1)

    def word_mask(self, generator, words, dt=1.0):
        return StuckAtFaults.stuck_word_mask(words, self.sa0, self.sa1)


class _GivenFlips(FaultModel):
    """Replays JAX's transient flip plane."""

    def __init__(self, flips):
        self.flips = flips

    def corrupt_bits(self, bits, generator, dt=1.0):
        return bits ^ self.flips

    def word_mask(self, generator, words, dt=1.0):
        return pack_flip_mask(self.flips)


@pytest.mark.parametrize("surface", ["bits", "words"])
def test_composite_matches_jax_given_members_masks(surface):
    """Members corrupt in order, each seeing the previous one's output
    (stuck-at after a flip pins the flipped bit back, and vice versa)."""
    stuck, flips = jm.StuckAtFaults(0.05, 0.05), jm.TransientBitFlips(0.1)
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(key, 2)
    if surface == "bits":
        shape = (40, 33)
        x = np.random.default_rng(1).random(shape) < 0.5
    else:
        x = _words(300, 2)
        shape = x.shape + (32,)
    sa0, sa1 = (torch.from_numpy(np.asarray(m).copy())
                for m in stuck.stuck_masks(k1, shape))
    fl = torch.from_numpy(np.asarray(flips.bit_flips(k2, shape)).copy())
    port = CompositeFault((_GivenStuck(sa0, sa1), _GivenFlips(fl)))
    jcomp = jm.CompositeFault((stuck, flips))
    if surface == "bits":
        got = port.corrupt_bits(torch.from_numpy(x), None)
        want = np.asarray(jcomp.corrupt_bits(jnp.asarray(x), key))
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        w = _i32(x)
        got = port.corrupt_words(w, None)
        want = np.asarray(jcomp.corrupt_words(jnp.asarray(x), key))
        np.testing.assert_array_equal(got.numpy(), want.view(np.int32))
        np.testing.assert_array_equal(
            port.word_mask(None, w).numpy(),
            np.asarray(jcomp.word_mask(key, jnp.asarray(x))).view(np.int32))


def test_permanent_flags_match_jax():
    pairs = [(StuckAtFaults(1e-3, 1e-3), jm.StuckAtFaults(1e-3, 1e-3)),
             (RetentionDrift(1e-3), jm.RetentionDrift(1e-3)),
             (TransientBitFlips(1e-3), jm.TransientBitFlips(1e-3)),
             (CompositeFault(), jm.CompositeFault()),
             (CompositeFault((StuckAtFaults(1e-3),)),
              jm.CompositeFault((jm.StuckAtFaults(1e-3),))),
             (CompositeFault((StuckAtFaults(1e-3), RetentionDrift(1e-3))),
              jm.CompositeFault((jm.StuckAtFaults(1e-3),
                                 jm.RetentionDrift(1e-3))))]
    for port, ref in pairs:
        assert port.permanent == ref.permanent, port


@pytest.mark.parametrize("p,dt", [(1e-3, 1.0), (1e-3, 8.0), (0.3, 2.5),
                                  (1.0, 3.0), (0.0, 4.0)])
def test_drift_interval_probability_matches_jax(p, dt):
    assert RetentionDrift(p)._rate(dt) == jm._p_interval(p, dt)
    assert _p_interval(p, dt) == jm._p_interval(p, dt)


# -- the port's own sparse samplers: counts over many seeds -------------------

def _popcount(a: np.ndarray) -> int:
    """Set bits over an unsigned integer array."""
    return int(np.unpackbits(np.ascontiguousarray(a).view(np.uint8)).sum())


def _lanes(m: torch.Tensor, n_gates: int, trials: int) -> np.ndarray:
    """(n_gates, trials) bools of packed lane masks, lane 32 w + s at bit
    s of word w."""
    bits = np.unpackbits(m.numpy().view(np.uint8), bitorder="little")
    return bits.reshape(n_gates, -1)[:, :trials].astype(bool)


@pytest.mark.parametrize("p0,p1", [(1e-3, 2e-3), (4e-3, 0.0), (0.0, 3e-3)])
def test_stuck_masks_counts_inside_binomial_interval(p0, p1):
    n = 1 << 21

    def draw(seed):
        sa0, sa1 = (m.numpy() for m in StuckAtFaults(p0, p1).stuck_masks(
            torch.Generator().manual_seed(seed), (n // 64, 64)))
        assert not (sa0 & sa1).any()
        return int(sa0.sum()), int(sa1.sum())
    c = counts_over_seeds(draw)
    fits_binomial(c[:, 0], n, p0)
    fits_binomial(c[:, 1], n, p1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stuck_leaf_errors_inside_binomial_interval(dtype):
    """A defect makes an error only where the stored bit differs from its
    stuck value: errors ~ Binomial(ones, p0) + Binomial(zeros, p1)."""
    p0, p1 = 2e-3, 1e-3
    x0 = torch.randn(1 << 17, generator=torch.Generator().manual_seed(0)
                     ).to(dtype)
    ibits, ubits = ((torch.int16, np.uint16) if dtype == torch.bfloat16
                    else (torch.int32, np.uint32))
    before = x0.view(ibits).numpy().view(ubits)
    ones = _popcount(before)
    zeros = before.size * before.itemsize * 8 - ones

    def draw(seed):
        x = x0.clone()
        StuckAtFaults(p0, p1).corrupt_leaf_(
            x, torch.Generator().manual_seed(seed))
        after = x.view(ibits).numpy().view(ubits)
        return _popcount(before & ~after), _popcount(~before & after)
    c = counts_over_seeds(draw)
    fits_binomial(c[:, 0], ones, p0)                # ones stuck at 0
    fits_binomial(c[:, 1], zeros, p1)               # zeros stuck at 1


def test_stuck_words_and_lane_masks_inside_binomial_interval():
    p0, p1 = 3e-3, 1e-3
    w = _i32(_words(1 << 16, 4))
    wb = w.numpy().view(np.uint32)
    ones = _popcount(wb)
    zeros = wb.size * 32 - ones

    def words(seed):
        mask = StuckAtFaults(p0, p1).word_mask(
            torch.Generator().manual_seed(seed), w)
        flipped = ((w ^ mask) ^ w).numpy().view(np.uint32)
        return _popcount(wb & flipped), _popcount(~wb & flipped)
    c = counts_over_seeds(words)
    fits_binomial(c[:, 0], ones, p0)                # ones stuck at 0
    fits_binomial(c[:, 1], zeros, p1)               # zeros stuck at 1

    n_gates, trials = 300, 1000
    tw = -(-trials // PACK)

    def gates(seed):
        keep, flip = StuckAtFaults(p0, p1).gate_lane_masks(
            torch.Generator().manual_seed(seed), n_gates, trials)
        assert keep.shape == flip.shape == (n_gates, tw)
        stuck = ~_lanes(keep, n_gates, trials)
        one = _lanes(flip, n_gates, trials)
        assert not (one & ~stuck).any()             # sa1 lanes are stuck
        return int((stuck & ~one).sum()), int(one.sum())
    c = counts_over_seeds(gates)
    fits_binomial(c[:, 0], n_gates * trials, p0)
    fits_binomial(c[:, 1], n_gates * trials, p1)


@pytest.mark.parametrize("dt", [1.0, 8.0])
def test_drift_flips_inside_binomial_interval(dt):
    p = 1e-4
    n = 1 << 22
    rate = _p_interval(p, dt)

    def leaf(seed):
        x = torch.zeros(n // 32, dtype=torch.float32)
        RetentionDrift(p).corrupt_leaf_(
            x, torch.Generator().manual_seed(seed), dt)
        return _popcount(x.view(torch.int32).numpy())
    fits_binomial(counts_over_seeds(leaf), n, rate)

    def plane(seed):
        return int(RetentionDrift(p).bit_flips(
            torch.Generator().manual_seed(seed), (n // 64, 64), dt)
            .numpy().sum())
    fits_binomial(counts_over_seeds(plane), n, rate)


def test_composite_sampler_applies_members_in_order():
    """Drift then stuck-at: every stuck cell ends at its stuck value, and
    the composite's draws are the members' draws in order from one
    generator."""
    model = CompositeFault((RetentionDrift(0.05), StuckAtFaults(0.02, 0.02)))
    w = _i32(_words(4096, 6))
    got = model.corrupt_words(w, torch.Generator().manual_seed(8))
    g = torch.Generator().manual_seed(8)
    step = w ^ RetentionDrift(0.05).word_mask(g, w)
    want = StuckAtFaults(0.02, 0.02).corrupt_words(step, g)
    assert torch.equal(got, want)
    assert model.permanent is False


# -- permanence ----------------------------------------------------------------

def test_stuck_at_is_permanent_and_idempotent_under_reseeding():
    model = StuckAtFaults(1e-3, 2e-3)
    assert model.permanent
    w = _i32(_words(1 << 14, 7))
    once = model.corrupt_words(w, torch.Generator().manual_seed(12))
    twice = model.corrupt_words(once, torch.Generator().manual_seed(12))
    assert not torch.equal(once, w)
    assert torch.equal(once, twice)
    x = torch.randn(5000, generator=torch.Generator().manual_seed(1))
    tree = {"a": x.clone(), "b": torch.randn(300).to(torch.bfloat16)}
    model.corrupt(tree, torch.Generator().manual_seed(13))
    snap = {k: v.clone() for k, v in tree.items()}
    model.corrupt(tree, torch.Generator().manual_seed(13))
    for k in tree:
        assert torch.equal(tree[k].view(torch.uint8),
                           snap[k].view(torch.uint8)), k
    bits = torch.rand(64, 64, generator=torch.Generator().manual_seed(2)) \
        < 0.5
    b1 = model.corrupt_bits(bits, torch.Generator().manual_seed(3))
    assert torch.equal(b1, model.corrupt_bits(
        b1, torch.Generator().manual_seed(3)))


def test_stuck_samplers_agree_on_one_generator_state():
    """stuck_masks, corrupt_words and gate_lane_masks draw the same defect
    positions and kinds from the same seed."""
    model = StuckAtFaults(0.01, 0.01)
    w = _i32(_words(200, 3))
    sa0, sa1 = model.stuck_masks(torch.Generator().manual_seed(4),
                                 (200, 32))
    assert torch.equal(model.word_mask(torch.Generator().manual_seed(4), w),
                       StuckAtFaults.stuck_word_mask(w, sa0, sa1))
    sa0, sa1 = model.stuck_masks(torch.Generator().manual_seed(5), (7, 90))
    k, f = model.gate_lane_masks(torch.Generator().manual_seed(5), 7, 90)
    k2, f2 = StuckAtFaults.lane_masks_from(sa0, sa1)
    assert torch.equal(k, k2) and torch.equal(f, f2)


# -- the engine under --fault stuckat / drift, given JAX's masks ---------------

class JaxMasks(FaultModel):
    """Hands the port the word masks JAX drew, in corruption order."""

    def __init__(self, masks):
        self.masks = list(masks)

    def word_mask(self, generator, words, dt=1.0):
        m = self.masks.pop(0)
        assert m.shape == tuple(words.shape)
        return torch.from_numpy(m.view(np.int32).copy())


@pytest.fixture(scope="module")
def engine_setup():
    cfg = get_config("phi3-mini-3.8b").smoke().replace(
        n_layers=2, compute_dtype="float32")
    key = jax.random.PRNGKey(0)
    jparams = JP.materialize(key, JT.model_specs(cfg))
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab, size=(2, 8)).astype(np.int32)
    return cfg, key, jparams, jax.tree.map(np.asarray, jparams), tokens


FAULTS = [("stuckat", jm.StuckAtFaults(1e-6, 1e-6)),
          ("drift", jm.RetentionDrift(2e-6))]


@pytest.mark.parametrize("spec", ["ecc", "ecc+tmr-parallel"])
@pytest.mark.parametrize("name,fault", FAULTS, ids=[f for f, _ in FAULTS])
def test_engine_prepare_matches_jax_under_fault(engine_setup, name, fault,
                                                spec):
    from repro_torch.configs import get_config as port_config
    cfg_j, key, jparams, params_np, tokens = engine_setup
    cfg = port_config("phi3-mini-3.8b").smoke().replace(
        n_layers=2, compute_dtype="float32")
    copies = 3 if "tmr" in spec else 1
    jeng = JEngine(cfg_j, j_parse(spec), gen=4)
    jstore, jprep = jeng.prepare(jparams, key=key, fault=fault)
    jtok, jtel = jeng.generate(jstore, {"tokens": jnp.asarray(tokens)})
    jstats = j_fetch({**jprep, **jtel})
    leaves = jax.tree.leaves(jparams)
    masks = []
    for i in range(copies):
        ks = jax.random.split(jax.random.fold_in(key, 100 + i), len(leaves))
        masks += [np.asarray(fault.word_mask(k, jarena.leaf_to_words(x)))
                  for k, x in zip(ks, leaves)]
    assert any(m.any() for m in masks)
    eng = GenerationEngine(cfg, parse_scheme(spec), gen=4, device="cpu")
    given = JaxMasks(masks)
    store, prep = eng.prepare(from_numpy(params_np), fault=given)
    assert not given.masks
    tok, tel = eng.generate(store, {"tokens": torch.from_numpy(tokens)})
    stats = fetch_telemetry({**prep, **tel})
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert sorted(stats) == sorted(jstats)
    for k in stats:
        np.testing.assert_array_equal(stats[k], np.asarray(jstats[k]),
                                      err_msg=k)
    assert int(stats["ecc_corrected"]) > 0
    words, _ = arena.words_of(store, copies=3 if copies == 3 else 0)
    jw = [np.asarray(jarena.pack(jax.tree.map(lambda x, i=i: x[i], jstore)
                                 if copies == 3 else jstore)[0])
          for i in range(copies)]
    for i in range(copies):
        w = words[i] if copies == 3 else words
        np.testing.assert_array_equal(w.numpy(), jw[i].view(np.int32))
