"""The port's Min3 netlists, gate primitives and gate-fault sampler
(repro_torch.core.{netlist, stateful_logic}, repro_torch.faults) against
the JAX package: the builder's arrays bit for bit (MultPIM multipliers with
and without CSE, random netlists), the gate-serial executor's outputs on
the same numpy inputs, fault-free and with single-fault planes; the gates'
truth tables; and the sparse gate sampler held to its distribution (it has
the reference's distribution, not its threefry bits)."""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import multpim as TM
from repro_torch.core import netlist as TN
from repro_torch.core import stateful_logic as TL
from repro_torch.faults import TransientGateFaults

try:    # without JAX (as on a GPU machine) only the card's cases run
    import jax.numpy as jnp
    from repro.core import multpim as JM
    from repro.core import netlist as JN
    from repro.core import stateful_logic as JL
except ImportError:
    jnp = None


def _random_netlist(mod, seed: int):
    """The reference tests' random netlist, built by either package's
    builder from the same numpy stream."""
    rng = np.random.default_rng(seed)
    bld = mod.NetlistBuilder(cse=bool(rng.integers(2)))
    wires = list(bld.input_bits(int(rng.integers(2, 6)))) + [bld.ZERO,
                                                             bld.ONE]
    ops = [bld.not_, bld.nor, bld.nand, bld.and_, bld.or_, bld.xor,
           bld.min3, bld.maj3]
    arity = [1, 2, 2, 2, 2, 2, 3, 3]
    for _ in range(int(rng.integers(5, 60))):
        i = int(rng.integers(len(ops)))
        args = [wires[rng.integers(len(wires))] for _ in range(arity[i])]
        wires.append(ops[i](*args))
    bld.mark_outputs([wires[rng.integers(len(wires))]
                      for _ in range(int(rng.integers(1, 8)))])
    return bld.build()


def _same_netlist(a, b):
    assert a.n_wires == b.n_wires and a.n_gates == b.n_gates
    for k in ("inputs", "outputs", "gates"):
        got, want = getattr(a, k), getattr(b, k)
        assert got.dtype == want.dtype == np.int32, k
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("cse", [True, False])
@pytest.mark.parametrize("nb", [4, 8, 16, 32])
def test_multiplier_netlist_matches_jax(nb, cse):
    _same_netlist(TM.multiplier_netlist(nb, cse),
                  JM.multiplier_netlist(nb, cse))


GOLDEN = {8: 760, 16: 3312, 32: 13792}


@pytest.mark.parametrize("nb", sorted(GOLDEN))
def test_multiplier_gate_counts(nb):
    assert TM.multiplier_netlist(nb).n_gates == GOLDEN[nb]
    assert TM.multiplier_netlist(nb, cse=False).n_gates == GOLDEN[nb]


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234, 99991])
def test_random_netlist_matches_jax(seed):
    _same_netlist(_random_netlist(TN, seed), _random_netlist(JN, seed))


def test_builder_folding_and_cse():
    b = TN.NetlistBuilder()
    x, y = b.input_bits(2)
    assert b.min3(b.ZERO, b.ONE, b.ONE) == b.ZERO   # const folded, no gate
    assert b.and_(x, b.ZERO) == b.ZERO
    assert b.or_(x, b.ONE) == b.ONE
    assert b.xor(x, x) == b.ZERO
    n = len(b._gates)
    b.xor(x, b.ZERO)
    assert len(b._gates) == n                      # xor with 0 is free
    w = b.xor(x, y)
    n = len(b._gates)
    assert b.xor(x, y) == w and len(b._gates) == n  # CSE hit
    assert b.min3(y, x, b.ONE) == b.nor(x, y)       # commutative match
    raw = TN.NetlistBuilder(cse=False)
    x, y = raw.input_bits(2)
    raw.xor(x, y)
    n = len(raw._gates)
    raw.xor(x, y)
    assert len(raw._gates) == 2 * n


def _bits(rng, shape):
    return rng.integers(0, 2, shape).astype(bool)


@pytest.mark.parametrize("nb,trials", [(4, 3), (4, 32), (8, 70), (8, 130)])
def test_execute_matches_jax_scan(nb, trials):
    nl = TM.multiplier_netlist(nb)
    rng = np.random.default_rng(trials)
    inputs = _bits(rng, (trials, len(nl.inputs)))
    fg = rng.integers(-1, nl.n_gates, trials).astype(np.int32)
    jnl = JM.multiplier_netlist(nb)
    for kw, jkw in ((dict(), dict()),
                    (dict(fault_gate=torch.from_numpy(fg)),
                     dict(fault_gate=jnp.asarray(fg)))):
        got = TN.execute(nl, torch.from_numpy(inputs), **kw)
        want = np.asarray(JN.execute(jnl, jnp.asarray(inputs), **jkw))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [3, 11, 2024])
def test_execute_random_netlist_matches_jax(seed):
    nl, jnl = _random_netlist(TN, seed), _random_netlist(JN, seed)
    rng = np.random.default_rng(seed + 1)
    trials = int(rng.integers(1, 80))
    inputs = _bits(rng, (trials, len(nl.inputs)))
    fg = rng.integers(-1, max(nl.n_gates, 1), trials).astype(np.int32)
    got = TN.execute(nl, torch.from_numpy(inputs),
                     fault_gate=torch.from_numpy(fg))
    want = JN.execute(jnl, jnp.asarray(inputs), fault_gate=jnp.asarray(fg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_execute_iid_is_the_drawn_gate_plane():
    """The gate-serial executor corrupts exactly the (gate, trial) pairs
    of one `gate_lane_masks` draw: replaying the draw by hand on the
    fault-free wire values gives the same outputs, and a float p_gate and
    its TransientGateFaults draw the same stream."""
    nl = TM.multiplier_netlist(4)
    rng = np.random.default_rng(2)
    inputs = torch.from_numpy(_bits(rng, (45, len(nl.inputs))))
    got = TN.execute(nl, inputs, torch.Generator().manual_seed(5), 0.05)
    same = TN.execute(nl, inputs, torch.Generator().manual_seed(5),
                      TransientGateFaults(0.05))
    assert torch.equal(got, same)
    _, flip = TransientGateFaults(0.05).gate_lane_masks(
        torch.Generator().manual_seed(5), nl.n_gates, 45)
    from repro_torch.core.bitops import unpack_trials
    fb = unpack_trials(flip.T, 45).numpy()
    state = np.zeros((45, nl.n_wires), bool)
    state[:, 1] = True
    state[:, nl.inputs] = inputs.numpy()
    for g, (i1, i2, i3, o) in enumerate(nl.gates):
        a, b, c = state[:, i1], state[:, i2], state[:, i3]
        state[:, o] = ~((a & b) | (b & c) | (a & c)) ^ fb[:, g]
    np.testing.assert_array_equal(got.numpy(), state[:, nl.outputs])
    assert fb.any()


GATES = {"not": 1, "nor": 2, "or": 2, "nand": 2, "and": 2, "min3": 3,
         "maj3": 3, "xor": 2}


@pytest.mark.parametrize("name", sorted(GATES))
def test_gates_truth_tables_match_jax(name):
    n = GATES[name]
    combos = np.array(np.meshgrid(*[[False, True]] * n)).reshape(n, -1)
    got = getattr(TL, f"g_{name}")(*map(torch.from_numpy, combos))
    want = ({"not": lambda a: ~a, "nor": lambda a, b: ~(a | b),
             "or": lambda a, b: a | b, "nand": lambda a, b: ~(a & b),
             "and": lambda a, b: a & b,
             "min3": lambda a, b, c: ~((a & b) | (b & c) | (a & c)),
             "maj3": lambda a, b, c: (a & b) | (b & c) | (a & c),
             "xor": lambda a, b: a ^ b}[name])(*combos)
    np.testing.assert_array_equal(got.numpy(), want)
    if jnp is not None:
        j = getattr(JL, f"g_{name}")(*map(jnp.asarray, combos))
        np.testing.assert_array_equal(got.numpy(), np.asarray(j))
    # with a generator at p = 0 nothing flips; at p = 1 every cycle flips
    g = torch.Generator().manual_seed(0)
    args = list(map(torch.from_numpy, combos))
    np.testing.assert_array_equal(
        getattr(TL, f"g_{name}")(*args, g, 0.0).numpy(), want)
    cycles = TL.GATE_COSTS[name]
    flipped = getattr(TL, f"g_{name}")(*args, g, 1.0).numpy()
    if name != "xor":      # xor's five flips feed each other
        np.testing.assert_array_equal(flipped, want ^ bool(cycles % 2))


def test_cycle_counter():
    c = TL.CycleCounter()
    c.tick(8)
    c.tick(4, cycles=2)
    assert (c.cycles, c.gate_evals) == (3, 16)
    assert (c + c).cycles == 6


@pytest.mark.parametrize("trials", [64, 70])
@pytest.mark.parametrize("p", [1e-3, 2e-2])
def test_gate_sampler_rate_within_binomial_bounds(p, trials):
    """One Binomial(G * trials, p) count of distinct (gate, trial) pairs:
    over 20 draws the mean count lies within 5 standard errors of
    G * trials * p, each count equals the set bits, no padding lane is
    hit, and keep is all ones."""
    G = 300
    g = torch.Generator().manual_seed(int(p * 1e5) + trials)
    counts = []
    for _ in range(20):
        keep, flip = TransientGateFaults(p).gate_lane_masks(g, G, trials)
        assert flip.shape == keep.shape == (G, -(-trials // 32))
        assert flip.dtype == keep.dtype == torch.int32
        assert bool((keep == -1).all())
        bits = np.unpackbits(flip.contiguous().numpy().view(np.uint8),
                             bitorder="little").reshape(G, -1)
        assert not bits[:, trials:].any()            # padding lanes
        counts.append(int(bits.sum()))
    n = G * trials
    mean, sd = n * p, math.sqrt(n * p * (1 - p))
    assert abs(np.mean(counts) - mean) < 5 * sd / math.sqrt(20)


def test_bit_flips_rate_and_corrupt_bits():
    g = torch.Generator().manual_seed(9)
    plane = TransientGateFaults(0.01).bit_flips(g, (512, 64))
    assert plane.shape == (512, 64) and plane.dtype == torch.bool
    n = plane.numel()
    assert abs(int(plane.sum()) - 0.01 * n) < 5 * math.sqrt(0.01 * n)
    x = torch.zeros((512, 64), dtype=torch.bool)
    g1, g2 = (torch.Generator().manual_seed(4) for _ in range(2))
    assert torch.equal(TransientGateFaults(0.01).corrupt_bits(x, g1),
                       TL.maybe_flip(x, g2, 0.01))
