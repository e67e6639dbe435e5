"""The port's levelizer, trial packing and levelized executor
(repro_torch.core.{bitops, scheduler}) against the JAX package: every
`Schedule` field array for array (MultPIM multipliers, random netlists,
width overrides), `pack_trials`/`unpack_trials` and `to_bits`/`from_bits`
bit for bit, the packed initial state and the single-fault masks, and the
final packed state under JAX's own fault masks (TransientGateFaults, and
StuckAtFaults, whose keep is not all ones) through the port's
level-by-level plain version, and the same state with TransientGateFaults'
all-ones keep dropped."""
import numpy as np
import pytest
import torch

from repro_torch.core import bitops as TB
from repro_torch.core import multpim as TM
from repro_torch.core import netlist as TN
from repro_torch.core import scheduler as TS
from repro_torch.kernels.netlist_exec import netlist_exec

try:    # without JAX (as on a GPU machine) only the card's cases run
    import jax
    import jax.numpy as jnp
    from repro.core import bitops as JB
    from repro.core import multpim as JM
    from repro.core import netlist as JN
    from repro.core import scheduler as JS
    from repro.faults import StuckAtFaults, TransientGateFaults
    from repro.kernels.netlist_exec.kernel import netlist_exec_kernel
except ImportError:
    jnp = None

from test_torch_netlist import _random_netlist

FIELDS = ("sched", "sched_gid", "widths", "remap", "rows_in")


def _same_schedule(a, b):
    assert (a.n_wires, a.n_gates, a.depth, a.base, a.n_levels, a.max_width,
            a.n_rows) == (b.n_wires, b.n_gates, b.depth, b.base, b.n_levels,
                          b.max_width, b.n_rows)
    for k in FIELDS:
        got, want = getattr(a, k), getattr(b, k)
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for cap in (1, 7, 64):
        np.testing.assert_array_equal(a.issue_counts(cap),
                                      b.issue_counts(cap))


@pytest.mark.parametrize("nb", [4, 8, 16, 32])
def test_multiplier_schedule_matches_jax(nb):
    sch = TS.schedule(TM.multiplier_netlist(nb))
    _same_schedule(sch, JS.schedule(JM.multiplier_netlist(nb)))
    assert TS.schedule(TM.multiplier_netlist(nb)) is sch        # cached


def test_32bit_schedule_shape():
    sch = TS.schedule(TM.multiplier_netlist(32))
    assert (sch.n_gates, sch.depth, sch.n_levels, sch.max_width, sch.base,
            sch.n_rows) == (13792, 306, 320, 128, 66, 41026)


@pytest.mark.parametrize("max_width", [1, 7, 32, 100])
@pytest.mark.parametrize("nb", [4, 8])
def test_width_override_matches_jax(nb, max_width):
    _same_schedule(TS.levelize(TM.multiplier_netlist(nb), max_width),
                   JS.levelize(JM.multiplier_netlist(nb), max_width))


@pytest.mark.parametrize("seed", [0, 5, 17, 123, 4096, 65537])
def test_random_netlist_schedule_matches_jax(seed):
    _same_schedule(TS.levelize(_random_netlist(TN, seed)),
                   JS.levelize(_random_netlist(JN, seed)))


def test_issue_counts_rejects_zero_cap():
    with pytest.raises(ValueError):
        TS.schedule(TM.multiplier_netlist(4)).issue_counts(0)


def test_empty_netlist():
    bld = TN.NetlistBuilder()
    (x,) = bld.input_bits(1)
    bld.mark_outputs([x, bld.ZERO, bld.ONE])
    nl = bld.build()
    sch = TS.schedule(nl)
    assert sch.n_levels == 0 and sch.n_gates == 0
    inputs = torch.tensor([[True], [False], [True]])
    got = TS.execute_levelized(nl, inputs)
    np.testing.assert_array_equal(got.numpy(),
                                  TN.execute(nl, inputs).numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JS.execute_levelized(nl, jnp.asarray(
            inputs.numpy()))))


@pytest.mark.parametrize("trials,cols", [(1, 1), (31, 3), (32, 2), (70, 5)])
def test_pack_trials_matches_jax(trials, cols):
    bits = np.random.default_rng(trials).integers(0, 2, (trials, cols)) \
        .astype(bool)
    words = TB.pack_trials(torch.from_numpy(bits))
    want = np.asarray(JB.pack_trials(jnp.asarray(bits)))
    assert words.dtype == torch.int32 and words.shape == want.shape
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(TB.unpack_trials(words, trials).numpy(),
                                  bits)
    np.testing.assert_array_equal(
        TB.unpack_trials(words, trials).numpy(),
        np.asarray(JB.unpack_trials(jnp.asarray(want), trials)))


@pytest.mark.parametrize("width", [1, 8, 16, 31, 32])
def test_to_from_bits_match_jax(width):
    rng = np.random.default_rng(width)
    x = rng.integers(0, 2**width, 257, dtype=np.uint64).astype(np.uint32)
    x[:2] = (0, 2**width - 1)
    bits = TB.to_bits(torch.from_numpy(x.view(np.int32)), width)
    want = np.asarray(JB.to_bits(jnp.asarray(x), width))
    np.testing.assert_array_equal(bits.numpy(), want)
    back = TB.from_bits(bits)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy().view(np.uint32),
                                  np.asarray(JB.from_bits(jnp.asarray(want))))


def test_to_from_bits_64():
    x = np.array([0, 1, 2**40 + 3, 2**63 - 1], np.int64)
    bits = TB.to_bits(torch.from_numpy(x), 64)
    want = ((x.astype(np.uint64)[:, None] >> np.arange(64, dtype=np.uint64))
            & 1).astype(bool)
    np.testing.assert_array_equal(bits.numpy(), want)
    np.testing.assert_array_equal(TB.from_bits(bits).numpy(), x)


def _inputs(nl, trials, seed):
    return np.random.default_rng(seed).integers(
        0, 2, (trials, len(nl.inputs))).astype(bool)


@pytest.mark.parametrize("nb,trials", [(4, 33), (8, 300)])
def test_packed_initial_state_and_single_fault_masks_match_jax(nb, trials):
    nl = TM.multiplier_netlist(nb)
    sch, jsch = TS.schedule(nl), JS.schedule(JM.multiplier_netlist(nb))
    x = _inputs(nl, trials, nb)
    st = TS.packed_initial_state(sch, torch.from_numpy(x))
    jst = np.asarray(JS.packed_initial_state(jsch, jnp.asarray(x)))
    np.testing.assert_array_equal(st.numpy().view(np.uint32), jst)
    fg = np.random.default_rng(1).integers(-1, nl.n_gates, trials) \
        .astype(np.int32)
    keep, flip = TS.schedule_fault_masks(sch, trials,
                                         fault_gate=torch.from_numpy(fg))
    jkeep, jflip = JS.schedule_fault_masks(jsch, trials,
                                           fault_gate=jnp.asarray(fg))
    assert keep is None and jkeep is None
    np.testing.assert_array_equal(flip.numpy().view(np.uint32),
                                  np.asarray(jflip))
    assert TS.schedule_fault_masks(sch, trials) is None


def _jax_masks(case, jsch, trials, fg):
    key = jax.random.PRNGKey(7)
    if case == "gate":
        return JS.schedule_fault_masks(jsch, trials, key,
                                       TransientGateFaults(0.04))
    if case == "stuckat":
        return JS.schedule_fault_masks(jsch, trials, key,
                                       StuckAtFaults(0.05, 0.03))
    return JS.schedule_fault_masks(jsch, trials, key, 0.04,
                                   jnp.asarray(fg))


@pytest.mark.parametrize("case", ["gate", "stuckat", "gate+single"])
@pytest.mark.parametrize("nb,trials", [(4, 45), (8, 200)])
def test_final_state_under_jax_masks_matches_jax(case, nb, trials):
    """JAX's own schedule-ordered masks fed to the port's plain version
    (and to the kernel wrapper, which takes it on a CPU tensor) give JAX's
    final packed state bit for bit, rows 0..base included."""
    nl = TM.multiplier_netlist(nb)
    jsch = JS.schedule(JM.multiplier_netlist(nb))
    x = _inputs(nl, trials, trials)
    fg = np.random.default_rng(2).integers(-1, nl.n_gates, trials) \
        .astype(np.int32)
    jkeep, jflip = _jax_masks(case, jsch, trials, fg)
    if case == "stuckat":
        assert not bool((np.asarray(jkeep) == 0xFFFFFFFF).all())
    jstate = JS.packed_initial_state(jsch, jnp.asarray(x))
    want = np.asarray(netlist_exec_kernel(
        jnp.asarray(jsch.rows_in), jstate, jkeep, jflip, base=jsch.base,
        tile_tw=jstate.shape[1], interpret=True))

    def t(a):
        return torch.from_numpy(np.asarray(a).view(np.int32).copy())

    rows = torch.from_numpy(jsch.rows_in)
    got = TS.run_levels(rows, t(jstate), t(jkeep), t(jflip), base=jsch.base)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    got = netlist_exec(rows, t(jstate), t(jkeep), t(jflip), base=jsch.base)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    if case != "gate+single":
        return
    # the flip-only (pure XOR) mode
    want = np.asarray(netlist_exec_kernel(
        jnp.asarray(jsch.rows_in), jstate, None, jflip, base=jsch.base,
        tile_tw=jstate.shape[1], interpret=True))
    got = TS.run_levels(rows, t(jstate), None, t(jflip), base=jsch.base)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("case", ["gate", "gate+single"])
@pytest.mark.parametrize("nb,trials", [(4, 45), (8, 200)])
def test_all_ones_keep_dropped_with_the_same_final_state(case, nb, trials):
    """TransientGateFaults' keep is an all-ones broadcast, so the port's
    masks drop it (pure XOR): under JAX's masks, whose keep is an all-ones
    plane, the final state without keep equals the one with it and JAX's,
    in the plain version and through the op."""
    nl = TM.multiplier_netlist(nb)
    sch = TS.schedule(nl)
    fg = np.random.default_rng(3).integers(-1, nl.n_gates, trials) \
        .astype(np.int32)
    kw = dict(fault_gate=torch.from_numpy(fg)) if case == "gate+single" \
        else {}
    keep, flip = TS.schedule_fault_masks(
        sch, trials, torch.Generator().manual_seed(9), 0.04, **kw)
    assert keep is None and flip.shape == (sch.n_levels, sch.max_width,
                                           -(-trials // 32))
    jsch = JS.schedule(JM.multiplier_netlist(nb))
    jkeep, jflip = _jax_masks(case, jsch, trials, fg)
    assert bool((np.asarray(jkeep) == 0xFFFFFFFF).all())
    x = _inputs(nl, trials, trials + 1)
    jstate = JS.packed_initial_state(jsch, jnp.asarray(x))
    want = np.asarray(netlist_exec_kernel(
        jnp.asarray(jsch.rows_in), jstate, jkeep, jflip, base=jsch.base,
        tile_tw=jstate.shape[1], interpret=True))

    def t(a):
        return torch.from_numpy(np.asarray(a).view(np.int32).copy())

    rows = torch.from_numpy(jsch.rows_in)
    for run in (TS.run_levels, netlist_exec):
        with_keep = run(rows, t(jstate), t(jkeep), t(jflip), base=jsch.base)
        without = run(rows, t(jstate), None, t(jflip), base=jsch.base)
        np.testing.assert_array_equal(without.numpy(), with_keep.numpy())
        np.testing.assert_array_equal(without.numpy().view(np.uint32), want)


def test_only_an_all_ones_broadcast_keep_is_dropped():
    ones = torch.full((1, 1), -1, dtype=torch.int32)
    assert TS._all_ones_broadcast(ones.expand(5, 3))
    assert not TS._all_ones_broadcast(torch.full((5, 3), -1,
                                                 dtype=torch.int32))
    assert not TS._all_ones_broadcast(torch.full((1, 1), -2, dtype=torch.int32)
                                      .expand(5, 3))
    assert not TS._all_ones_broadcast(ones.expand(0, 3))


@pytest.mark.parametrize("nb,trials", [(4, 33), (8, 300)])
def test_levelized_matches_jax_fault_free_and_single(nb, trials):
    nl = TM.multiplier_netlist(nb)
    jnl = JM.multiplier_netlist(nb)
    x = _inputs(nl, trials, 3)
    fg = np.random.default_rng(4).integers(-1, nl.n_gates, trials) \
        .astype(np.int32)
    for kw, jkw in ((dict(), dict()),
                    (dict(fault_gate=torch.from_numpy(fg)),
                     dict(fault_gate=jnp.asarray(fg)))):
        got = TS.execute_levelized(nl, torch.from_numpy(x), **kw)
        want = JS.execute_levelized(jnl, jnp.asarray(x), **jkw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [1, 8, 77])
def test_levelized_replays_scan_with_generator_faults(seed):
    """For one generator state the levelized engine corrupts the same
    (gate, trial) pairs as the gate-serial one, with and without a
    single-fault plane, on random netlists."""
    nl = _random_netlist(TN, seed)
    rng = np.random.default_rng(seed + 1)
    trials = int(rng.integers(1, 80))
    x = torch.from_numpy(_inputs(nl, trials, seed))
    fg = torch.from_numpy(rng.integers(-1, max(nl.n_gates, 1), trials)
                          .astype(np.int32))
    for kw in (dict(p_gate=0.1), dict(p_gate=0.1, fault_gate=fg),
               dict(fault_gate=fg)):
        a = TN.execute(nl, x, torch.Generator().manual_seed(seed), **kw)
        b = TS.execute_levelized(nl, x, torch.Generator().manual_seed(seed),
                                 **kw)
        assert torch.equal(a, b), kw


def test_max_width_override_bit_exact():
    nl = TM.multiplier_netlist(8)
    x = torch.from_numpy(_inputs(nl, 40, 5))
    want = TN.execute(nl, x)
    for mw in (16, 64):
        assert torch.equal(TS.execute_levelized(nl, x, max_width=mw), want)
