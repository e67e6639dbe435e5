"""The levelized netlist kernel op of the port
(repro_torch.kernels.netlist_exec, whose wrapper takes the plain version
for a CPU tensor) against the JAX package's Pallas `execute_packed` in
interpret mode -- trials that are not a multiple of 32 and padded,
multi-tile grids, fault-free and with single-fault planes -- plus the
wrapper's checks; the kernel's shared-memory plan (slots never shared
while live, every read finding its row, the budget and the tiles); a
numpy emulation of the CUDA kernel over the plan, which reads gate inputs
only from its slots, against the JAX `netlist_exec_kernel` in its three
mask modes; and the CUDA kernel against the plain version on the card
(skipped without one), at edge shapes and every tile width."""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro_torch.core import multpim as TM
from repro_torch.core import netlist as TN
from repro_torch.core import scheduler as TS
from repro_torch.kernels.netlist_exec import (execute_packed,
                                              execute_packed_ref,
                                              netlist_exec, netlist_exec_ref)
from repro_torch.kernels.netlist_exec import plan as P

try:    # without JAX (as on a GPU machine) only the card's cases run
    import jax.numpy as jnp
    from repro.core import multpim as JM
    from repro.kernels.netlist_exec import execute_packed as j_packed
    from repro.kernels.netlist_exec.kernel import netlist_exec_kernel
except ImportError:
    jnp = None

from test_torch_netlist import _random_netlist


@pytest.mark.parametrize("nb,trials,tile_tw", [
    (4, 3, 8),          # single partial lane word
    (4, 64, 1),         # one word per tile, multi-tile grid
    (8, 70, 8),         # padded lanes, single tile
    (8, 300, 4),        # padded lanes AND padded tile, multi-tile grid
])
def test_execute_packed_matches_jax_kernel(nb, trials, tile_tw):
    nl = TM.multiplier_netlist(nb)
    rng = np.random.default_rng(trials)
    x = rng.integers(0, 2, (trials, len(nl.inputs))).astype(bool)
    fg = rng.integers(-1, nl.n_gates, trials).astype(np.int32)
    jnl = JM.multiplier_netlist(nb)
    for kw, jkw in ((dict(), dict()),
                    (dict(fault_gate=torch.from_numpy(fg)),
                     dict(fault_gate=jnp.asarray(fg)))):
        got = execute_packed(nl, torch.from_numpy(x), **kw)
        want = j_packed(jnl, jnp.asarray(x), tile_tw=tile_tw,
                        interpret=True, **jkw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            execute_packed_ref(nl, torch.from_numpy(x), **kw).numpy(),
            np.asarray(want))


@pytest.mark.parametrize("nb,trials", [(4, 33), (8, 300)])
def test_execute_packed_replays_scan_with_generator_faults(nb, trials):
    nl = TM.multiplier_netlist(nb)
    rng = np.random.default_rng(nb + trials)
    x = torch.from_numpy(rng.integers(0, 2, (trials, len(nl.inputs)))
                         .astype(bool))
    fg = torch.from_numpy(rng.integers(-1, nl.n_gates, trials)
                          .astype(np.int32))
    for kw in (dict(p_gate=0.03), dict(p_gate=0.03, fault_gate=fg)):
        want = TN.execute(nl, x, torch.Generator().manual_seed(3), **kw)
        got = execute_packed(nl, x, torch.Generator().manual_seed(3), **kw)
        assert torch.equal(got, want), kw


def _case(nb, trials, seed, dev="cpu"):
    sch = TS.schedule(TM.multiplier_netlist(nb))
    g = torch.Generator().manual_seed(seed)
    tw = -(-trials // 32)
    L, W = sch.n_levels, sch.max_width

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, generator=g,
                             dtype=torch.int64).to(torch.int32).to(dev)

    return (sch, torch.as_tensor(sch.rows_in).to(dev), words(sch.n_rows, tw),
            words(L, W, tw), words(L, W, tw))


def test_wrapper_is_in_place_and_keeps_rows_below_base():
    sch, rows, state, keep, flip = _case(4, 100, 0)
    before = state.clone()
    out = netlist_exec(rows, state, keep, flip, base=sch.base)
    assert out is state
    assert torch.equal(state[:sch.base], before[:sch.base])
    want = netlist_exec_ref(rows, before.clone(), keep, flip, base=sch.base)
    assert torch.equal(state, want)


def test_wrapper_rejects_bad_operands():
    sch, rows, state, keep, flip = _case(4, 64, 1)
    with pytest.raises(ValueError, match="keep needs flip"):
        netlist_exec(rows, state, keep, None, base=sch.base)
    with pytest.raises(ValueError, match="state"):
        netlist_exec(rows, state[:-1], base=sch.base)
    with pytest.raises(ValueError, match="flip"):
        netlist_exec(rows, state, None, flip[:, :, :1].clone(),
                     base=sch.base)
    with pytest.raises(ValueError, match="contiguous int32"):
        netlist_exec(rows.long(), state, base=sch.base)
    bad = rows.clone()
    bad[1, 0, 0] = sch.base + sch.max_width      # level 1's own block
    with pytest.raises(ValueError, match="own output block"):
        netlist_exec(bad, state, base=sch.base)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["none", "xor", "keep+xor"])
@pytest.mark.parametrize("nb,trials", [(4, 3), (8, 300), (16, 5000)])
def test_kernel_matches_plain_on_card(nb, trials, mode):
    dev = _cuda()
    sch, rows, state, keep, flip = _case(nb, trials, nb, dev)
    keep = keep if mode == "keep+xor" else None
    flip = None if mode == "none" else flip
    want = netlist_exec_ref(rows, state.clone(), keep, flip, base=sch.base)
    got = netlist_exec(rows, state, keep, flip, base=sch.base)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_execute_packed_on_card_matches_cpu():
    dev = _cuda()
    nl = TM.multiplier_netlist(8)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 2, (1000, 16)).astype(bool))
    fg = torch.from_numpy(rng.integers(-1, nl.n_gates, 1000)
                          .astype(np.int32))
    got = execute_packed(nl, x.to(dev), fault_gate=fg.to(dev))
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), execute_packed(nl, x, fault_gate=fg))


# ----------------------------------------------------------------------------
# the shared-memory plan of the CUDA kernel (kernels/netlist_exec/plan.py)
# ----------------------------------------------------------------------------

MODES = ("none", "xor", "keep+xor")


def _random_rows(L, W, base, seed):
    """rows_in of L levels of W gates, each input uniform over the rows
    below the level's own block (repeats and padding-like rows included)."""
    rng = np.random.default_rng(seed)
    hi = base + W * np.arange(L).reshape(L, 1, 1)
    rows = (rng.random((L, W, 3)) * hi).astype(np.int32)
    rows[rng.random((L, W)) < 0.2] = 0            # padding-like slots
    return rows


def _schedules():
    yield "mult4", TS.schedule(TM.multiplier_netlist(4)).rows_in, 10
    yield "mult8", TS.schedule(TM.multiplier_netlist(8)).rows_in, 18
    for seed in (0, 5, 17):
        sch = TS.levelize(_random_netlist(TN, seed))
        yield f"netlist{seed}", sch.rows_in, sch.base
    yield "rows", _random_rows(9, 7, 5, 1), 5


def _slot_of_row(p):
    """Row -> slot, from the plan's base slots and output descriptors."""
    out = p.desc[..., 3].astype(np.int64).reshape(-1)
    return np.concatenate([p.base_slot.astype(np.int64),
                           np.where(out == P.NO_SLOT, -1, out)])


def _spans(rows_in, base):
    """(writer level, last reader level) of every row; -1 writer for rows
    below base, -1 reader for rows nobody reads."""
    L, W, _ = rows_in.shape
    last = np.full(base + L * W, -1)
    for l in range(L):
        last[rows_in[l].reshape(-1)] = l
    writer = np.concatenate([np.full(base, -1), np.arange(L * W) // W])
    return writer, last


@pytest.mark.parametrize("name,rows,base", list(_schedules()),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_plan_slots_are_never_shared_while_live(name, rows, base):
    """A slot goes to a new row only after its last read (strictly earlier
    level), every row that is read has a slot, and no other row has one."""
    p = P.build_plan(rows, base)
    slot = _slot_of_row(p)
    writer, last = _spans(rows, base)
    np.testing.assert_array_equal(slot >= 0, last >= 0)
    assert slot.max() + 1 == p.n_slots
    for s in range(p.n_slots):
        owners = np.flatnonzero(slot == s)
        owners = owners[np.argsort(writer[owners], kind="stable")]
        for prev, nxt in zip(owners[:-1], owners[1:]):
            assert last[prev] < writer[nxt], (s, prev, nxt)


@pytest.mark.parametrize("name,rows,base", list(_schedules()),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_plan_reads_find_their_rows(name, rows, base):
    """Each gate's descriptor names the slots of its three inputs, and the
    slot of its output when a later level reads it."""
    p = P.build_plan(rows, base)
    slot = _slot_of_row(p)
    d = p.desc.astype(np.int64)
    np.testing.assert_array_equal(d[..., :3], slot[rows])
    _, last = _spans(rows, base)
    out = last[base:].reshape(p.L, p.W) >= 0
    np.testing.assert_array_equal(d[..., 3] != P.NO_SLOT, out)


def test_plan_tiles_fit_the_budget():
    """The widest tile that fits is taken: 32, 32 and 16 words for the
    32-bit multiplier without masks, with flip, with keep and flip; 8 for
    the 64-bit multiplier; each budget of an exact tile size forces that
    tile; the plan is cached; too small a budget raises."""
    for nb, tiles in ((32, (32, 32, 16)), (64, (8, 8, 8))):
        sch = TS.schedule(TM.multiplier_netlist(nb))
        p = P.plan(sch.rows_in, sch.base)
        assert P.plan(sch.rows_in.copy(), sch.base) is p
        assert tuple(p.tile(m) for m in range(3)) == tiles
        for m in range(3):
            assert p.smem_bytes(p.tile(m), m) <= P.SMEM_BUDGET
            if p.tile(m) < 32:
                assert p.smem_bytes(2 * p.tile(m), m) > P.SMEM_BUDGET
    sch = TS.schedule(TM.multiplier_netlist(8))
    for m in range(3):
        for t in P.TILES:
            budget = P.plan(sch.rows_in, sch.base).smem_bytes(t, m)
            assert P.plan(sch.rows_in, sch.base).tile(m, budget) == t
    with pytest.raises(ValueError, match="live rows"):
        P.plan(sch.rows_in, sch.base).tile(0, 512)


def test_launch_tile_narrows_only_within_one_wave():
    """A small tw takes the narrowest tile whose grid still fits one CTA a
    SM; a grid of a wave or more keeps the plan's tile."""
    assert P.launch_tile(32, 431, 132) == 4          # 108 CTAs, not 216
    assert P.launch_tile(32, 1724, 132) == 16        # 108 CTAs, not 216
    assert P.launch_tile(16, 32768, 132) == 16
    assert P.launch_tile(32, 32 * 132, 132) == 32
    assert P.launch_tile(8, 1, 132) == 1
    assert P.launch_tile(1, 5, 132) == 1


def test_oversized_schedule_raises():
    """60,000 rows of one level all read by the next do not fit even at one
    trial word a CTA; the op refuses them on the card's path only."""
    W = 60000
    rows = np.zeros((2, W, 3), np.int32)
    rows[1] = (2 + np.arange(W))[:, None]
    p = P.build_plan(rows, 2)
    assert p.n_slots == W + 1
    with pytest.raises(ValueError, match="live rows"):
        p.tile(0)


def _u32(a):
    return np.asarray(a).view(np.uint32) if np.asarray(a).dtype == np.int32 \
        else np.asarray(a, dtype=np.uint32)


def emulate_kernel(p, tile, state, keep=None, flip=None, seed=0):
    """The CUDA kernel's function over plan `p` in numpy, on uint32 arrays:
    CTA tiles of `tile` words; a CTA's slots start as garbage (a read of a
    slot the plan never filled shows), its base rows are loaded once, and
    each level reads its inputs from the slots only, stores every gate's
    word (the columns below tw) and then its output slots.  Returns the
    final state."""
    state = state.copy()
    tw = state.shape[1]
    rng = np.random.default_rng(seed)
    d = p.desc.astype(np.int64)
    for t0 in range(0, tw, tile):
        n = min(tw, t0 + tile) - t0
        slots = rng.integers(0, 2**32, (max(p.n_slots, 1), tile),
                             dtype=np.uint64).astype(np.uint32)
        has = p.base_slot >= 0
        slots[p.base_slot[has], :n] = state[np.flatnonzero(has), t0:t0 + n]
        for l in range(p.L):
            A, B, C = (slots[d[l, :, k]] for k in range(3))
            v = ~((A & B) | (B & C) | (A & C))
            if keep is not None:
                v[:, :n] &= keep[l, :, t0:t0 + n]
            if flip is not None:
                v[:, :n] ^= flip[l, :, t0:t0 + n]
            r0 = p.base + l * p.W
            state[r0:r0 + p.W, t0:t0 + n] = v[:, :n]
            o = d[l, :, 3]
            slots[o[o != P.NO_SLOT]] = v[o != P.NO_SLOT]
    return state


def _emulate_vs_jax(rows, base, tw, seed, budget=P.SMEM_BUDGET):
    """Random state and masks; the emulation in every mode (at the tile the
    plan takes for it) against the JAX kernel in interpret mode."""
    L, W, _ = rows.shape
    rng = np.random.default_rng(seed)

    def words(*shape):
        return rng.integers(0, 2**32, shape, dtype=np.uint64) \
            .astype(np.uint32)

    state, keep, flip = words(base + L * W, tw), words(L, W, tw), \
        words(L, W, tw)
    p = P.plan(rows, base)
    tiles = []
    for mode in MODES:
        k = keep if mode == "keep+xor" else None
        f = None if mode == "none" else flip
        want = np.asarray(netlist_exec_kernel(
            jnp.asarray(rows), jnp.asarray(state),
            None if k is None else jnp.asarray(k),
            None if f is None else jnp.asarray(f), base=base, tile_tw=tw,
            interpret=True))
        tile = p.tile((f is not None) + (k is not None), budget)
        got = emulate_kernel(p, tile, state, k, f, seed)
        np.testing.assert_array_equal(got, want, err_msg=mode)
        tiles.append(tile)
    return tiles


@pytest.mark.parametrize("nb,trials", [(8, 32 * 45), (16, 32 * 20)])
def test_emulated_kernel_matches_jax_multiplier(nb, trials):
    sch = TS.schedule(TM.multiplier_netlist(nb))
    assert _emulate_vs_jax(sch.rows_in, sch.base, trials // 32, nb) \
        == [32, 32, 32]


@pytest.mark.parametrize("tile", [16, 4, 1])
def test_emulated_kernel_matches_jax_narrow_tiles(tile):
    """Budgets that force narrower tiles, with tw not a multiple of them."""
    sch = TS.schedule(TM.multiplier_netlist(8))
    p = P.plan(sch.rows_in, sch.base)
    budget = max(p.smem_bytes(tile, m) for m in range(3))
    tiles = _emulate_vs_jax(sch.rows_in, sch.base, 13, tile, budget)
    assert tiles[-1] == tile and min(tiles) == tile


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2**20), rows=st.booleans())
def test_emulated_kernel_matches_jax_random(seed, rows):
    """Random netlists' schedules, or uniformly random rows_in."""
    rng = np.random.default_rng(seed)
    if rows:
        base = int(rng.integers(1, 9))
        r = _random_rows(int(rng.integers(1, 12)), int(rng.integers(1, 20)),
                         base, seed)
    else:
        sch = TS.levelize(_random_netlist(TN, seed))
        if sch.n_levels == 0:
            return
        r, base = sch.rows_in, sch.base
    _emulate_vs_jax(r, base, int(rng.integers(1, 40)), seed)


def test_op_plans_each_schedule_once(monkeypatch):
    """The op plans a schedule once, whatever tensor carries it (the plan
    cache is keyed on rows_in's bytes), and plans again when the rows
    change."""
    builds = []
    real = P.build_plan

    def counting(r, base):
        builds.append(1)
        return real(r, base)

    monkeypatch.setattr(P, "build_plan", counting)
    rows, base, tw = _random_rows(6, 9, 4, 2024), 4, 3
    rng = np.random.default_rng(0)
    state = torch.from_numpy(rng.integers(-2**31, 2**31, (base + 54, tw))
                             .astype(np.int32))
    want = netlist_exec_ref(torch.from_numpy(rows), state.clone(),
                            base=base)
    for _ in range(2):
        got = netlist_exec(torch.from_numpy(rows.copy()), state.clone(),
                           base=base)
        assert torch.equal(got, want)
    assert len(builds) == 1
    rows[5, 0, 0] = 2 if rows[5, 0, 0] == 1 else 1
    netlist_exec(torch.from_numpy(rows), state.clone(), base=base)
    assert len(builds) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", ["tw_under_tile", "tw_not_multiple",
                                  "x4_under_tile", "x4_not_multiple",
                                  "one_level", "random_rows"])
def test_kernel_edge_shapes_match_plain_on_card(case, mode):
    """Tiles past tw, with tw odd (one word a thread) or a multiple of 4
    (four), one level, and uniformly random rows.  The tiles wider than tw
    go to the kernel's binding directly: the op narrows them."""
    dev = _cuda()
    if case == "one_level":
        rows, base, tw = _random_rows(1, 37, 11, 3), 11, 72
    elif case == "random_rows":
        rows, base, tw = _random_rows(40, 50, 9, 4), 9, 333
    else:
        sch = TS.schedule(TM.multiplier_netlist(8))
        rows, base = sch.rows_in, sch.base
        tw = {"tw_under_tile": 5, "tw_not_multiple": 45,
              "x4_under_tile": 8, "x4_not_multiple": 44}[case]
    _kernel_vs_plain(torch.as_tensor(rows).to(dev), base, tw, mode, 11,
                     tile=32 if case.endswith("under_tile") else None)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tile", P.TILES)
@pytest.mark.parametrize("x4", [False, True])
def test_kernel_every_tile_matches_plain_on_card(x4, tile, mode):
    """Each tile width (the one a budget of its size forces), launched
    through the kernel's binding, tw not a multiple of it: odd (one word a
    thread) or a multiple of 4 (four words a thread from a 4-word tile
    up), over more CTAs than the card has SMs."""
    dev = _cuda()
    sch = TS.schedule(TM.multiplier_netlist(8))
    m = MODES.index(mode)
    p = P.plan(sch.rows_in, sch.base)
    assert p.tile(m, p.smem_bytes(tile, m)) == tile
    n = torch.cuda.get_device_properties(dev).multi_processor_count + 1
    tw = n * tile + (4 if x4 else 1)
    _kernel_vs_plain(torch.as_tensor(sch.rows_in).to(dev), sch.base, tw,
                     mode, tile, tile=tile)


def _kernel_vs_plain(rows, base, tw, mode, seed, tile=None):
    """The op (tile None) or the kernel's binding at `tile` against the
    plain version, on random state and masks."""
    dev = rows.device
    L, W, _ = rows.shape
    g = torch.Generator().manual_seed(seed)

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, generator=g,
                             dtype=torch.int64).to(torch.int32).to(dev)

    state, keep, flip = words(base + L * W, tw), words(L, W, tw), \
        words(L, W, tw)
    keep = keep if mode == "keep+xor" else None
    flip = None if mode == "none" else flip
    want = netlist_exec_ref(rows, state.clone(), keep, flip, base=base)
    if tile is None:
        got = netlist_exec(rows, state, keep, flip, base=base)
    else:
        from repro_torch.kernels.netlist_exec import kernel
        p = P.plan(rows.cpu().numpy(), base)
        assert p.tile((keep is not None) + (flip is not None)) >= tile
        kernel.netlist_exec(p, tile, state, keep, flip)
        got = state
    torch.cuda.synchronize()
    assert torch.equal(got, want)
