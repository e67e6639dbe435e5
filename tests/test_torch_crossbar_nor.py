"""The gate-serial netlist kernel op of the port
(repro_torch.kernels.crossbar_nor, whose wrapper takes the plain version
for a CPU tensor) against the JAX package's `execute_netlist_ref` (the
lax.scan executor; the reference's Pallas interpreter does not run on the
installed JAX), the wrapper's checks; the kernel's plan (versions, levels,
slots, final writes) on gate lists that reuse wires; a numpy emulation of
the CUDA kernel over the plan, which reads gate inputs only from its slots
and writes only final versions, against a gate-serial numpy walk (the JAX
`_kernel` body) and the JAX `execute_netlist_ref`; and the CUDA kernel
against the plain version on the card (skipped without one)."""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro_torch.core import multpim as TM
from repro_torch.core import netlist as TN
from repro_torch.core.bitops import pack_trials, unpack_trials
from repro_torch.kernels.crossbar_nor import (crossbar_nor, crossbar_nor_ref,
                                              execute_netlist,
                                              execute_netlist_ref)
from repro_torch.kernels.crossbar_nor import kernel as K
from repro_torch.kernels.crossbar_nor import plan as CP
from repro_torch.kernels import _build
from repro_torch.kernels.crossbar_nor.ops import launch
from repro_torch.kernels.netlist_exec.plan import (NO_SLOT, SMEM_BUDGET,
                                                   TILES, widest_tile)

try:    # without JAX (as on a GPU machine) only the card's cases run
    import jax.numpy as jnp
    from repro.core import multpim as JM
    from repro.core import netlist as JN
    from repro.kernels.crossbar_nor import execute_netlist_ref as j_ref
except ImportError:
    jnp = None

from test_torch_netlist import _random_netlist


@pytest.mark.parametrize("nb,trials", [(4, 3), (4, 32), (8, 70), (8, 130)])
def test_execute_netlist_matches_jax(nb, trials):
    nl = TM.multiplier_netlist(nb)
    rng = np.random.default_rng(trials)
    x = rng.integers(0, 2, (trials, len(nl.inputs))).astype(bool)
    want = np.asarray(j_ref(JM.multiplier_netlist(nb), jnp.asarray(x)))
    got = execute_netlist(nl, torch.from_numpy(x))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        execute_netlist_ref(nl, torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("seed", [2, 31])
def test_random_netlist_matches_scan(seed):
    nl = _random_netlist(TN, seed)
    x = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2, (50, len(nl.inputs))).astype(bool))
    assert torch.equal(execute_netlist(nl, x), TN.execute(nl, x))


def test_state_level_op_is_gate_serial():
    """Random packed words in, every gate in list order: the final state
    of the plain version equals a numpy walk, and the input is kept."""
    nl = TM.multiplier_netlist(4)
    rng = np.random.default_rng(0)
    s = rng.integers(0, 2**32, (3, nl.n_wires), dtype=np.uint64) \
        .astype(np.uint32)
    state = torch.from_numpy(s.view(np.int32).copy())
    got = crossbar_nor(torch.as_tensor(nl.gates), state)
    assert not torch.equal(got, state)
    np.testing.assert_array_equal(state.numpy().view(np.uint32), s)
    for i1, i2, i3, o in nl.gates:
        a, b, c = s[:, i1], s[:, i2], s[:, i3]
        s[:, o] = ~((a & b) | (b & c) | (a & c))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), s)


def test_wrapper_rejects_bad_operands():
    nl = TM.multiplier_netlist(4)
    state = torch.zeros((2, nl.n_wires), dtype=torch.int32)
    gates = torch.as_tensor(nl.gates)
    with pytest.raises(ValueError, match="gates"):
        crossbar_nor(gates.long(), state)
    with pytest.raises(ValueError, match="state"):
        crossbar_nor(gates, state.T)
    with pytest.raises(ValueError, match="outside"):
        crossbar_nor(gates, state[:, :-1].contiguous())


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("nb,tw", [(4, 1), (8, 37), (32, 5)])
def test_kernel_matches_plain_on_card(nb, tw):
    dev = _cuda()
    nl = TM.multiplier_netlist(nb)
    g = torch.Generator().manual_seed(nb)
    state = torch.randint(-2**31, 2**31, (tw, nl.n_wires), generator=g,
                          dtype=torch.int64).to(torch.int32)
    gates = torch.as_tensor(nl.gates)
    want = crossbar_nor_ref(gates, state)
    got = crossbar_nor(gates.to(dev), state.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_execute_netlist_on_card_matches_cpu():
    dev = _cuda()
    nl = TM.multiplier_netlist(8)
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2, (777, 16)).astype(bool))
    got = execute_netlist(nl, x.to(dev))
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), execute_netlist(nl, x))


# ----------------------------------------------------------------------------
# the levelized kernel's plan and its emulation
# ----------------------------------------------------------------------------

def _words(rng, *shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def walk(gates, state):
    """The TPU kernel's body (crossbar_nor/kernel.py `_kernel`) in numpy:
    every gate in list order over uint32 (tw, n_wires) words."""
    s = state.copy()
    for i1, i2, i3, o in np.asarray(gates).tolist():
        a, b, c = s[:, i1], s[:, i2], s[:, i3]
        s[:, o] = ~((a & b) | (b & c) | (a & c))
    return s


def _slots(p, l):
    """(W, 5) slots of level l's descriptors: gate inputs a, b, c, its
    output, and the flush's read."""
    ab, cy = (p.gd[l, :, k].view(np.uint32) for k in (0, 1))
    return np.stack([ab & 0xFFFF, ab >> 16, cy & 0xFFFF, cy >> 16,
                     p.gd[l, :, 3].view(np.uint32)], 1).astype(np.int64)


def emulate_kernel(p, tile, state, seed=0):
    """The CUDA kernel's function over plan `p` in numpy, on uint32 (tw,
    n_wires) words: CTA tiles of `tile` words whose slots start as garbage
    (a read of a slot the plan never filled shows) and `out` as garbage
    too (a wire the kernel never writes shows); a tile loads its base rows
    into their slots and copies the never-written wires, then each level
    reads its gate inputs and flushed versions from the slots only, writes
    the flushes to `out` and its gates' outputs to their slots."""
    rng = np.random.default_rng(seed)
    tw = state.shape[0]
    out = _words(rng, *state.shape)
    for t0 in range(0, tw, tile):
        n = min(tw, t0 + tile) - t0
        slots = _words(rng, max(p.n_slots, 1), tile)
        slots[p.base_slot, :n] = state[t0:t0 + n, p.base_wire].T
        out[t0:t0 + n, p.copy_wire] = state[t0:t0 + n, p.copy_wire]
        for l in range(p.L):
            d = _slots(p, l)
            A, B, C, F = (slots[d[:, k]] for k in (0, 1, 2, 4))
            v = ~((A & B) | (B & C) | (A & C))
            wire = p.gd[l, :, 2]
            out[t0:t0 + n, wire[wire >= 0]] = F[wire >= 0, :n].T
            o = d[:, 3]
            slots[o[o != NO_SLOT]] = v[o != NO_SLOT]
    return out


def _reuse_list(seed, max_wires=12, max_gates=60):
    """A random gate list over a few wires: wires written several times,
    gates reading their own output, wires read before any write."""
    rng = np.random.default_rng(seed)
    n_wires = int(rng.integers(1, max_wires + 1))
    G = int(rng.integers(0, max_gates + 1))
    return rng.integers(0, n_wires, (G, 4)).astype(np.int32), n_wires


def _edge_lists():
    """Named (gates, n_wires) lists of each hazard the plan renames away."""
    yield "empty", np.zeros((0, 4), np.int32), 5
    yield "write_after_write", np.array(
        [[0, 1, 2, 3], [3, 0, 1, 3], [2, 2, 0, 3], [3, 3, 1, 4]], np.int32), 5
    yield "reads_own_output", np.array(
        [[2, 3, 4, 4], [4, 4, 0, 4], [4, 1, 2, 0]], np.int32), 5
    yield "read_before_write", np.array(
        [[0, 1, 4, 2], [4, 2, 3, 4], [4, 4, 4, 1], [1, 0, 4, 3]], np.int32), 5
    yield "writes_wires_0_and_1", np.array(
        [[0, 1, 2, 0], [0, 0, 1, 1], [1, 2, 0, 2]], np.int32), 3
    yield "one_wire", np.array([[0, 0, 0, 0]] * 4, np.int32), 1
    for nb in (4, 8):
        nl = TM.multiplier_netlist(nb)
        yield f"multiplier{nb}", nl.gates, nl.n_wires
    for seed in (3, 17, 2024):
        yield (f"reuse{seed}",) + _reuse_list(seed)


def _versions(gates, n_wires):
    """Gate-serial renaming, independent of the plan's: for each gate the
    versions its inputs read, ("w", wire) for a wire's version 0 or ("g",
    gate) for a write, and the wires read before they are written."""
    cur, reads, first = {}, [], set()
    for g, (i1, i2, i3, o) in enumerate(np.asarray(gates).tolist()):
        r = []
        for w in (i1, i2, i3):
            if w not in cur:
                first.add(w)
            r.append(cur.get(w, ("w", w)))
        reads.append(r)
        cur[o] = ("g", g)
    return reads, first, cur


@pytest.mark.parametrize("name,gates,n_wires", list(_edge_lists()),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_plan_invariants(name, gates, n_wires):
    """Every gate once, in the gate levels; each version read (by a gate or
    a flush) lives in its slot from its write to its last read (a slot is
    taken over only after that); a write has a slot exactly when a later
    level reads it; every wire's final version is flushed once, after it is
    written, in wire order within a level, and the rest are copied; the
    base rows are exactly the wires read before written."""
    p = CP.build(gates, n_wires)
    reads, first, final = _versions(gates, n_wires)
    G = len(gates)
    assert p.L >= p.gate_levels >= p.depth
    assert (p.gid[p.gate_levels:] < 0).all()
    gid = p.gid[p.gid >= 0]
    np.testing.assert_array_equal(np.sort(gid), np.arange(G))
    assert set(p.base_wire.tolist()) == first
    assert len(set(p.base_slot.tolist())) == len(first)
    owner = {int(s): ("w", int(w)) for w, s in zip(p.base_wire, p.base_slot)}
    level_of = {int(g): l for l, s in zip(*np.nonzero(p.gid >= 0))
                for g in [p.gid[l, s]]}
    flush_at = {}
    for l in range(p.L):
        d = _slots(p, l)
        wires = p.gd[l, :, 2]
        assert (np.diff(wires[wires >= 0]) > 0).all()     # in wire order
        for s in range(p.W):
            g = int(p.gid[l, s])
            if g < 0:
                assert d[s, 3] == NO_SLOT
            else:
                for k in range(3):
                    assert owner.get(int(d[s, k])) == reads[g][k], (l, s, k)
            w = int(wires[s])
            if w >= 0:
                assert w not in flush_at and owner.get(int(d[s, 4])) == \
                    final[w], (l, s)
                flush_at[w] = l
        later = {v for r in reads for v in r} | set(final.values())
        for s in range(p.W):
            g = int(p.gid[l, s])
            if g >= 0 and d[s, 3] != NO_SLOT:
                owner[int(d[s, 3])] = ("g", g)
            if g >= 0:
                assert (d[s, 3] != NO_SLOT) == (("g", g) in later), (l, s)
    assert p.n_slots == max(owner, default=-1) + 1
    assert set(flush_at) == set(final)
    assert all(flush_at[w] > level_of[v[1]] for w, v in final.items())
    np.testing.assert_array_equal(
        p.copy_wire, np.setdiff1d(np.arange(n_wires), list(final)))


@pytest.mark.parametrize("name,gates,n_wires", list(_edge_lists()),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_emulated_kernel_matches_walk(name, gates, n_wires):
    """Random words in every wire (wires 0 and 1 included), at the plan's
    tile and narrower ones, tw not a multiple of them."""
    p = CP.build(gates, n_wires)
    state = _words(np.random.default_rng(len(gates)), 13, n_wires)
    want = walk(gates, state)
    for tile in sorted({p.tile(), 4, 1}):
        np.testing.assert_array_equal(emulate_kernel(p, tile, state, tile),
                                      want, err_msg=f"tile {tile}")


@pytest.mark.parametrize("nb", [4, 8, 16])
def test_emulated_kernel_matches_walk_multiplier(nb):
    nl = TM.multiplier_netlist(nb)
    p = CP.plan(nl.gates, nl.n_wires)
    state = _words(np.random.default_rng(nb), 37, nl.n_wires)
    np.testing.assert_array_equal(emulate_kernel(p, p.tile(), state),
                                  walk(nl.gates, state))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**20), tw=st.integers(1, 20),
       tile=st.sampled_from(TILES))
def test_emulated_kernel_matches_walk_random_lists(seed, tw, tile):
    """Hypothesis-drawn lists that reuse wires, G = 0 among them."""
    gates, n_wires = _reuse_list(seed, max_gates=int(seed % 3) * 40)
    p = CP.build(gates, n_wires)
    state = _words(np.random.default_rng(seed), tw, n_wires)
    np.testing.assert_array_equal(emulate_kernel(p, tile, state, seed),
                                  walk(gates, state))


def _emulate_netlist(nl, x):
    """execute_netlist's packing around the emulated kernel."""
    trials = x.shape[0]
    state = np.zeros((-(-trials // 32), nl.n_wires), np.uint32)
    state[:, 1] = 0xFFFFFFFF
    state[:, nl.inputs] = pack_trials(torch.from_numpy(x)).numpy() \
        .view(np.uint32)
    p = CP.plan(nl.gates, nl.n_wires)
    out = emulate_kernel(p, p.tile(), state)
    return unpack_trials(torch.from_numpy(out[:, nl.outputs].view(np.int32)),
                         trials).numpy()


@pytest.mark.parametrize("nb,trials", [(4, 3), (8, 70), (16, 130)])
def test_emulated_kernel_matches_jax_multiplier(nb, trials):
    nl = TM.multiplier_netlist(nb)
    x = np.random.default_rng(trials).integers(
        0, 2, (trials, len(nl.inputs))).astype(bool)
    want = np.asarray(j_ref(JM.multiplier_netlist(nb), jnp.asarray(x)))
    np.testing.assert_array_equal(_emulate_netlist(nl, x), want)


@pytest.mark.parametrize("seed", [2, 31, 77])
def test_emulated_kernel_matches_jax_random_netlist(seed):
    nl = _random_netlist(TN, seed)
    x = np.random.default_rng(seed).integers(
        0, 2, (50, len(nl.inputs))).astype(bool)
    want = np.asarray(j_ref(_random_netlist(JN, seed), jnp.asarray(x)))
    np.testing.assert_array_equal(_emulate_netlist(nl, x), want)


def _spread(nl, n_wires):
    """`nl`'s gate list with its wires spread over n_wires (wire w -> w *
    stride): the same function, far more wires, as few live."""
    stride = (n_wires - 1) // (nl.n_wires - 1)
    return (nl.gates * stride).astype(np.int32), stride


def _over_budget():
    """20,000 independent gates reading 60,000 distinct wires: every base
    row is live at the first level (240 KB at one trial word)."""
    w = np.arange(60000, dtype=np.int32).reshape(-1, 3)
    out = 60000 + np.arange(len(w), dtype=np.int32)[:, None]
    return np.concatenate([w, out], 1), 80000


def test_plan_tiles_and_the_live_limit():
    """The 32-bit multiplier plans at 320 gate levels of W = 128 (depth
    306) and one level of flushes only, with 1,877 live slots and a 16-word
    tile, the 64-bit one at W = 256 and an 8-word tile; the plan is cached
    by the list's bytes and n_wires; a list is refused for its live
    versions, never for its wire count: the 8-bit multiplier spread over
    70,000 wires plans, 60,000 live base rows do not, and the error names
    the limit."""
    nl = TM.multiplier_netlist(32)
    p = CP.plan(nl.gates, nl.n_wires)
    assert (p.L, p.gate_levels, p.W, p.depth, p.n_slots, p.tile()) == (
        321, 320, 128, 306, 1877, 16)
    assert CP.plan(nl.gates.copy(), nl.n_wires) is p
    assert CP.plan(nl.gates, nl.n_wires + 1) is not p
    assert p.smem_bytes(16) <= SMEM_BUDGET < p.smem_bytes(32)
    for t in TILES:
        assert p.tile(p.smem_bytes(t)) == t
    nl64 = TM.multiplier_netlist(64)
    p64 = CP.plan(nl64.gates, nl64.n_wires)
    assert (p64.W, p64.tile()) == (256, 8)
    assert p64.smem_bytes(16) > SMEM_BUDGET
    gates, _ = _spread(TM.multiplier_netlist(8), 70000)
    assert CP.plan(gates, 70000).tile() == 32
    gates, n_wires = _over_budget()
    p = CP.plan(gates, n_wires)
    assert p.n_slots >= 60000
    with pytest.raises(ValueError, match="at most 51968 live versions"):
        p.tile()


def test_plan_cache_compares_whole_lists():
    """A plan is found for the same bytes in another array (a copy, a
    non-contiguous view, int64) and is not found for a list that differs in
    one entry; changing the caller's array after planning leaves the cached
    list as it was planned."""
    gates = TM.multiplier_netlist(8).gates.copy()
    n_wires = int(gates.max()) + 1
    p = CP.plan(gates, n_wires)
    assert CP.plan(gates.copy(), n_wires) is p
    assert CP.plan(np.asfortranarray(gates), n_wires) is p
    assert CP.plan(gates.astype(np.int64), n_wires) is p
    other = gates.copy()
    other[-1, 0] = 1 if other[-1, 0] == 0 else 0
    q = CP.plan(other, n_wires)
    assert q is not p and CP.plan(other.copy(), n_wires) is q
    gates[-1, 0] = other[-1, 0]            # the caller's array changes
    assert CP.plan(gates, n_wires) is q
    assert CP.plan(TM.multiplier_netlist(8).gates, n_wires) is p


@pytest.mark.parametrize("per_word,fixed,n_slots,want", [
    (100, 0, 10, 32),          # every tile fits: the widest
    (1000, 1000, 10, 16),      # 33,000 bytes over a 20,000 budget at 32
    (15000, 0, 10, 1),         # only one word fits
    (30000, 0, 10, 0),         # not even one word fits
    (1, 0, NO_SLOT + 1, 0),    # a descriptor cannot name the slots
])
def test_widest_tile_is_the_widest_fit(per_word, fixed, n_slots, want):
    assert widest_tile(lambda t: fixed + per_word * t, n_slots,
                       20000) == want


def test_plan_rejects_wires_out_of_range():
    with pytest.raises(ValueError, match="outside"):
        CP.build(np.array([[0, 1, 2, 5]], np.int32), 5)
    with pytest.raises(ValueError, match="outside"):
        CP.build(np.array([[0, -1, 2, 3]], np.int32), 5)


# ----------------------------------------------------------------------------
# the levelized kernel on the card
# ----------------------------------------------------------------------------

def _random_state(g, tw, n_wires):
    return torch.randint(-2**31, 2**31, (tw, n_wires), generator=g,
                         dtype=torch.int64).to(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("tw", [1, 3, 37, 431, 2048])
def test_levelized_kernel_trial_words_on_card(tw):
    """The 32-bit multiplier at every tile the op's rule gives (431 words:
    4-word tiles on 108 CTAs)."""
    dev = _cuda()
    nl = TM.multiplier_netlist(32)
    state = _random_state(torch.Generator().manual_seed(tw), tw, nl.n_wires)
    gates = torch.as_tensor(nl.gates)
    want = crossbar_nor_ref(gates, state)
    got = crossbar_nor(gates.to(dev), state.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("name,gates,n_wires", list(_edge_lists()),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_levelized_kernel_reusing_lists_on_card(name, gates, n_wires):
    dev = _cuda()
    state = _random_state(torch.Generator().manual_seed(len(gates)), 45,
                          n_wires)
    g = torch.as_tensor(gates)
    want = crossbar_nor_ref(g, state)
    got = crossbar_nor(g.to(dev), state.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", TILES)
def test_levelized_kernel_every_tile_on_card(tile):
    """The binding at each tile width, tw not a multiple of it."""
    dev = _cuda()
    nl = TM.multiplier_netlist(16)
    p = CP.plan(nl.gates, nl.n_wires)
    state = _random_state(torch.Generator().manual_seed(tile), 2 * tile + 3,
                          nl.n_wires)
    out = torch.empty_like(state, device=dev)
    K.crossbar_nor(p, tile, state.to(dev), out)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), crossbar_nor_ref(torch.as_tensor(nl.gates),
                                                   state))


@pytest.mark.gpu
def test_levelized_kernel_64bit_multiplier_on_card():
    """56,386 wires: a trial word's whole row (225.5 KB) would all but
    fill a CTA's shared memory."""
    dev = _cuda()
    nl = TM.multiplier_netlist(64)
    state = _random_state(torch.Generator().manual_seed(64), 5, nl.n_wires)
    gates = torch.as_tensor(nl.gates)
    got = crossbar_nor(gates.to(dev), state.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), crossbar_nor_ref(gates, state))


@pytest.mark.gpu
def test_levelized_kernel_wire_count_is_no_limit_on_card():
    """70,000 wires (more than the 58,112 words of a CTA's shared memory)
    run; 60,000 live versions raise, naming the limit."""
    dev = _cuda()
    gates, _ = _spread(TM.multiplier_netlist(8), 70000)
    state = _random_state(torch.Generator().manual_seed(7), 3, 70000)
    g = torch.as_tensor(gates)
    got = crossbar_nor(g.to(dev), state.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), crossbar_nor_ref(g, state))
    gates, n_wires = _over_budget()
    with pytest.raises(ValueError, match="live versions"):
        crossbar_nor(torch.as_tensor(gates, device=dev),
                     torch.zeros((1, n_wires), dtype=torch.int32, device=dev))


@pytest.mark.gpu
def test_launch_from_host_list_on_card():
    """`launch` from a host gate list (execute_netlist's route) gives the
    op's result, one launch counted; execute_netlist launches once."""
    dev = _cuda()
    nl = TM.multiplier_netlist(16)
    state = _random_state(torch.Generator().manual_seed(16), 9,
                          nl.n_wires).to(dev)
    _build.reset_launch_counts()
    got = launch(nl.gates, state)
    assert _build.launch_counts().get("crossbar_nor") == 1
    assert torch.equal(got, crossbar_nor(torch.as_tensor(nl.gates,
                                                          device=dev), state))
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, 2, (300, 2 * 16)).astype(bool))
    _build.reset_launch_counts()
    out = execute_netlist(nl, x.to(dev))
    assert _build.launch_counts().get("crossbar_nor") == 1
    assert torch.equal(out.cpu(), execute_netlist(nl, x))
