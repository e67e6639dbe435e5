"""The levelized netlist kernel op of the port
(repro_torch.kernels.netlist_exec, whose wrapper takes the plain version
for a CPU tensor) against the JAX package's Pallas `execute_packed` in
interpret mode -- trials that are not a multiple of 32 and padded,
multi-tile grids, fault-free and with single-fault planes -- plus the
wrapper's checks, and the CUDA kernel against the plain version on the
card in its three mask modes (skipped without one)."""
import numpy as np
import pytest
import torch

from repro_torch.core import multpim as TM
from repro_torch.core import netlist as TN
from repro_torch.core import scheduler as TS
from repro_torch.kernels.netlist_exec import (execute_packed,
                                              execute_packed_ref,
                                              netlist_exec, netlist_exec_ref)

try:    # without JAX (as on a GPU machine) only the card's cases run
    import jax.numpy as jnp
    from repro.core import multpim as JM
    from repro.kernels.netlist_exec import execute_packed as j_packed
except ImportError:
    jnp = None


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
