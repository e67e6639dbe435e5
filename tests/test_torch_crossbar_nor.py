"""The gate-serial netlist kernel op of the port
(repro_torch.kernels.crossbar_nor, whose wrapper takes the plain version
for a CPU tensor) against the JAX package's `execute_netlist_ref` (the
lax.scan executor; the reference's Pallas interpreter does not run on the
installed JAX), the wrapper's checks, and the CUDA kernel against the
plain version on the card (skipped without one)."""
import numpy as np
import pytest
import torch

from repro_torch.core import multpim as TM
from repro_torch.core import netlist as TN
from repro_torch.kernels.crossbar_nor import (crossbar_nor, crossbar_nor_ref,
                                              execute_netlist,
                                              execute_netlist_ref)

try:    # without JAX (as on a GPU machine) only the card's cases run
    import jax.numpy as jnp
    from repro.core import multpim as JM
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
