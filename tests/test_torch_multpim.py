"""The port's MultPIM multiplier path (repro_torch.core.multpim through the
backend registry, core.analytics, faults.wilson_interval) against the JAX
package on the same numpy operands: products and product bits of every
engine, the exhaustive single-fault counts (recomputed here at 8 and 16
bits, and at 32 bits against the constant `chip_smoke.py` holds the card
to), the TMR draw order, the Fig. 4 closed forms to 1e-12, and the path on
the card (skipped without one)."""
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.core import analytics as TA
from repro_torch.core import multpim as TM
from repro_torch.core import scheduler as TS
from repro_torch.core.stateful_logic import g_maj3
from repro_torch.faults import wilson_interval
from repro_torch.reliability import backend

try:    # without JAX (as on a GPU machine) only the card's cases run
    import jax.numpy as jnp
    from repro.core import analytics as JA
    from repro.core import multpim as JM
    from repro.faults.campaign import wilson_interval as j_wilson
except ImportError:
    jnp = None


def _operands(nb, n, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 2**nb, n, dtype=np.uint64).astype(np.uint32)
                 for _ in range(2))


def _t(u32):
    return torch.from_numpy(u32.view(np.int32).copy())


@pytest.mark.parametrize("impl", ["kernel", "level", "scan"])
@pytest.mark.parametrize("nb", [2, 4, 8])
def test_multiply_matches_jax(nb, impl):
    a, b = _operands(nb, 200 if nb > 2 else 16, nb)
    bits = TM.multiply_bits(_t(a), _t(b), nb, impl=impl)
    want = np.asarray(JM.multiply_bits(jnp.asarray(a), jnp.asarray(b), nb))
    np.testing.assert_array_equal(bits.numpy(), want)
    np.testing.assert_array_equal(
        bits.numpy(), JM.true_product_bits(a, b, nb))
    words = TM.multiply_words(_t(a), _t(b), nb, impl=impl)
    assert words.dtype == torch.int32 and words.shape == (len(a), 2)
    np.testing.assert_array_equal(
        words.numpy().view(np.uint32),
        np.asarray(JM.multiply_words(jnp.asarray(a), jnp.asarray(b), nb)))


@pytest.mark.parametrize("impl", ["kernel", "level", "scan"])
def test_single_fault_planes_match_jax(impl):
    nl = TM.multiplier_netlist(4)
    a, b = _operands(4, nl.n_gates, 0)
    fg = np.arange(nl.n_gates, dtype=np.int32)
    got = TM.multiply_bits(_t(a), _t(b), 4, fault_gate=torch.from_numpy(fg),
                           impl=impl)
    want = JM.multiply_bits(jnp.asarray(a), jnp.asarray(b), 4,
                            fault_gate=jnp.asarray(fg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nb", [8, 16, 32])
def test_true_product_bits_matches_jax(nb):
    a, b = _operands(nb, 500, nb + 1)
    a[:3], b[:3] = (0, 1, 2**nb - 1), (2**nb - 1, 2**nb - 1, 2**nb - 1)
    got = TM.true_product_bits(_t(a), _t(b), nb)
    np.testing.assert_array_equal(got.numpy(),
                                  JM.true_product_bits(a, b, nb))


def _single_fault_wrong(nb):
    """The reference's alpha measurement: one trial per gate on
    default_rng(0) operands, in one chunk."""
    nl = TM.multiplier_netlist(nb)
    a, b = _operands(nb, nl.n_gates, 0)
    bits = TM.multiply_bits(_t(a), _t(b), nb,
                            fault_gate=torch.arange(nl.n_gates))
    want = TM.true_product_bits(_t(a), _t(b), nb)
    return int((bits != want).any(1).sum()), nl.n_gates


@pytest.mark.parametrize("nb,wrong,gates", [(8, 699, 760), (16, 3051, 3312)])
def test_single_fault_counts(nb, wrong, gates):
    assert _single_fault_wrong(nb) == (wrong, gates)
    if nb == 8:          # the JAX package's own count on the same operands
        nl = JM.multiplier_netlist(nb)
        a, b = _operands(nb, nl.n_gates, 0)
        bits = JM.multiply_bits(jnp.asarray(a), jnp.asarray(b), nb,
                                fault_gate=jnp.arange(nl.n_gates))
        assert int((np.asarray(bits) != JM.true_product_bits(a, b, nb))
                   .any(1).sum()) == wrong


def test_single_fault_count_32_is_chip_smokes_constant():
    assert _single_fault_wrong(32) == (chip_smoke.SINGLE_FAULT_WRONG_32,
                                       13792)


def test_tmr_draw_order_and_voting():
    """TMR draws copy 1, copy 2, copy 3 and then the two voting gates from
    one generator, in that order; ideal voting draws no vote faults."""
    nb, p = 4, 0.02
    nl = TM.multiplier_netlist(nb)
    a, b = (_t(x) for x in _operands(nb, 300, 5))
    got = TM.multiply_tmr_bits(a, b, nb, torch.Generator().manual_seed(8), p)
    g = torch.Generator().manual_seed(8)
    x = TM._pack_inputs(a, b, nb)
    o = [TS.execute_levelized(nl, x, g, p) for _ in range(3)]
    assert torch.equal(got, g_maj3(*o, g, p))
    ideal = TM.multiply_tmr_bits(a, b, nb, torch.Generator().manual_seed(8),
                                 p, ideal_voting=True)
    assert torch.equal(ideal, g_maj3(*o))
    clean = TM.true_product_bits(a, b, nb)
    assert torch.equal(TM.multiply_tmr_bits(a, b, nb, None, 0.0), clean)
    # copies fail far more often than the vote of three
    fail = lambda r: float((r != clean).any(1).float().mean())  # noqa: E731
    assert fail(ideal) < fail(o[0])


def test_iid_fault_rate_follows_closed_form():
    """Gate faults at p on the 8-bit multiplier fail products at about the
    closed form's rate (within a 99% Wilson interval)."""
    nb, p, n = 8, 2e-4, 4096
    nl = TM.multiplier_netlist(nb)
    a, b = (_t(x) for x in _operands(nb, n, 42))
    bits = TM.multiply_bits(a, b, nb, torch.Generator().manual_seed(1), p)
    k = int((bits != TM.true_product_bits(a, b, nb)).any(1).sum())
    lo, hi = wilson_interval(k, n, 2.576)
    assert lo <= float(TA.p_mult_from_alpha(p, 699 / 760, nl.n_gates)) <= hi


def test_closed_forms_match_jax():
    pg = np.logspace(-12, -3, 19)
    for alpha, G in ((0.9106, 13792), (699 / 760, 760)):
        np.testing.assert_allclose(TA.p_mult_from_alpha(pg, alpha, G),
                                   JA.p_mult_from_alpha(pg, alpha, G),
                                   rtol=0, atol=1e-12)
        for ideal in (False, True):
            np.testing.assert_allclose(
                TA.p_mult_tmr(pg, alpha, G, ideal_voting=ideal),
                JA.p_mult_tmr(pg, alpha, G, ideal_voting=ideal),
                rtol=0, atol=1e-12)


@pytest.mark.parametrize("k,n,z", [(0, 10, 1.96), (3, 4096, 2.576),
                                   (50000, 1 << 20, 2.576), (7, 7, 1.0),
                                   (0, 0, 1.96)])
def test_wilson_interval_matches_jax(k, n, z):
    assert wilson_interval(k, n, z) == pytest.approx(j_wilson(k, n, z),
                                                     abs=1e-12)


def test_registry_defaults():
    assert backend.resolve("netlist_exec") == "kernel"
    assert set(backend.implementations("netlist_exec")) == {"kernel",
                                                            "level", "scan"}
    assert backend.resolve("crossbar_nor") == "kernel"
    assert set(backend.implementations("crossbar_nor")) == {"kernel",
                                                            "torch"}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_multiplier_on_card_matches_cpu():
    dev = _cuda()
    nb = 16
    nl = TM.multiplier_netlist(nb)
    a, b = (_t(x) for x in _operands(nb, nl.n_gates, 0))
    fg = torch.arange(nl.n_gates)
    got = TM.multiply_bits(a.to(dev), b.to(dev), nb, fault_gate=fg.to(dev))
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), TM.multiply_bits(a, b, nb, fault_gate=fg))
    want = TM.true_product_bits(a.to(dev), b.to(dev), nb)
    assert int((got != want).any(1).sum()) == 3051
