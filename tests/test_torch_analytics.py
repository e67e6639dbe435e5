"""The closed forms of `core/analytics.py` in the port against the JAX
package's (the same float64 numpy arithmetic): every function on grids of
inputs, identical (`np.array_equal`, no tolerance), and `ScrubTrajectory`
on one event stream."""
import dataclasses

import numpy as np
import pytest

from repro_torch.core import analytics as TA

try:    # without JAX (as on a GPU machine) nothing here runs
    from repro.core import analytics as JA
except ImportError:
    JA = None

pytestmark = pytest.mark.skipif(JA is None, reason="needs the JAX package")

PG = np.logspace(-13, -2, 23)
T = np.concatenate([[0.0, 1.0, 8.0, 32.0], np.logspace(3, 8, 6)])
P_INPUT = (0.0, 1e-12, 1e-10, 1e-9, 1e-8, 2e-6, 1e-4, 5e-4, 0.02)
CASES = [TA.AlexNetCaseStudy(), TA.AlexNetCaseStudy(M=16, p_mask=0.25),
         TA.AlexNetCaseStudy(M=8, p_mask=0.25, bits_per_weight=16)]


def _j(cs):
    return JA.AlexNetCaseStudy(**dataclasses.asdict(cs))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True)


def test_case_study_constants():
    assert dataclasses.asdict(TA.AlexNetCaseStudy()) == \
        dataclasses.asdict(JA.AlexNetCaseStudy())


@pytest.mark.parametrize("alpha,G", [(12559 / 13792, 13792),
                                     (3051 / 3312, 3312), (699 / 760, 760)])
def test_p_mult_forms_identical(alpha, G):
    _same(TA.p_mult_from_alpha(PG, alpha, G), JA.p_mult_from_alpha(PG, alpha,
                                                                   G))
    for ideal in (False, True):
        for bits in (64, 32):
            _same(TA.p_mult_tmr(PG, alpha, G, n_out_bits=bits,
                                ideal_voting=ideal),
                  JA.p_mult_tmr(PG, alpha, G, n_out_bits=bits,
                                ideal_voting=ideal))


@pytest.mark.parametrize("ci", range(len(CASES)))
def test_nn_misclassification_identical(ci):
    p_mult = np.concatenate([[0.0, 1.0], np.logspace(-12, -1, 12)])
    _same(TA.nn_misclassification(p_mult, CASES[ci]),
          JA.nn_misclassification(p_mult, _j(CASES[ci])))


@pytest.mark.parametrize("p_input", P_INPUT)
def test_weight_corruption_forms_identical(p_input):
    for cs in CASES:
        jcs = _j(cs)
        _same(TA.weight_corruption_baseline(p_input, T, cs),
              JA.weight_corruption_baseline(p_input, T, jcs))
        for m in (8, 15, 16, 32):
            _same(TA.weight_corruption_ecc(p_input, T, m, cs),
                  JA.weight_corruption_ecc(p_input, T, m, jcs))
            _same(TA.weight_corruption_ecc_refined(p_input, T, m, cs),
                  JA.weight_corruption_ecc_refined(p_input, T, m, jcs))


def test_expected_corrupted_weights_identical():
    p = np.concatenate([[0.0, 1.0], np.logspace(-12, -1, 12)])
    for cs in CASES:
        _same(TA.expected_corrupted_weights(p, cs),
              JA.expected_corrupted_weights(p, _j(cs)))


@pytest.mark.parametrize("p_bit", [0.0, 1e-9, 2e-6, 1e-4, 5e-4, 0.5, 1.0])
def test_expected_scrub_rates_identical(p_bit):
    for n_blocks, wpb, bpw in ((1_937_500, 32, 32), (1, 32, 32),
                               (1000, 16, 32), (7, 32, 16)):
        assert TA.expected_scrub_rates(p_bit, n_blocks, wpb, bpw) == \
            JA.expected_scrub_rates(p_bit, n_blocks, wpb, bpw)


def _stream(traj_cls):
    rng = np.random.default_rng(5)
    traj = traj_cls(n_blocks=4096)
    for step in range(0, 200, 10):
        traj.add(step, *rng.integers(0, 40, 3))
    return traj


@pytest.mark.parametrize("p_bit", [0.0, 1e-6, 3e-6, 1e-3])
def test_scrub_trajectory_identical(p_bit):
    t, j = _stream(TA.ScrubTrajectory), _stream(JA.ScrubTrajectory)
    assert (t.steps, t.corrected, t.parity_fixed, t.uncorrectable) == \
        (j.steps, j.corrected, j.parity_fixed, j.uncorrectable)
    assert t.n_scrubs == j.n_scrubs == 20
    assert t.totals() == j.totals()
    assert t.observed_flip_rate() == j.observed_flip_rate()
    assert t.rate_per_scrub() == j.rate_per_scrub()
    assert t.drift_ratio(p_bit) == j.drift_ratio(p_bit)
    assert t.summary(p_bit) == j.summary(p_bit)


def test_scrub_trajectory_empty_and_silent():
    for cls in (TA.ScrubTrajectory, JA.ScrubTrajectory):
        empty = cls()
        assert empty.observed_flip_rate() == 0.0
        assert empty.rate_per_scrub() == 0.0
        assert empty.drift_ratio(1e-6) == 1.0
        assert empty.summary(1e-6) == {"corrected": 0, "parity_fixed": 0,
                                       "uncorrectable": 0, "n_scrubs": 0,
                                       "observed_flip_rate": 0.0}
    t, j = TA.ScrubTrajectory(n_blocks=10), JA.ScrubTrajectory(n_blocks=10)
    for traj in (t, j):
        traj.add(0, 3, 0, 1)
    assert t.drift_ratio(0.0) == j.drift_ratio(0.0) == float("inf")
    assert t.summary(0.0) == j.summary(0.0)
