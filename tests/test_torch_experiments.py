"""The figure experiments of the port (repro_torch.experiments) against the
JAX package's scripts: measure_alpha's single-fault counts at 8 and 16
bits (exact), the Fig. 4 (bottom) and Fig. 5 curve rows equal to the
reference's closed-form rows at that alpha (identical strings), the smoke
campaigns passing their own checks on the CPU, the store simulation and
the batched trials."""
import numpy as np
import pytest
import torch

from repro_torch.experiments import campaign_mc as C
from repro_torch.experiments import fig4_nn as F4
from repro_torch.experiments import fig5_weights as F5
from repro_torch.reliability import standard_grid

try:    # without JAX (as on a GPU machine) only the JAX-free cases run
    import jax  # noqa: F401
    from benchmarks import fig4_nn as JF4
    from benchmarks import fig5_weights as JF5
except ImportError:
    JF4 = None

needs_jax = pytest.mark.skipif(JF4 is None, reason="needs the JAX package")


@pytest.mark.parametrize("n_bits,wrong,gates", [(8, 699, 760),
                                                (16, 3051, 3312)])
def test_measure_alpha(n_bits, wrong, gates):
    assert C.measure_alpha(n_bits, device="cpu") == wrong / gates


@needs_jax
@pytest.mark.parametrize("alpha", [12559 / 13792, 0.9])
def test_fig4_nn_rows_equal_the_reference(monkeypatch, alpha):
    monkeypatch.setattr(JF4, "measure_alpha", lambda: alpha)
    assert F4.run(device="cpu", alpha=alpha) == JF4.run()


@needs_jax
def test_fig5_curve_rows_equal_the_reference(monkeypatch):
    monkeypatch.setattr(JF5, "simulate_store", lambda **kw: 0)
    got, want = F5.run(device="cpu"), JF5.run()
    assert got[:-1] == want[:-1]
    assert got[-1][0] == want[-1][0] == "fig5.sim_store_32scrubs_p2e-6"


def test_campaign_mc_smoke_passes_its_checks():
    rows = C.run(device="cpu", smoke=True)
    names = [r[0] for r in rows]
    pg = C.SMOKE.fig4_pgates
    assert names == (
        ["campaign_mc.alpha"]
        + [f"campaign_mc.fig4_mult_p{p:g}" for p in pg]
        + [f"campaign_mc.fig4_nn_p{p:g}" for p in pg]
        + [f"campaign_mc.fig4_tmr_p{pg[-1]:g}"]
        + [f"campaign_mc.fig5_p{pt['p_input']:g}_T{pt['T']}"
           for pt in C.FIG5_POINTS]
        + [f"campaign_mc.scheme_{s.name}" for s in standard_grid()])
    assert all("agree=True" in d for n, _, d in rows
               if "fig4_mult" in n or "fig4_nn" in n or "fig5" in n)
    assert "alpha=0.9212 gates=3312 n_bits=16" in rows[0][2]


def test_campaign_mc_main_runs_on_the_cpu(capsys):
    assert C.main(["--device", "cpu", "--smoke"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("campaign_mc.alpha,") and len(out) == 14


def test_fig5_trial_batched_over_blocks():
    """Each trial is one block's fate; the closed form is exact for it up
    to flips that land back on an erroneous bit."""
    n = 4096
    g = torch.Generator().manual_seed(3)
    fail, extras = C.make_fig5_trial(5e-4, 8)(g, n)
    assert fail.shape == (n,) and fail.dtype == torch.bool
    k = int(fail.sum())
    from repro_torch.core import analytics as A
    from repro_torch.faults import wilson_interval
    lo, hi = wilson_interval(k, n, 2.576)
    assert lo <= float(A.weight_corruption_ecc(5e-4, np.array([8]),
                                               m=32)[0]) <= hi
    assert int(extras["uncorrectable"]) >= k > 0
    assert int(extras["corrected"]) > 0


@pytest.mark.parametrize("spec", ["unprotected", "ecc", "tmr-serial",
                                  "ecc+tmr-serial"])
def test_scheme_trial_blocks_are_trials(spec):
    """n trials are n blocks of one payload; unprotected and ECC blocks
    fail at their closed forms' rates (99% intervals), TMR far less."""
    from repro_torch.core import analytics as A
    from repro_torch.faults import wilson_interval
    scheme = next(s for s in standard_grid() if s.name == spec)
    n, p, T = 4096, C.GRID_P_INPUT, C.GRID_T
    fail = C.make_scheme_trial(scheme)(torch.Generator().manual_seed(5), n)
    assert fail.shape == (n,) and fail.dtype == torch.bool
    lo, hi = wilson_interval(int(fail.sum()), n, 2.576)
    if spec == "unprotected":    # a block fails once any of its bits flips
        assert lo <= 1 - (1 - p) ** (1024 * T) <= hi
    elif spec == "ecc":          # >= 2 flips in one interval
        assert lo <= float(A.weight_corruption_ecc(p, np.array([T]),
                                                   m=32)[0]) <= hi
    else:
        assert int(fail.sum()) <= 10


def test_simulate_store_replays_the_same_flips():
    ecc = F5.simulate_store(1e-4, 4, 8192, device="cpu")
    plain = F5.simulate_store(1e-4, 4, 8192, device="cpu", protected=False)
    assert ecc < plain
    # the unprotected copy takes every flip: about 1 - (1-p)^(32*4) of all
    assert abs(plain / 8192 - (1 - (1 - 1e-4) ** 128)) < 0.01
    assert F5.simulate_store(1e-4, 4, 8192, device="cpu") == ecc


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_fig5_trial_kernels_match_plain_on_card():
    """The fused inject_scrub trial on the card against the plain versions
    on the card, the same generator state: the same fails and counts."""
    dev = _cuda()
    from repro_torch.reliability import backend
    out = []
    for impl in ("kernel", "torch"):
        saved = backend._DEFAULTS.copy()
        backend._DEFAULTS.update(diag_parity=impl, inject_scrub=impl)
        try:
            g = torch.Generator(device=dev).manual_seed(7)
            fail, ex = C.make_fig5_trial(5e-4, 4)(g, 20000)
        finally:
            backend._DEFAULTS.update(saved)
        out.append((fail.cpu(), int(ex["corrected"]),
                    int(ex["uncorrectable"])))
    assert torch.equal(out[0][0], out[1][0]) and out[0][1:] == out[1][1:]


@pytest.mark.gpu
def test_scheme_grid_on_card():
    dev = _cuda()
    rows, results = C.scheme_grid(C.store_config(1 << 14), dev)
    assert len(rows) == len(standard_grid())
    assert all(r.n_trials == 1 << 14 and r.peak_bytes for r in results)
