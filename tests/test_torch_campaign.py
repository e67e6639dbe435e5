"""The port's fault-campaign engine (repro_torch.faults.campaign) against
the JAX package's: a scripted failure stream fed to both engines gives the
same trial counts, failures, extras and intervals (exact); sweeps give the
same labels; a seed replays; distinct batches and points draw from distinct
generators; a Bernoulli(0.3) campaign lands inside its interval.  The
engine on CUDA generators runs on the card only."""
import numpy as np
import pytest
import torch

from repro_torch.faults import campaign as TC
from repro_torch.reliability import standard_grid

try:    # without JAX (as on a GPU machine) only the JAX-free cases run
    import jax
    import jax.numpy as jnp
    from repro.faults import campaign as JC
    from repro.reliability import standard_grid as j_standard_grid
except ImportError:
    jnp = None

needs_jax = pytest.mark.skipif(jnp is None, reason="needs the JAX package")

CPU = torch.device("cpu")


def _stream(seed, n, p=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random(n) < p,
            {"corrected": rng.integers(0, 5, n).astype(np.int32),
             "uncorrectable": rng.integers(0, 2, n).astype(np.int32)})


def _scripted(fail, extras, wrap):
    """A batched trial that plays `fail` and `extras` out in order,
    whatever its key or generator; `wrap` makes the framework's arrays."""
    pos = [0]

    def trial(_, n):
        i = pos[0]
        pos[0] += n
        return wrap(fail[i:i + n]), {k: wrap(v[i:i + n])
                                     for k, v in extras.items()}
    return trial


CONFIGS = {
    "early stop": dict(batch_size=256, max_trials=8192, min_trials=512,
                       ci_halfwidth=0.03, z=2.576),
    "budget not a batch multiple": dict(batch_size=300, max_trials=1000,
                                        min_trials=512, ci_halfwidth=0.0,
                                        z=1.96),
    "halfwidth 0": dict(batch_size=512, max_trials=4096, min_trials=512,
                        ci_halfwidth=0.0, z=1.96),
    "min above budget": dict(batch_size=100, max_trials=450, min_trials=1000,
                             ci_halfwidth=0.5, z=1.0),
}


@needs_jax
@pytest.mark.parametrize("what", sorted(CONFIGS))
def test_scripted_stream_matches_jax(what):
    fail, extras = _stream(len(what), 9000)
    kw = CONFIGS[what]
    got = TC.run_campaign(_scripted(fail, extras, torch.from_numpy), 7,
                          TC.CampaignConfig(**kw), batched=True, name=what,
                          device="cpu")
    want = JC.run_campaign(_scripted(fail, extras, jnp.asarray),
                           jax.random.PRNGKey(7), JC.CampaignConfig(**kw),
                           batched=True, name=what)
    assert (got.n_trials, got.failures) == (want.n_trials, want.failures)
    assert got.extras == want.extras
    assert got.ci == want.ci and got.p_hat == want.p_hat
    assert got.ci_halfwidth == want.ci_halfwidth
    assert got.describe() == want.describe()
    for model in (0.25, 0.3, 0.35):
        assert got.contains(model) == want.contains(model)
    if what == "early stop":
        assert got.n_trials < kw["max_trials"]
    if what == "budget not a batch multiple":
        assert got.n_trials == 1000
    assert got.seconds > 0 and got.peak_bytes is None


@needs_jax
@pytest.mark.parametrize("k,n,z", [(0, 10, 1.96), (3, 4096, 2.576),
                                   (50000, 1 << 20, 2.576), (7, 7, 1.0),
                                   (0, 0, 1.96)])
def test_wilson_interval_identical(k, n, z):
    assert TC.wilson_interval(k, n, z) == JC.wilson_interval(k, n, z)


@needs_jax
def test_sweep_labels_match_jax():
    points = [{"p_input": 1e-4, "T": 8}, {"p_gate": 3e-5},
              {"p": 0.25, "name": "x", "k": 3}]
    cfg = dict(batch_size=16, max_trials=32, min_trials=16)

    def t_make(**pt):
        return lambda g, n: torch.zeros(n, dtype=torch.bool)

    def j_make(**pt):
        return lambda k, n: jnp.zeros(n, bool)

    got = TC.sweep(t_make, points, 1, TC.CampaignConfig(**cfg), batched=True,
                   device="cpu")
    want = JC.sweep(j_make, points, jax.random.PRNGKey(1),
                    JC.CampaignConfig(**cfg), batched=True)
    assert [r.name for _, r in got] == [r.name for _, r in want]
    assert [pt for pt, _ in got] == points
    got_s = TC.sweep_schemes(lambda s: t_make(), standard_grid(), 1,
                             TC.CampaignConfig(**cfg), batched=True,
                             device="cpu")
    want_s = JC.sweep_schemes(lambda s: j_make(), j_standard_grid(),
                              jax.random.PRNGKey(1),
                              JC.CampaignConfig(**cfg), batched=True)
    assert [r.name for _, r in got_s] == [r.name for _, r in want_s]


def test_derive_seed_is_a_64_bit_mix():
    seeds = [TC.derive_seed(2021, i) for i in range(4096)]
    assert len(set(seeds)) == 4096
    assert all(0 <= s < 2**64 for s in seeds)
    assert TC.derive_seed(2021, 5) == TC.derive_seed(2021, 5)
    assert TC.derive_seed(2021, 5) != TC.derive_seed(2022, 5)
    assert TC.derive_seed(-1, 0) != TC.derive_seed(0, 0)
    # the bits look uniform: each of the 64 bit lanes is set about half of
    # the time (4096 seeds: sd 0.008 a lane)
    lanes = np.array([[(s >> b) & 1 for b in range(64)] for s in seeds])
    assert np.abs(lanes.mean(0) - 0.5).max() < 0.05


def _bernoulli(p):
    def trial(g, n):
        return torch.rand(n, generator=g, device=g.device) < p
    return trial


def test_bernoulli_campaign_lands_in_its_interval():
    cfg = TC.CampaignConfig(batch_size=1000, max_trials=20000,
                            min_trials=2000, ci_halfwidth=0.01, z=2.576)
    res = TC.run_campaign(_bernoulli(0.3), 11, cfg, batched=True,
                          name="bern", device="cpu")
    assert res.contains(0.3)
    assert res.ci_halfwidth <= 0.01 and res.n_trials < 20000


def test_same_seed_replays_and_batches_differ():
    cfg = TC.CampaignConfig(batch_size=64, max_trials=640)
    draws = []

    def trial(g, n):
        x = torch.rand(n, generator=g)
        draws.append(x)
        return x < 0.5, {"sum": x}

    a = TC.run_campaign(trial, 3, cfg, batched=True, device="cpu")
    first = draws[:]
    b = TC.run_campaign(trial, 3, cfg, batched=True, device="cpu")
    assert (a.failures, a.extras) == (b.failures, b.extras)
    assert all(torch.equal(x, y) for x, y in zip(first, draws[len(first):]))
    # batch b's generator is seeded derive_seed(seed, b): all distinct
    assert len({tuple(x.tolist()) for x in first}) == len(first) == 10
    g = torch.Generator().manual_seed(TC.derive_seed(3, 4))
    assert torch.equal(first[4], torch.rand(64, generator=g))
    c = TC.run_campaign(trial, 4, cfg, batched=True, device="cpu")
    assert (c.failures, c.extras) != (a.failures, a.extras)


def test_sweep_points_draw_from_distinct_generators():
    cfg = TC.CampaignConfig(batch_size=256, max_trials=512)
    out = TC.sweep(lambda p: _bernoulli(p), [{"p": 0.5}] * 3, 9, cfg,
                   batched=True, device="cpu")
    fails = [r.failures for _, r in out]
    assert len(set(fails)) == 3          # the same point, other draws
    again = TC.run_campaign(_bernoulli(0.5), TC.derive_seed(9, 1), cfg,
                            batched=True, name="p=0.5", device="cpu")
    assert again.failures == fails[1]    # point i replays alone


def test_unbatched_trials_run_on_their_own_generators():
    cfg = TC.CampaignConfig(batch_size=50, max_trials=120)
    seen = []

    def trial(g):
        x = torch.rand((), generator=g)
        seen.append(float(x))
        return x < 0.3, {"x": x}

    res = TC.run_campaign(trial, 5, cfg, device="cpu")
    assert res.n_trials == 120 and len(seen) == 120
    # trial j of batch b: derive_seed(derive_seed(seed, b), j)
    for b, j in ((0, 0), (1, 7), (2, 19)):
        g = torch.Generator().manual_seed(
            TC.derive_seed(TC.derive_seed(5, b), j))
        assert seen[b * 50 + j] == float(torch.rand((), generator=g))
    assert res.failures == sum(x < 0.3 for x in seen)
    assert res.extras["x"] == pytest.approx(sum(seen), rel=1e-6)


def test_trial_shape_is_checked():
    cfg = TC.CampaignConfig(batch_size=8, max_trials=8)
    with pytest.raises(ValueError):
        TC.run_campaign(lambda g, n: torch.zeros(n + 1, dtype=torch.bool), 0,
                        cfg, batched=True, device="cpu")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the campaigns' CUDA generators")
    return torch.device("cuda")


@pytest.mark.gpu
def test_campaign_on_cuda_generators():
    dev = _cuda()
    cfg = TC.CampaignConfig(batch_size=1 << 16, max_trials=1 << 18,
                            z=2.576)
    a = TC.run_campaign(_bernoulli(0.3), 1, cfg, batched=True)
    b = TC.run_campaign(_bernoulli(0.3), 1, cfg, batched=True, device=dev)
    assert a.contains(0.3) and (a.failures, a.n_trials) == (b.failures,
                                                           b.n_trials)
    assert a.peak_bytes is not None and a.peak_bytes > 0 and a.seconds > 0
    c = TC.run_campaign(_bernoulli(0.3), 2, cfg, batched=True)
    assert c.failures != a.failures
