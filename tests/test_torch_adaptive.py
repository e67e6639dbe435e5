"""The port's adaptive scrub (`repro_torch.runtime.AdaptiveScrub`,
`obs.DriftDetector`, `ContinuousBatcher(adaptive=)` and ``serve
--adaptive-scrub``) against the JAX package's.

Identical on the same `record` / `observe` sequences (seeded numpy
streams: quiet, stormy and mixed, with and without a drift detector):
every interval, the scheduled next scrub, the history and the summaries;
`DriftStatus` field by field; the priors `from_prior` and
`from_trajectory`.  The batcher on the phi3-mini smoke config (2 layers,
fp32 compute) under the same deterministic `corrupt_page` hook: its scrub
ticks, the controller's history, every request's tokens and every counter
equal the reference's; a fixed-cadence run replayed on the recorded
schedule (`forced_scrub_ticks`) scrubs at the same ticks."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.analytics import ScrubTrajectory as JTrajectory
from repro.launch.batching import BatchSpec as JSpec
from repro.launch.batching import ContinuousBatcher as JBatcher
from repro.launch.batching import Request as JRequest
from repro.launch.engine import fetch_telemetry as j_fetch
from repro.models import params as JP
from repro.models import transformer as JT
from repro.obs.drift import DriftDetector as JDetector
from repro.reliability import parse_scheme as j_parse
from repro.runtime.adaptive import AdaptiveScrub as JAdaptive
from repro.runtime.adaptive import AdaptiveScrubConfig as JConfig
from repro_torch.configs import get_config as port_config
from repro_torch.faults import RetentionDrift
from repro_torch.core.analytics import ScrubTrajectory
from repro_torch.launch import serve
from repro_torch.launch.batching import BatchSpec, ContinuousBatcher, Request
from repro_torch.models.params import from_numpy
from repro_torch.obs import DriftDetector, fetch_telemetry
from repro_torch.reliability import parse_scheme
from repro_torch.runtime import AdaptiveScrub, AdaptiveScrubConfig


def _stream(kind, seed, n=80):
    """(corrected, uncorrectable) per scrub: quiet, storm, or mixed."""
    rng = np.random.default_rng(seed)
    if kind == "quiet":
        c = rng.poisson(0.2, n)
    elif kind == "storm":
        c = rng.poisson(9.0, n)
    else:
        c = np.concatenate([rng.poisson(0.1, n // 3), rng.poisson(12.0, n // 3),
                            rng.poisson(1.5, n - 2 * (n // 3))])
    u = (rng.random(n) < (0.05 if kind != "quiet" else 0.0)).astype(int)
    return [(int(a), int(b)) for a, b in zip(c, u)]


KINDS = ["quiet", "storm", "mixed"]
CFGS = [{}, dict(interval0=8, min_interval=2, max_interval=64,
                 low_events=1.0, high_events=6.0, patience=2)]


def _replay(ctl, stream):
    """Drive a controller the way the batcher does: scrub at due ticks."""
    tick, out = 0, []
    for c, u in stream:
        while not ctl.due(tick):
            tick += 1
        out.append(ctl.record(tick, c, u, parity_fixed=1))
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cfg", CFGS, ids=["default", "tight"])
@pytest.mark.parametrize("detector", [False, True])
def test_controller_schedule_matches_jax(kind, seed, cfg, detector):
    stream = _stream(kind, seed)
    det = DriftDetector(1e-4, 2048, window=8) if detector else None
    jdet = JDetector(1e-4, 2048, window=8) if detector else None
    ctl = AdaptiveScrub(AdaptiveScrubConfig(**cfg), detector=det)
    jctl = JAdaptive(JConfig(**cfg), detector=jdet)
    assert _replay(ctl, stream) == _replay(jctl, stream)
    assert ctl.history == jctl.history
    assert ctl.summary() == jctl.summary()
    assert ctl.next_due == jctl.next_due
    if detector:
        assert dataclasses.asdict(det.status()) == \
            dataclasses.asdict(jdet.status())
    cfg_ = AdaptiveScrubConfig(**cfg)
    assert all(cfg_.min_interval <= i <= cfg_.max_interval
               for i in ctl.summary()["intervals"])


@pytest.mark.parametrize("p_bit", [0.0, 1e-9, 1e-7, 1e-5, 1e-3])
@pytest.mark.parametrize("n_blocks", [1, 4096, 3_788_800])
def test_from_prior_matches_jax(p_bit, n_blocks):
    for kw in ({}, dict(interval0=4, max_interval=512),
               dict(target_events=0.5)):
        a = AdaptiveScrub.from_prior(p_bit, n_blocks, **kw)
        b = JAdaptive.from_prior(p_bit, n_blocks, **kw)
        assert dataclasses.asdict(a.cfg) == dataclasses.asdict(b.cfg)
        assert a.next_due == b.next_due


@pytest.mark.parametrize("kind", KINDS)
def test_from_trajectory_and_detector_replay_match_jax(kind):
    traj, jtraj = ScrubTrajectory(n_blocks=512), JTrajectory(n_blocks=512)
    for i, (c, u) in enumerate(_stream(kind, 3, n=40)):
        traj.add(5 * i + 2, c, 0, u)
        jtraj.add(5 * i + 2, c, 0, u)
    a = AdaptiveScrub.from_trajectory(traj, max_interval=256)
    b = JAdaptive.from_trajectory(jtraj, max_interval=256)
    assert dataclasses.asdict(a.cfg) == dataclasses.asdict(b.cfg)
    for p in (0.0, 1e-6, 1e-4):
        (d, s), (jd, js) = DriftDetector.from_trajectory(traj, p, window=16), \
            JDetector.from_trajectory(jtraj, p, window=16)
        assert dataclasses.asdict(s) == dataclasses.asdict(js)
        assert s.as_dict() == js.as_dict()
        assert d.evidence() == jd.evidence()
        assert d.confident == jd.confident


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("p_bit", [0.0, 1e-6, 1e-4])
def test_detector_statuses_match_jax(kind, p_bit):
    det, jdet = DriftDetector(p_bit, 1000, window=12, min_events=4.0), \
        JDetector(p_bit, 1000, window=12, min_events=4.0)
    assert det.expected_per_scrub == jdet.expected_per_scrub
    for c, u in _stream(kind, 4, n=50):
        assert dataclasses.asdict(det.observe(c, u)) == \
            dataclasses.asdict(jdet.observe(c, u))
        assert det.confident == jdet.confident


def test_config_validation_matches_jax():
    for kw in (dict(interval0=0), dict(min_interval=8, interval0=4),
               dict(interval0=2048), dict(low_events=5.0, high_events=1.0),
               dict(patience=0)):
        with pytest.raises(ValueError):
            AdaptiveScrubConfig(**kw)
        with pytest.raises(ValueError):
            JConfig(**kw)
    with pytest.raises(ValueError):
        DriftDetector(-1.0, 10)


# -- the batcher under the adaptive controller --------------------------------

SPEC = dict(slots=2, page_tokens=8, chunk=2, prompt_buckets=(8,),
            gen_cap=8)


@pytest.fixture(scope="module")
def setup():
    tweak = dict(n_layers=2, compute_dtype="float32")
    cfg_j = get_config("phi3-mini-3.8b").smoke().replace(**tweak)
    cfg = port_config("phi3-mini-3.8b").smoke().replace(**tweak)
    jparams = JP.materialize(jax.random.PRNGKey(0), JT.model_specs(cfg_j))
    prompts = np.random.RandomState(0).randint(0, cfg.vocab, size=(4, 8)
                                               ).astype(np.int32)
    return cfg_j, cfg, jparams, jax.tree.map(np.asarray, jparams), prompts


def _requests(R, prompts):
    return [R(i, prompts[i], g, arrival_s=0.0)
            for i, g in enumerate((8, 5, 8, 3))]


def _hook(storm_ticks, words):
    """Deterministic pool corruption: at tick t flip one bit in each of
    `storm_ticks[t]` distinct pages, at one of their first `words`
    words."""
    def hook(b):
        for j in range(storm_ticks.get(b.ticks, 0)):
            b.pool.corrupt_page(1 + (b.ticks + j) % b.spec.pool_pages,
                                bit=(3 * j + b.ticks) % 32,
                                word=(97 * j) % words)
    return hook


@pytest.mark.parametrize("name", ["ecc", "hsiao-wb", "ecc+tmr-parallel"])
def test_batcher_adaptive_schedule_matches_jax(setup, name):
    cfg_j, cfg, jparams, params_np, prompts = setup
    ctl_cfg = dict(interval0=2, min_interval=1, max_interval=8,
                   low_events=0.5, high_events=3.0, patience=2)
    storm = {t: (6 if 3 <= t < 6 else 0) for t in range(40)}
    jb = JBatcher(cfg_j, j_parse(name), JSpec(**SPEC),
                  adaptive=JAdaptive(JConfig(**ctl_cfg)))
    jprep = jb.prepare(jparams, key=jax.random.PRNGKey(0))
    jb.on_tick = _hook(storm, SPEC["page_tokens"])
    jres = jb.run(_requests(JRequest, prompts))
    jstats = j_fetch({**jprep, **jb.telemetry()})

    b = ContinuousBatcher(cfg, parse_scheme(name), BatchSpec(**SPEC),
                          adaptive=AdaptiveScrub(AdaptiveScrubConfig(
                              **ctl_cfg)), device="cpu")
    prep = b.prepare(from_numpy(params_np))
    b.on_tick = _hook(storm, SPEC["page_tokens"])
    res = b.run(_requests(Request, prompts))
    stats = fetch_telemetry({**prep, **b.telemetry()})

    assert b.scrub_ticks == jb.scrub_ticks and len(b.scrub_ticks) > 2
    assert b.adaptive.history == jb.adaptive.history
    assert len(set(i for _, _, i in b.adaptive.history)) > 1   # it moved
    assert b.ticks == jb.ticks
    for r, j in zip(res, jres):
        assert r.rid == j.rid
        np.testing.assert_array_equal(r.tokens, np.asarray(j.tokens))
    assert sorted(stats) == sorted(jstats)
    for k in stats:
        np.testing.assert_array_equal(stats[k], np.asarray(jstats[k]),
                                      err_msg=k)
    assert int(stats["ecc_corrected"]) + int(
        stats.get("ecc_read_corrected", 0)) > 0

    # replay the recorded schedule on a fixed-cadence batcher
    rb = ContinuousBatcher(cfg, parse_scheme(name), BatchSpec(**SPEC),
                           scrub_every=3, forced_scrub_ticks=b.scrub_ticks,
                           device="cpu")
    rb.prepare(from_numpy(params_np))
    rb.on_tick = _hook(storm, SPEC["page_tokens"])
    rres = rb.run(_requests(Request, prompts))
    assert rb.scrub_ticks == b.scrub_ticks
    for r, j in zip(rres, res):
        np.testing.assert_array_equal(r.tokens, j.tokens)


def test_forced_schedule_beats_the_controller(setup):
    cfg = setup[1]
    ctl = AdaptiveScrub(AdaptiveScrubConfig(interval0=1))
    b = ContinuousBatcher(cfg, parse_scheme("ecc"), BatchSpec(**SPEC),
                          adaptive=ctl, forced_scrub_ticks=[2, 5],
                          device="cpu")

    def due(n):
        out = []
        for t in range(n):
            b.ticks = t
            if b._scrub_due():
                out.append(t)
        return out
    assert due(8) == [2, 5]
    b._forced_scrub = None                        # the controller's turn
    assert due(4) == [1, 2, 3]
    b.adaptive = None                             # the fixed interval's
    b.scrub_every = 2
    assert due(5) == [0, 2, 4]


def test_serve_adaptive_scrub_sizes_the_prior_for_the_pool(setup):
    """``serve --adaptive-scrub``: the controller is `from_prior(p_bit,
    pool blocks, interval0=scrub_every)`, the reference's sizing."""
    cfg = setup[1]
    spec = BatchSpec(**SPEC)
    params = from_numpy(setup[3])
    out = serve.serve_server(cfg, params, parse_scheme("hsiao-wb"),
                             spec=spec, requests=3, rate=100.0, p_bit=1e-6,
                             fault="drift", scrub_every=4,
                             adaptive_scrub=True, realtime=False,
                             device="cpu")
    b = out["batcher"]
    want = JAdaptive.from_prior(1e-6, b.pool.arena_spec.n_blocks,
                                interval0=4)
    got = AdaptiveScrub.from_prior(1e-6, b.pool.arena_spec.n_blocks,
                                   interval0=4)
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    assert b.adaptive is not None
    assert [t for t, _, _ in b.adaptive.history] == b.scrub_ticks
    off = serve.serve_server(cfg, params, parse_scheme("off"), spec=spec,
                             requests=1, rate=100.0, adaptive_scrub=True,
                             realtime=False, device="cpu")
    assert off["batcher"].adaptive is None        # no code, no controller


def test_serve_adaptive_quiet_then_storm_replays_bit_for_bit(setup):
    """The shape of the card's adaptive-server check at the smoke width:
    the pool is quiet for the first three served ticks, then drifts every
    tick at a rate well above `high_events`.  The interval doubles after
    `patience` quiet scrubs and halves at the first storm scrub; the
    recorded schedule replayed through ``serve_server(forced_scrub_ticks=)``
    under the same exposure scrubs at the same ticks and gives the same
    tokens and counters."""
    cfg = setup[1]
    spec = BatchSpec(**SPEC)
    params = from_numpy(setup[3])

    def run(**kw):
        g = torch.Generator().manual_seed(9)
        storm = []

        def expose(b):
            storm.append(len(storm) >= 3)
            if storm[-1]:                  # about 40 flips a tick
                p = 40.0 / (b.pool.words.numel() * 32 * spec.chunk)
                b.pool.corrupt(g, RetentionDrift(p), dt=spec.chunk)
        out = serve.serve_server(cfg, params, parse_scheme("hsiao-wb"),
                                 spec=spec, requests=6, rate=100.0,
                                 scrub_every=1, on_tick=expose,
                                 realtime=False, device="cpu", **kw)
        return out, storm

    out, storm = run(adaptive_scrub=True)
    b = out["batcher"]
    c = b.adaptive.cfg
    ticks = [t for t, _, _ in b.adaptive.history]
    events = [e for _, e, _ in b.adaptive.history]
    intervals = [i for _, _, i in b.adaptive.history]
    prev = [c.interval0] + intervals[:-1]
    assert ticks == b.scrub_ticks and sum(storm) >= 2
    doubled = [k for k in range(len(ticks))
               if intervals[k] == 2 * prev[k] and k + 1 >= c.patience
               and max(events[k + 1 - c.patience:k + 1]) < c.low_events]
    halved = [k for k in range(len(ticks))
              if intervals[k] < prev[k] and events[k] > c.high_events]
    assert doubled and halved and doubled[0] < halved[0], \
        b.adaptive.history
    assert int(out["stats"]["ecc_uncorrectable"]) == 0

    replay, _ = run(forced_scrub_ticks=ticks)
    assert replay["batcher"].scrub_ticks == ticks
    for r, j in zip(replay["results"], out["results"]):
        assert r.rid == j.rid
        np.testing.assert_array_equal(r.tokens, j.tokens)
    assert sorted(replay["stats"]) == sorted(out["stats"])
    for k, v in out["stats"].items():
        np.testing.assert_array_equal(replay["stats"][k], v, err_msg=k)
