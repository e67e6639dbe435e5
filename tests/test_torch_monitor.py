"""The port's heartbeat monitor (`repro_torch.runtime.monitor`),
`obs.ScrubMetrics` and `AdaptiveScrub(feed_detector=)` against the JAX
package's, on the same seeded step-time and scrub-count sequences: every
decision, flag and summary field equal."""
import numpy as np
import pytest

from repro.obs import DriftDetector as JDetector
from repro.obs import ScrubMetrics as JScrubMetrics
from repro.runtime import HeartbeatMonitor as JMonitor
from repro.runtime import StragglerPolicy as JPolicy
from repro.runtime.adaptive import AdaptiveScrub as JAdaptive
from repro.runtime.monitor import Decision as JDecision
from repro_torch.obs import DriftDetector, ScrubMetrics
from repro_torch.runtime import (AdaptiveScrub, Decision, HeartbeatMonitor,
                                 StragglerPolicy)


def _summary(m):
    out = dict(m.summary())
    out.pop("drift", None)
    return out


def test_straggler_flags_and_checkpoint_decision():
    mon = HeartbeatMonitor(StragglerPolicy(window=8, slow_factor=2.0,
                                           max_consecutive_slow=3))
    for _ in range(8):
        assert mon.record_step(0.1) == Decision.CONTINUE
    assert mon.record_step(0.5) == Decision.CONTINUE
    assert mon.record_step(0.5) == Decision.CONTINUE
    assert mon.record_step(0.5) == Decision.CHECKPOINT_NOW
    assert mon.summary()["n_flags"] == 3
    assert (Decision.CONTINUE, Decision.CHECKPOINT_NOW, Decision.RESTART) \
        == (JDecision.CONTINUE, JDecision.CHECKPOINT_NOW, JDecision.RESTART)


@pytest.mark.parametrize("seed", range(3))
def test_step_decisions_match_reference(seed):
    rng = np.random.default_rng(seed)
    times = np.where(rng.random(200) < 0.2, rng.uniform(0.3, 1.0, 200),
                     rng.uniform(0.09, 0.11, 200))
    kw = dict(window=16, slow_factor=2.0, max_consecutive_slow=2)
    mon, ref = HeartbeatMonitor(StragglerPolicy(**kw)), JMonitor(JPolicy(**kw))
    for t in times:
        assert mon.record_step(float(t)) == ref.record_step(float(t))
    assert mon.flags == ref.flags
    assert mon.median() == ref.median()


@pytest.mark.parametrize("drift", [False, True])
def test_scrub_records_match_reference(drift):
    rng = np.random.default_rng(7)
    mon = HeartbeatMonitor(drift=DriftDetector(1e-6, 4096) if drift else None)
    ref = JMonitor(drift=JDetector(1e-6, 4096) if drift else None)
    for i in range(60):
        rec = dict(corrected=int(rng.poisson(4 if i < 30 else 40)),
                   parity_fixed=int(rng.poisson(0.3)),
                   uncorrectable=int(rng.random() < 0.05),
                   injected=1, vote_disagreements=int(rng.poisson(0.5)))
        assert mon.record_scrub(ScrubMetrics(**rec)) \
            == ref.record_scrub(JScrubMetrics(**rec))
    assert mon.flags == ref.flags
    assert mon.summary() == ref.summary()
    assert mon.summary()["uncorrectable"] > 0


def test_scrub_metrics_from_fetched_matches_reference():
    stats = {"ecc_corrected": np.int64(5), "ecc_parity_fixed": 1,
             "ecc_uncorrectable": np.array(2), "ecc_injected": 7,
             "tmr_final_disagreements": np.array(3),
             "tmr_step_disagreements": np.array([1, 0, 2])}
    assert ScrubMetrics.from_fetched(stats) == ScrubMetrics(
        **vars(JScrubMetrics.from_fetched(stats)))
    assert ScrubMetrics.from_fetched({}) == ScrubMetrics(corrected=0)


def test_heartbeat_ok_and_summary_keys():
    mon = HeartbeatMonitor()
    assert mon.heartbeat_ok() and mon.median() is None
    assert _summary(mon).keys() == _summary(JMonitor()).keys()


@pytest.mark.parametrize("feed", [True, False])
def test_adaptive_feed_detector_matches_reference(feed):
    """`feed_detector=False` leaves the shared detector to its other
    consumer: the monitor feeds it, the controller only reads its verdict
    (as `TrainLoop.attach_scheme` arms them)."""
    rng = np.random.default_rng(11)
    det = DriftDetector(1e-6, 2048, window=128)
    jdet = JDetector(1e-6, 2048, window=128)
    ctl = AdaptiveScrub.from_prior(1e-6, 2048, detector=det,
                                   feed_detector=feed, interval0=8)
    ref = JAdaptive.from_prior(1e-6, 2048, detector=jdet,
                               feed_detector=feed, interval0=8)
    mon, jmon = HeartbeatMonitor(drift=det), JMonitor(drift=jdet)
    step = 0
    for _ in range(40):
        step = ctl.next_due
        assert ref.next_due == step and ctl.due(step) and ref.due(step)
        c = int(rng.poisson(6.0))
        mon.record_scrub(ScrubMetrics(corrected=c))
        jmon.record_scrub(JScrubMetrics(corrected=c))
        assert ctl.record(step, c) == ref.record(step, c)
    assert ctl.history == ref.history
    assert det.status().as_dict() == jdet.status().as_dict()
    # fed by the monitor alone, or by both: 40 or 80 observations
    assert det.status().n_scrubs == (80 if feed else 40)
