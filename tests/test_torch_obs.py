"""The port's observability layer (repro_torch.obs) against the JAX
package's: the registry's schema (names, kinds, order) and accumulation,
the single-transfer fetch, `Histogram` and `LatencyTimeline` (TTFT, TPOT
samples and percentiles on the same marks) and the tracer's Chrome-trace
and JSONL output."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import SCHEMA as J_SCHEMA
from repro.obs import Histogram as JHistogram
from repro.obs import LatencyTimeline as JTimeline
from repro.obs import MetricsRegistry as JRegistry
from repro_torch.obs import (DEFAULT_REGISTRY, NULL_TRACER, SCHEMA, Histogram,
                             LatencyTimeline, MetricsRegistry, Tracer,
                             fetch_telemetry)


def test_schema_matches_reference():
    assert [(s.name, s.kind) for s in SCHEMA] == \
        [(s.name, s.kind) for s in J_SCHEMA]
    for name in ("ecc_read_corrected", "ecc_read_parity_fixed",
                 "ecc_read_uncorrectable", "ecc_injected"):
        assert DEFAULT_REGISTRY.spec(name).kind == "counter"
    with pytest.raises(KeyError, match="unknown metric"):
        DEFAULT_REGISTRY.spec("made_up")
    with pytest.raises(ValueError):
        MetricsRegistry([SCHEMA[0], SCHEMA[0]])


def test_accumulate_matches_reference():
    names = ["ecc_corrected", "tmr_step_disagreements", "mmpu_events"]
    updates = [{"ecc_corrected": 3, "tmr_step_disagreements": 1,
                "mmpu_events": 7},
               {"ecc_corrected": 5,
                "tmr_step_disagreements": np.asarray([2, 0], np.int32),
                "mmpu_events": 9}]
    reg, jreg = MetricsRegistry(), JRegistry()
    got, want = reg.zeros(names), jreg.zeros(names)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    for u in updates:
        got = reg.accumulate(got, {k: torch.as_tensor(v, dtype=torch.int32)
                                   for k, v in u.items()})
        want = jreg.accumulate(want, {k: jnp.asarray(v, jnp.int32)
                                      for k, v in u.items()})
    fetched, jfetched = reg.fetch(got), jreg.fetch(want)
    assert list(fetched) == list(jfetched)
    for k in fetched:
        np.testing.assert_array_equal(fetched[k], np.asarray(jfetched[k]))
    with pytest.raises(KeyError):
        reg.accumulate(got, {"bogus": 1})


def test_fetch_is_one_transfer_and_keeps_host_values(monkeypatch):
    calls = []
    orig = torch.Tensor.cpu

    def spy(self, *a, **k):
        calls.append(1)
        return orig(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    tel = {"ecc_corrected": torch.tensor(4, dtype=torch.int32),
           "tmr_step_disagreements": torch.tensor([1, 0, 2],
                                                  dtype=torch.int32),
           "tokens_emitted": np.int32(12)}
    out = fetch_telemetry(tel)
    assert len(calls) == 1
    assert int(out["ecc_corrected"]) == 4
    assert out["tmr_step_disagreements"].tolist() == [1, 0, 2]
    assert int(out["tokens_emitted"]) == 12 and list(out) == list(tel)
    with pytest.raises(KeyError):
        fetch_telemetry({"nope": torch.zeros(())})


MARKS = [(0.120, 1), (0.180, 8), (0.245, 8), (0.300, 3), (0.301, 0)]


def _timelines():
    out = []
    for cls in (LatencyTimeline, JTimeline):
        tl = cls()
        tl.begin()
        tl.start = 10.0
        tl.marks = [(10.0 + t, n) for t, n in MARKS]
        out.append(tl)
    return out


def test_latency_timeline_matches_reference():
    tl, jtl = _timelines()
    assert tl.ttft_s == jtl.ttft_s == pytest.approx(0.120)
    np.testing.assert_array_equal(tl.tpot_samples(), jtl.tpot_samples())
    assert len(tl.tpot_samples()) == 19           # token-weighted samples
    assert tl.summary() == jtl.summary()
    assert tl.total_s() == jtl.total_s() and tl.tokens() == jtl.tokens()
    h, jh = tl.histograms(), jtl.histograms()
    for k in h:
        assert h[k].summary() == jh[k].summary()
    with pytest.raises(RuntimeError):
        LatencyTimeline().mark(1)
    assert np.isnan(LatencyTimeline().ttft_s)


@pytest.mark.parametrize("q", [50, 95, 99])
def test_histogram_percentiles_match_reference(q):
    rs = np.random.RandomState(q)
    xs = rs.exponential(0.05, 257)
    h, jh = Histogram(xs[:100]), JHistogram(xs[:100])
    h.extend(xs[100:])
    jh.extend(xs[100:])
    h.record(0.5)
    jh.record(0.5)
    assert h.percentile(q) == jh.percentile(q)
    assert h.summary() == jh.summary()
    assert h.merge(Histogram([1.0])).summary() == \
        jh.merge(JHistogram([1.0])).summary()
    assert Histogram().summary() == {"count": 0}


def test_tracer_writes_chrome_and_jsonl(tmp_path):
    tr = Tracer()
    with tr.trace("serve", requests=3):
        tr.instant("admit", rid=1)
        tr.counter("ticks", 2)
    tr.metrics({"goodput": np.float64(1.5), "counts": np.asarray([1, 2])},
               kind="server")
    tr.write_chrome(str(tmp_path / "t.json"))
    tr.write_jsonl(str(tmp_path / "m.jsonl"), extra=[{"x": np.int32(3)}])
    doc = json.loads((tmp_path / "t.json").read_text())
    phases = sorted(e["ph"] for e in doc["traceEvents"])
    assert phases == ["C", "X", "i"]
    span = next(e for e in doc["traceEvents"] if e["ph"] == "X")
    assert span["name"] == "serve" and span["args"] == {"requests": 3}
    recs = [json.loads(line) for line in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert recs[0]["kind"] == "server" and recs[0]["counts"] == [1, 2]
    assert recs[1] == {"x": 3}
    with NULL_TRACER.trace("nothing"):
        NULL_TRACER.metrics({"a": 1})
    assert NULL_TRACER.events == [] and NULL_TRACER.records == []
