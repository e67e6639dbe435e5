"""The port's mMPU cost model (`repro_torch.costmodel`,
`configs.mmpu_paper`, `Scheme.cost_events`, the engine's
`mmpu_projection` and `experiments.tmr_tradeoff`) against the JAX
package's.

Identical, field by field: device specs, the netlist schedules' and every
scheme's step event streams, their `dump_jsonl` text, the packed arrays
and `StepProfile.from_model_config` for phi3-mini at full width (shapes
only, nothing allocated) and at the smoke width.  Folds and
`evaluate_grid` agree within RTOL = 1e-6: the port folds in float64, the
reference in float32 (x64 off), so the totals differ by float32 rounding.
The reference benchmark's assertions hold on the port's numbers: the
ordering off < ecc < tmr-* < ecc+tmr and the agreement with
`overhead()`."""
import dataclasses
import io

import numpy as np
import pytest
import torch

from repro import costmodel as jcm
from repro.configs import get_config as j_config
from repro.configs import mmpu_paper as jmp
from repro.core import multpim as jmult
from repro.core import scheduler as jsched
from repro.core.tmr import TMR_COSTS as J_TMR_COSTS
from repro.launch.engine import GenerationEngine as JEngine
from repro.reliability import Tmr as JTmr
from repro.reliability import standard_grid as j_grid
from repro_torch import costmodel as cm
from repro_torch.configs import get_config
from repro_torch.configs import mmpu_paper as mp
from repro_torch.core import multpim, scheduler
from repro_torch.experiments import tmr_tradeoff
from repro_torch.launch.engine import GenerationEngine, fetch_telemetry
from repro_torch.reliability import parse_scheme, standard_grid

#: float32 (reference) against float64 (port) fold totals
RTOL = 1e-6
DEVICES = sorted(mp.DEVICES)


def _dicts(stream):
    return [e.to_dict() for e in stream]


def _jsonl(stream, mod):
    buf = io.StringIO()
    n = mod.dump_jsonl(stream, buf)
    assert n == len(tuple(stream))
    return buf.getvalue()


def _close(port, ref):
    for f in ("latency_cycles", "occupancy_cycles", "energy_pj"):
        np.testing.assert_allclose(getattr(port, f), getattr(ref, f),
                                   rtol=RTOL, err_msg=f)
    assert (port.tokens, port.clock_hz, port.n_events) == \
        (ref.tokens, ref.clock_hz, ref.n_events)


@pytest.mark.parametrize("name", DEVICES)
def test_device_specs_match_jax(name):
    port, ref = mp.get_device(name), jmp.get_device(name)
    assert port.to_dict() == ref.to_dict()
    assert port.cycle_vector() == ref.cycle_vector()
    assert port.energy_vector() == ref.energy_vector()
    for w in (0, 1, 1023, 1024, 1025, 10**9):
        assert port.row_issues(w) == ref.row_issues(w)
    assert cm.spec_from_dict(port.to_dict()) == port
    assert cm.EVENT_KINDS == jcm.EVENT_KINDS
    with pytest.raises(KeyError):
        mp.get_device("nope")


@pytest.mark.parametrize("n_bits", [4, 8, 16])
@pytest.mark.parametrize("trials,n_out,load", [(1, 0, True),
                                               (1024, 16, True),
                                               (3000, 8, False)])
def test_lower_schedule_matches_jax(n_bits, trials, n_out, load):
    spec, jspec = mp.get_device("paper"), jmp.get_device("paper")
    sch = scheduler.schedule(multpim.multiplier_netlist(n_bits))
    jsch = jsched.schedule(jmult.multiplier_netlist(n_bits))
    port = cm.lower_schedule(sch, spec, trials=trials, n_outputs=n_out,
                             load_inputs=load)
    ref = jcm.lower_schedule(jsch, jspec, trials=trials, n_outputs=n_out,
                             load_inputs=load)
    assert _dicts(port) == _dicts(ref)
    assert _jsonl(port, cm) == _jsonl(ref, jcm)


@pytest.mark.parametrize("name", DEVICES)
@pytest.mark.parametrize("mac_bits", [8, 16])
def test_mac_kernel_events_match_jax(name, mac_bits):
    assert _dicts(cm.mac_kernel_events(mac_bits, mp.get_device(name))) == \
        _dicts(jcm.mac_kernel_events(mac_bits, jmp.get_device(name)))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("batch", [1, 4])
def test_step_profile_from_model_config_matches_jax(smoke, batch):
    cfg, jcfg = get_config("phi3-mini-3.8b"), j_config("phi3-mini-3.8b")
    if smoke:
        cfg, jcfg = cfg.smoke(), jcfg.smoke()
    port = cm.StepProfile.from_model_config(cfg, batch=batch)
    ref = jcm.StepProfile.from_model_config(jcfg, batch=batch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.n_blocks == ref.n_blocks
    if not smoke:
        assert port.weight_words == 3_821_472_768


def _profiles():
    return [("phi3", dict(cfg="full", batch=4)),
            ("smoke", dict(cfg="smoke", batch=2)),
            ("hand", dict(weight_words=1 << 16, macs_per_token=1 << 20,
                          tokens=1, mac_bits=8))]


def _profile(mod, getcfg, kw):
    if "cfg" in kw:
        cfg = getcfg("phi3-mini-3.8b")
        if kw["cfg"] == "smoke":
            cfg = cfg.smoke()
        return mod.StepProfile.from_model_config(cfg, batch=kw["batch"])
    return mod.StepProfile(**kw)


@pytest.mark.parametrize("pname,kw", _profiles(), ids=[p for p, _ in
                                                       _profiles()])
@pytest.mark.parametrize("device", DEVICES)
def test_scheme_streams_and_folds_match_jax(pname, kw, device):
    spec, jspec = mp.get_device(device), jmp.get_device(device)
    prof, jprof = _profile(cm, get_config, kw), _profile(jcm, j_config, kw)
    grid, jgrid = standard_grid(include_hsiao=True), \
        j_grid(include_hsiao=True)
    for s, js in zip(grid, jgrid):
        assert s.name == js.name
        port, ref = cm.lower_step(s, prof, spec), jcm.lower_step(js, jprof,
                                                                 jspec)
        assert _dicts(port) == _dicts(ref), s.name
        assert _jsonl(port, cm) == _jsonl(ref, jcm)
        pa, ra = cm.EventArrays.from_events(port), \
            jcm.EventArrays.from_events(ref)
        for f in ("kind", "count", "cells", "xbars", "weight"):
            np.testing.assert_array_equal(getattr(pa, f), getattr(ra, f))
        scaled, jscaled = cm.scale_stream(port, 32), jcm.scale_stream(ref, 32)
        assert _dicts(scaled) == _dicts(jscaled)
        _close(cm.fold(scaled, spec, tokens=4 * 32, device="cpu"),
               jcm.fold(jscaled, jspec, tokens=4 * 32))
    costs = cm.evaluate_grid(grid, prof, spec, device="cpu")
    jcosts = jcm.evaluate_grid(jgrid, jprof, jspec)
    assert list(costs) == list(jcosts)
    for name in costs:
        _close(costs[name], jcosts[name])
        assert costs[name].describe().split("(")[-1] == \
            jcosts[name].describe().split("(")[-1]


def test_jsonl_round_trip_and_stack():
    spec = mp.get_device("paper")
    prof = cm.StepProfile(weight_words=1000, macs_per_token=5000, tokens=2)
    streams = [cm.lower_step(s, prof, spec) for s in standard_grid()]
    buf = io.StringIO()
    cm.dump_jsonl(streams[-1], buf)
    buf.seek(0)
    assert cm.load_jsonl(buf) == streams[-1]
    stacked = cm.stack_streams(streams)
    jstacked = jcm.stack_streams([jcm.lower_step(s, jcm.StepProfile(
        weight_words=1000, macs_per_token=5000, tokens=2),
        jmp.get_device("paper")) for s in j_grid()])
    for a, b in zip(stacked, jstacked):
        for f in ("kind", "count", "cells", "xbars", "weight"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    _close(cm.project_macs(10**6, 4096, spec, tokens=3, device="cpu"),
           jcm.project_macs(10**6, 4096, jmp.get_device("paper"), tokens=3))


def test_benchmark_assertions_hold_at_phi3_width():
    """The reference's `benchmarks/mmpu_cost.py` assertions on the port's
    numbers at phi3-mini's full-width profile (32-bit MACs, batch 4)."""
    spec = mp.get_device("paper")
    prof = cm.StepProfile.from_model_config(get_config("phi3-mini-3.8b"),
                                            batch=4, mac_bits=32)
    costs = cm.evaluate_grid(standard_grid(include_hsiao=True), prof, spec,
                             device="cpu")
    cyc = {n: c.cycles_per_token for n, c in costs.items()}
    eccs = [cyc["ecc"], cyc["hsiao"]]
    tmrs = [v for n, v in cyc.items() if n.startswith("tmr-")]
    joint = [v for n, v in cyc.items() if "+" in n]
    assert cyc["unprotected"] < min(eccs) <= max(eccs) < min(tmrs)
    assert max(tmrs) < min(joint)
    occ = {s.name: s.overhead().latency_x * s.overhead().area_x
           / s.overhead().throughput_x
           for s in standard_grid(include_hsiao=True)}
    assert sorted(cyc, key=cyc.get) == sorted(occ,
                                              key=lambda n: (occ[n], cyc[n]))


def test_tmr_tradeoff_rows_match_the_reference_table():
    """The §V table's rows (all but the wall time) equal the rows
    `benchmarks/tmr_tradeoff.py` derives from the JAX package."""
    rows = tmr_tradeoff.run(device="cpu", walltime=False)
    jdev = jmp.get_device("paper")
    jprof = jcm.StepProfile(weight_words=1 << 16, macs_per_token=1 << 20,
                            tokens=1, mac_bits=8)
    mmpu = jcm.evaluate_grid(j_grid(), jprof, jdev)
    base = jmult.multiplier_netlist(32).n_gates
    want = []
    for s in j_grid():
        proj = mmpu[s.name]
        d = (s.overhead().describe()
             + f" mmpu_cycles_tok={proj.cycles_per_token:.4g}"
             + f" mmpu_pj_tok={proj.energy_pj_per_token:.4g}")
        if isinstance(s, JTmr):
            cyc = {"serial": 3, "parallel": 1,
                   "semi_parallel": 1}[s.discipline] * base + 2 * 64
            paper = J_TMR_COSTS[s.discipline]
            d += (f" sim_latency={cyc / base:.2f}x (paper: "
                  f"{paper.latency_x:.0f}x/{paper.area_x:.0f}x/"
                  f"{paper.throughput_x:.2f}x)")
        want.append((f"tmr_tradeoff.{s.name}", 0.0, d))
    want.append(("tmr_tradeoff.periphery_alternative", 0.0,
                 "latency=1024x (paper: up to 1024x for 1024 rows)"))
    assert rows == want


def test_vote_on_the_crossbar_counts_two_cycles_a_bit():
    g = torch.Generator().manual_seed(0)
    copies = torch.rand(3, 50, 7, generator=g) < 0.5
    voted, cycles = tmr_tradeoff.vote_cycles(copies)
    a, b, c = copies
    assert torch.equal(voted, (a & b) | (a & c) | (b & c))
    assert cycles == 2 * 7


@pytest.mark.parametrize("spec_s", ["off", "ecc", "tmr-parallel",
                                    "ecc+tmr-serial", "hsiao+tmr-semi"])
def test_engine_projection_and_gauges_match_jax(spec_s):
    from repro.reliability import parse_scheme as j_parse
    cfg, jcfg = get_config("phi3-mini-3.8b").smoke(), \
        j_config("phi3-mini-3.8b").smoke()
    spec, jspec = mp.get_device("paper"), jmp.get_device("paper")
    eng = GenerationEngine(cfg, parse_scheme(spec_s), gen=6, device="cpu",
                           cost_spec=spec)
    jeng = JEngine(jcfg, j_parse(spec_s), gen=6, cost_spec=jspec)
    stream, cost = eng.mmpu_projection(3)
    jstream, jcost = jeng.mmpu_projection(3)
    assert _dicts(stream) == _dicts(jstream)
    _close(cost, jcost)
    assert eng.mmpu_projection(3)[0] is stream          # cached
    assert GenerationEngine(cfg, gen=1, device="cpu").mmpu_projection(3) \
        is None
    tokens = torch.zeros((3, 1000), dtype=torch.int32)[:, :6]
    _, telem = eng._finish(tokens, {})
    stats = fetch_telemetry(telem)
    jtel = jeng._finish_telemetry(np.zeros((3, 6), np.int32), {})
    np.testing.assert_allclose(stats["mmpu_cycles_per_token"],
                               float(jtel["mmpu_cycles_per_token"]),
                               rtol=RTOL)
    np.testing.assert_allclose(stats["mmpu_energy_pj_per_token"],
                               float(jtel["mmpu_energy_pj_per_token"]),
                               rtol=RTOL)
    assert int(stats["mmpu_events"]) == int(jtel["mmpu_events"])
    assert int(stats["tokens_emitted"]) == 18


def test_fold_defaults_to_cuda_and_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = mp.get_device("paper")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cm.fold(cm.mac_kernel_events(8, spec), spec)
