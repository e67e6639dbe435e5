"""The port's chunked one-shot generation (`GenerationEngine.
generate_chunked`, `ttft` and ``serve --chunk``) against the JAX package's,
on the phi3-mini smoke config (2 layers, fp32 compute): the same
parameters (through `from_numpy`), prompt and weight fault masks (drawn by
JAX under the engine's ``fold_in(key, 100 + copy)`` convention, at a rate
where unprotected TMR copies disagree, so the votes matter).

Bit for bit under every `standard_grid()` scheme (and ecc+tmr-parallel)
and ``vote_every`` in {0, 4}: the chunked tokens and every telemetry
counter equal the port's unchunked `generate` and the reference's
`generate_chunked`; the chunk schedule is the reference's `_chunk_sizes`;
the latency timeline has one mark a chunk (the serial discipline's start
at the third copy)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import arena as jarena
from repro.faults import TransientBitFlips as JFlips
from repro.launch.engine import GenerationEngine as JEngine
from repro.launch.engine import fetch_telemetry as j_fetch
from repro.models import params as JP
from repro.models import transformer as JT
from repro.reliability import parse_scheme as j_parse
from repro_torch.configs import get_config as port_config
from repro_torch.faults import FaultModel
from repro_torch.launch import serve
from repro_torch.launch.engine import GenerationEngine, fetch_telemetry
from repro_torch.models.params import from_numpy
from repro_torch.obs import Tracer
from repro_torch.reliability import parse_scheme, standard_grid

B, PROMPT, GEN, CHUNK = 2, 8, 8, 3
#: TMR copies disagree at this rate (engine test), so votes take effect
P_BIT = 8e-6


class JaxMasks(FaultModel):
    def __init__(self, masks):
        self.masks = list(masks)

    def word_mask(self, generator, words, dt=1.0):
        m = self.masks.pop(0)
        assert m.shape == tuple(words.shape)
        return torch.from_numpy(m.view(np.int32).copy())


def _cfgs():
    tweak = dict(n_layers=2, compute_dtype="float32")
    return (get_config("phi3-mini-3.8b").smoke().replace(**tweak),
            port_config("phi3-mini-3.8b").smoke().replace(**tweak))


@pytest.fixture(scope="module")
def setup():
    cfg_j, cfg = _cfgs()
    key = jax.random.PRNGKey(0)
    jparams = JP.materialize(key, JT.model_specs(cfg_j))
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab, size=(B, PROMPT)).astype(np.int32)
    return cfg_j, cfg, key, jparams, jax.tree.map(np.asarray, jparams), \
        tokens


def _masks(key, jparams, copies):
    fault, leaves = JFlips(P_BIT), jax.tree.leaves(jparams)
    out = []
    for i in range(copies):
        ks = jax.random.split(jax.random.fold_in(key, 100 + i), len(leaves))
        out += [np.asarray(fault.word_mask(k, jarena.leaf_to_words(x)))
                for k, x in zip(ks, leaves)]
    return out


def _cases():
    out = []
    for s in standard_grid():
        disc = getattr(getattr(s, "tmr", s), "discipline", None)
        votes = (0, 4) if disc in ("parallel", "semi_parallel") else (0,)
        out += [(s.name, v, False) for v in votes]
    out.append(("ecc+tmr-parallel", 4, True))
    return out


CASES = _cases()


def _spec_of(name):
    return {"unprotected": "off", "tmr-semi-parallel": "tmr-semi",
            "ecc+tmr-serial": "ecc+tmr-serial"}.get(name, name)


def _equal(stats, jstats):
    assert sorted(stats) == sorted(jstats)
    for k in stats:
        np.testing.assert_array_equal(stats[k], np.asarray(jstats[k]),
                                      err_msg=k)


@pytest.mark.parametrize("name,vote_every,vote_cache", CASES,
                         ids=[f"{n}-v{v}{'c' if c else ''}"
                              for n, v, c in CASES])
def test_chunked_matches_unchunked_and_jax(setup, name, vote_every,
                                           vote_cache):
    cfg_j, cfg, key, jparams, params_np, tokens = setup
    spec = _spec_of(name)
    kw = dict(vote_every=vote_every, vote_cache=vote_cache)
    copies = 3 if "tmr" in spec else 1
    batch_j = {"tokens": jnp.asarray(tokens)}

    jeng = JEngine(cfg_j, j_parse(spec), gen=GEN, **kw)
    jstore, jprep = jeng.prepare(jparams, key=key, fault=JFlips(P_BIT))
    jtok, jtel, jtl = jeng.generate_chunked(jstore, batch_j, chunk=CHUNK)
    jstats = j_fetch({**jprep, **jtel})
    jtok_scan = jeng.generate_scan(jstore, batch_j)[0]
    np.testing.assert_array_equal(np.asarray(jtok), np.asarray(jtok_scan))

    eng = GenerationEngine(cfg, parse_scheme(spec), gen=GEN, device="cpu",
                           **kw)
    given = JaxMasks(_masks(key, jparams, copies))
    store, prep = eng.prepare(from_numpy(params_np), fault=given)
    assert not given.masks
    batch = {"tokens": torch.from_numpy(tokens)}
    tok, tel, tl = eng.generate_chunked(store, batch, chunk=CHUNK)
    stats = fetch_telemetry({**prep, **tel})
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    _equal(stats, jstats)
    utok, utel = eng.generate(store, batch)
    assert torch.equal(tok, utok)
    _equal(fetch_telemetry({**prep, **utel}), stats)
    assert [n for _, n in tl.marks] == [n for _, n in jtl.marks]
    assert tl.tokens() == GEN and tl.ttft_s > 0
    if spec.startswith("tmr") and vote_every == 0:
        assert int(stats["tmr_final_disagreements"]) > 0
    # ttft: the prefill's (voted) first token
    assert torch.equal(eng.ttft(store, batch), tok[:, :1])
    np.testing.assert_array_equal(
        np.asarray(jeng.ttft(jstore, batch_j)), tok[:, :1].numpy())


@pytest.mark.parametrize("chunk", [1, 2, 4, 7, 16])
@pytest.mark.parametrize("spec,kw", [("tmr-parallel", dict(vote_every=3)),
                                     ("tmr-serial", {}), ("off", {})])
def test_every_chunk_size_gives_the_unchunked_run(setup, chunk, spec, kw):
    """The offset threading: any chunk size, votes on the unchunked
    schedule (vote_every 3 against chunks of 1 to 16)."""
    _, cfg, key, jparams, params_np, tokens = setup
    copies = 3 if "tmr" in spec else 1
    eng = GenerationEngine(cfg, parse_scheme(spec), gen=GEN, device="cpu",
                           **kw)
    store, prep = eng.prepare(from_numpy(params_np),
                              fault=JaxMasks(_masks(key, jparams, copies)))
    batch = {"tokens": torch.from_numpy(tokens)}
    tracer = Tracer()
    tok, tel, tl = eng.generate_chunked(store, batch, chunk=chunk,
                                        tracer=tracer)
    utok, utel = eng.generate(store, batch)
    assert torch.equal(tok, utok)
    _equal(fetch_telemetry(tel), fetch_telemetry(utel))
    sizes = list(eng._chunk_sizes(chunk))
    assert [n for _, n in tl.marks] == [1] + sizes
    assert sum(sizes) == GEN - 1
    names = [e["name"] for e in tracer.chrome_trace()["traceEvents"]]
    if spec == "tmr-serial":
        assert names.count("serial_decode_chunk") == len(sizes)
        assert "serial_copy0" in names and "serial_copy1" in names
    elif spec == "off":
        assert names.count("decode_chunk") == len(sizes)
    else:
        assert names.count("tmr_decode_chunk") == len(sizes)


@pytest.mark.parametrize("gen", [1, 2, 5, 8, 17, 33])
@pytest.mark.parametrize("chunk", [1, 3, 4, 8])
def test_chunk_sizes_match_jax(setup, gen, chunk):
    cfg_j, cfg = setup[0], setup[1]
    assert list(GenerationEngine(cfg, gen=gen, device="cpu")
                ._chunk_sizes(chunk)) == \
        list(JEngine(cfg_j, gen=gen)._chunk_sizes(chunk))


def test_chunked_refuses_what_the_reference_refuses(setup):
    cfg = setup[1]
    eng = GenerationEngine(cfg, gen=4, device="cpu")
    with pytest.raises(ValueError, match="chunk must be"):
        eng.generate_chunked({}, {"tokens": torch.zeros(1, 1)}, chunk=0)
    loop = GenerationEngine(cfg, gen=4, device="cpu", execution="loop")
    with pytest.raises(ValueError, match="execution='scan'"):
        loop.generate_chunked({}, {"tokens": torch.zeros(1, 1)}, chunk=2)


def test_serve_cli_chunk_fault_mmpu_trace_metrics(tmp_path, capsys):
    """One-shot ``serve`` takes --chunk, --trace, --metrics, --fault and
    the --mmpu-* flags: the event file holds n_events lines, the metrics
    record carries TTFT/TPOT and the mmpu gauges."""
    ev, tr, me = (str(tmp_path / n) for n in ("ev.jsonl", "t.json",
                                              "m.jsonl"))
    serve.main(["--device", "cpu", "--smoke", "--batch", "2",
                "--prompt-len", "8", "--gen", "6", "--scheme",
                "ecc+tmr-parallel", "--vote-every", "2", "--fault",
                "stuckat", "--inject-p-bit", "1e-5", "--chunk", "2",
                "--mmpu-cost", "--mmpu-events", ev, "--trace", tr,
                "--metrics", me])
    out = capsys.readouterr().out
    assert "fault=stuckat" in out and "latency tails (chunk=2)" in out
    assert "mMPU projection (paper-mmpu)" in out
    n_events = int(out.split("mmpu event stream")[1].split("(")[1]
                   .split()[0])
    with open(ev) as f:
        assert sum(1 for _ in f) == n_events
    rec = [json.loads(line) for line in open(me)][-1]
    for k in ("ttft_s", "tpot_p50", "tpot_p95", "mmpu_cycles_per_token",
              "mmpu_events", "ecc_corrected"):
        assert k in rec, k
    assert rec["mmpu_events"] == n_events and rec["chunk"] == 2
    assert rec["agreement"] == 1.0
    names = {e["name"] for e in json.load(open(tr))["traceEvents"]}
    assert {"prepare", "warmup", "generate", "tmr_decode_chunk"} <= names


@pytest.mark.parametrize("argv,msg", [
    (["--chunk", "2", "--engine", "loop"], "--chunk requires"),
    (["--chunk", "-1"], "--chunk must be"),
    (["--fault", "nope"], "invalid choice"),
])
def test_serve_cli_refusals(argv, msg, capsys):
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--smoke"] + argv)
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("kind,cls", [("bitflip", "TransientBitFlips"),
                                      ("stuckat", "StuckAtFaults"),
                                      ("drift", "RetentionDrift")])
def test_fault_flag_mapping_matches_the_reference(kind, cls):
    model = serve.make_fault(kind, 2e-9)
    assert type(model).__name__ == cls
    if kind == "stuckat":
        assert (model.p_stuck0, model.p_stuck1) == (1e-9, 1e-9)
    assert serve.make_fault(kind, 0.0) is None
