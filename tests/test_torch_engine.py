"""The port's GenerationEngine against the JAX package's on the phi3-mini
smoke config (2 layers, d_model 128): the same parameters (through
`from_numpy`), the same prompt and the same fault masks (drawn by JAX under
the engine's ``fold_in(key, 100 + copy)`` convention) under every serving
scheme.  The prepared store, greedy tokens and every telemetry counter
must be identical; prefill logits agree within 1e-4 -- both sides compute
in float32 (`compute_dtype="float32"`) and differ only in the summation
order of their matmul and softmax kernels.  On the mamba2-130m and
recurrentgemma-2b smoke configs (weights at std 0.02), `--vote-cache`
votes every leaf of their nested caches, with tokens and vote counters
equal to the reference's."""
import dataclasses

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
from repro.models.steps import make_prefill_step as j_prefill_step
from repro.reliability import parse_scheme as j_parse
from repro_torch.configs import get_config as get_port_config
from repro_torch.core import arena
from repro_torch.core import tree as T
from repro_torch.faults import FaultModel
from repro_torch.launch.engine import GenerationEngine, fetch_telemetry
from repro_torch.models import transformer as port_transformer
from repro_torch.models.params import from_numpy
from repro_torch.models.steps import make_prefill_step
from repro_torch.reliability import parse_scheme

B, PROMPT, GEN = 2, 8, 5
#: 1e-6: a few flips per copy, every scheme recovers the clean tokens;
#: 8e-6: unprotected copies diverge (NaN logits -> token 0) and the TMR
#: copies disagree, so the in-loop token and KV-cache votes take effect
P_BITS = (1e-6, 8e-6)
LOGIT_TOL = 1e-4

torch.backends.cuda.matmul.allow_tf32 = False


class JaxMasks(FaultModel):
    """Hands the port the word masks JAX drew, in corruption order."""

    def __init__(self, masks):
        self.masks = list(masks)

    def word_mask(self, generator, words, dt=1.0):
        m = self.masks.pop(0)
        assert m.shape == tuple(words.shape)
        return torch.from_numpy(m.view(np.int32).copy())


def _cfg():
    return get_config("phi3-mini-3.8b").smoke().replace(
        n_layers=2, compute_dtype="float32")


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    key = jax.random.PRNGKey(0)
    jparams = JP.materialize(key, JT.model_specs(cfg))
    params_np = jax.tree.map(np.asarray, jparams)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab, size=(B, PROMPT)).astype(np.int32)
    return cfg, key, jparams, params_np, tokens


def _engine_masks(fault, key, jparams, copies):
    """The masks JAX's `prepare` applies: copy i under fold_in(key,
    100 + i), leaf j under split(., n_leaves)[j]."""
    leaves = jax.tree.leaves(jparams)
    out = []
    for i in range(copies):
        ks = jax.random.split(jax.random.fold_in(key, 100 + i), len(leaves))
        out += [np.asarray(fault.word_mask(k, jarena.leaf_to_words(x)))
                for k, x in zip(ks, leaves)]
    return out


def _port_config(cfg_j):
    """The port's own phi3 smoke config; it carries the JAX one's fields
    unchanged."""
    cfg = get_port_config("phi3-mini-3.8b").smoke().replace(
        n_layers=2, compute_dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    return cfg


SCHEMES = [("off", {}), ("ecc", {}), ("tmr-serial", {}),
           ("tmr-parallel", dict(vote_every=2, vote_cache=True)),
           ("ecc+tmr", {})]


@pytest.mark.parametrize("p_bit", P_BITS)
@pytest.mark.parametrize("spec,kw", SCHEMES, ids=[s for s, _ in SCHEMES])
def test_engine_matches_jax(setup, spec, kw, p_bit):
    cfg_j, key, jparams, params_np, tokens = setup
    cfg = _port_config(cfg_j)
    fault = JFlips(p_bit)
    copies = 3 if "tmr" in spec else 1

    jeng = JEngine(cfg_j, j_parse(spec), gen=GEN, **kw)
    jstore, jprep = jeng.prepare(jparams, key=key, fault=fault)
    jtok, jtel = jeng.generate(jstore, {"tokens": jnp.asarray(tokens)})
    jstats = j_fetch({**jprep, **jtel})

    eng = GenerationEngine(cfg, parse_scheme(spec), gen=GEN, device="cpu",
                           **kw)
    masks = JaxMasks(_engine_masks(fault, key, jparams, copies))
    store, prep = eng.prepare(from_numpy(params_np), fault=masks)
    assert not masks.masks
    tok, tel = eng.generate(store, {"tokens": torch.from_numpy(tokens)})
    stats = fetch_telemetry({**prep, **tel})

    # the prepared (corrupted, scrubbed) store, bit for bit
    words, _ = arena.words_of(store, copies=3 if copies == 3 else 0)
    jwords = [np.asarray(jarena.pack(
        jax.tree.map(lambda x, i=i: x[i], jstore) if copies == 3
        else jstore)[0]).view(np.int32) for i in range(copies)]
    np.testing.assert_array_equal(words.numpy().reshape(copies, -1),
                                  np.stack(jwords))

    assert tok.dtype == torch.int32 and tuple(tok.shape) == (B, GEN)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert sorted(stats) == sorted(jstats)
    for k in stats:
        np.testing.assert_array_equal(stats[k], np.asarray(jstats[k]),
                                      err_msg=k)
    if "ecc" in spec:
        assert stats["ecc_corrected"] > 0

    # prefill logits of (the first copy of) the store
    first = T.map_tree(lambda x: x[0], store) if copies == 3 else store
    jfirst = jax.tree.map(lambda x: x[0], jstore) if copies == 3 else jstore
    _, logits, _ = make_prefill_step(cfg)(first,
                                          {"tokens": torch.from_numpy(tokens)})
    _, jlogits, _ = j_prefill_step(cfg_j)(jfirst,
                                          {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_loop_matches_scan_without_in_loop_votes(setup):
    cfg_j, _, _, params_np, tokens = setup
    cfg = _port_config(cfg_j)
    eng = GenerationEngine(cfg, parse_scheme("tmr-parallel"), gen=GEN,
                           device="cpu")
    store, _ = eng.prepare(from_numpy(params_np))
    batch = {"tokens": torch.from_numpy(tokens)}
    scan, tel = eng.generate_scan(store, batch)
    loop, _ = eng.generate_loop(store, batch)
    assert torch.equal(scan, loop)
    assert tel["tmr_step_disagreements"].shape == (GEN,)


def test_engine_rejects_votes_without_concurrent_copies():
    cfg = _port_config(_cfg())
    with pytest.raises(ValueError):
        GenerationEngine(cfg, parse_scheme("ecc"), gen=2, vote_every=2,
                         device="cpu")
    with pytest.raises(ValueError):
        GenerationEngine(cfg, parse_scheme("tmr-serial"), gen=2,
                         vote_every=2, device="cpu")
    with pytest.raises(ValueError):
        GenerationEngine(cfg, parse_scheme("tmr-parallel"), gen=2,
                         vote_cache=True, device="cpu")


def test_cache_specs_match_jax():
    cfg_j = _cfg()
    want = JT.cache_specs(cfg_j, batch=3, cache_len=17)
    got = port_transformer.cache_specs(_port_config(cfg_j), 3, 17)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].shape == want[k].shape and got[k].init == want[k].init


#: the recurrent families, whose decode caches nest: {pos, ssm: {conv,
#: state}} and {pos, k, v, rg: {conv, h}}; a 36-token prompt is past the
#: hybrid smoke config's window of 32 (so its ring is the reference's) and
#: not a multiple of the SSD chunk of 16
FAMILY_ARCHS = {"ssm": "mamba2-130m", "hybrid": "recurrentgemma-2b"}
FAMILY_PROMPT = 36


def _family_params(cfg, seed=0, std=0.02):
    """numpy weights (zeros and ones as the specs say, else normal(0,
    std)): the reference's fan-in init of the stacked leaves would make
    the untrained copies' tokens hang on rounding."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: np.full(s.shape, {"zeros": 0.0, "ones": 1.0}.get(
            s.init, 0.0), np.float32) if s.init in ("zeros", "ones")
        else (std * rng.standard_normal(s.shape)).astype(np.float32),
        JT.model_specs(cfg), is_leaf=lambda x: isinstance(x, JP.Spec))


#: (family, scheme, p_bit): without ECC, rates at which one copy's tokens
#: leave the others' (at 4e-6 the hybrid smoke model's copies all turn
#: to NaN logits, token 0, and agree again)
FAMILY_RUNS = [("ssm", "ecc+tmr-parallel", 1e-6),
               ("ssm", "tmr-parallel", 3e-5),
               ("hybrid", "ecc+tmr-parallel", 1e-6),
               ("hybrid", "tmr-parallel", 2e-6)]


@pytest.mark.parametrize("family,spec,p_bit", FAMILY_RUNS,
                         ids=[f"{f}-{s}" for f, s, _ in FAMILY_RUNS])
def test_engine_votes_nested_caches_as_jax(family, spec, p_bit):
    """Every leaf of the nested caches (the fp32 SSM state and RG-LRU h,
    the conv tails, the hybrid's K/V ring, the position) is voted every 2
    steps: tokens and every vote counter equal the reference's, which
    votes by a tree map over the cache."""
    cfg_j = get_config(FAMILY_ARCHS[family]).smoke().replace(
        compute_dtype="float32")
    cfg = get_port_config(FAMILY_ARCHS[family]).smoke().replace(
        compute_dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    key = jax.random.PRNGKey(0)
    params_np = _family_params(cfg_j)
    jparams = jax.tree.map(jnp.asarray, params_np)
    tokens = np.random.RandomState(1).randint(
        0, cfg.vocab, size=(B, FAMILY_PROMPT)).astype(np.int32)
    fault = JFlips(p_bit)
    kw = dict(vote_every=2, vote_cache=True)

    jeng = JEngine(cfg_j, j_parse(spec), gen=GEN, **kw)
    jstore, jprep = jeng.prepare(jparams, key=key, fault=fault)
    jtok, jtel = jeng.generate(jstore, {"tokens": jnp.asarray(tokens)})
    jstats = j_fetch({**jprep, **jtel})

    eng = GenerationEngine(cfg, parse_scheme(spec), gen=GEN, device="cpu",
                           **kw)
    masks = JaxMasks(_engine_masks(fault, key, jparams, 3))
    store, prep = eng.prepare(from_numpy(params_np), fault=masks)
    assert not masks.masks
    tok, tel = eng.generate(store, {"tokens": torch.from_numpy(tokens)})
    stats = fetch_telemetry({**prep, **tel})

    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert sorted(stats) == sorted(jstats)
    for k in stats:
        np.testing.assert_array_equal(stats[k], np.asarray(jstats[k]),
                                      err_msg=k)
    if spec == "tmr-parallel":
        # the copies differ, so the votes had something to repair
        assert int(stats["tmr_step_disagreements"].sum()) > 0


@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_cache_vote_reaches_every_leaf(family, monkeypatch):
    """With a vote every step, each of the three copies' cache leaves is
    handed to the voter once per step: positions, K/V and the nested
    recurrent states alike."""
    cfg = get_port_config(FAMILY_ARCHS[family]).smoke().replace(
        compute_dtype="float32")
    eng = GenerationEngine(cfg, parse_scheme("tmr-parallel"), gen=3,
                           vote_every=1, vote_cache=True, device="cpu")
    seen = []
    real = eng._tmr()._vote()

    def spy(a, b, c, out=None):
        seen.append(tuple(a.shape))
        return real(a, b, c, out=out)

    monkeypatch.setattr(type(eng._tmr()), "_vote", lambda self: spy)
    store, _ = eng.prepare(from_numpy(_family_params(
        get_config(FAMILY_ARCHS[family]).smoke())))
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab, size=(B, FAMILY_PROMPT)).astype(np.int32))
    eng.generate(store, {"tokens": tokens})
    # prefill's cache of copy 0 gives the leaves' shapes
    _, _, cache = make_prefill_step(cfg, FAMILY_PROMPT + 3)(
        T.map_tree(lambda x: x[0], store), {"tokens": tokens})
    leaves = [tuple(x.shape) for x in T.leaves(cache)]
    assert len(leaves) == (3 if family == "ssm" else 5)
    # per step: the token vote, then one vote per cache leaf; last, the
    # final sequences' vote
    assert seen == ([(B, 1)] + leaves) * 2 + [(B, 3)]
