"""The port's keyed draws (`repro_torch.core.prng` keys) against the JAX
package's, with no JAX mask fed: given the same seed, every keyed surface
gives the reference's masks, lanes, counters, p_hat and tokens bit for bit.

Covered: each fault model's word masks, bool planes and gate lane masks
(`CompositeFault` and `StuckAtFaults` at p/2 + p/2 included), `corrupt` /
`inject_bit_flips` over a tree with a bf16 leaf, `tmr`, the `Scheme`s'
`corrupt_store`, the engine's `prepare` and the batcher's, `materialize`
and `make_inputs`, a campaign's p_hat and a `sweep`'s points, a netlist
Monte Carlo batch through every engine, `TrainLoop`'s injected masks, and
one end-to-end `smoke()` serve from one `PRNGKey(seed)`.  The generator
routes stay as they are (their own tests)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arena as jarena
from repro.faults import models as jm
from repro_torch.core import arena, prng
from repro_torch.faults import models as tm

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the draws are many small elementwise ops, which
    threads slow down when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(seed):
    return jax.random.PRNGKey(seed), prng.key(seed, CPU)


def _u32(t: torch.Tensor) -> np.ndarray:
    """int32 words (or uint32 values in int64) -> uint32."""
    return t.numpy().astype(np.int64).astype(np.uint32) if \
        t.dtype == torch.int64 else t.numpy().view(np.uint32)


def _words(n, seed):
    return np.random.default_rng(seed).integers(
        0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.int32).copy())


P = 3e-3
MODELS = {
    "bitflip": (jm.TransientBitFlips(P), tm.TransientBitFlips(P)),
    "gate": (jm.TransientGateFaults(P), tm.TransientGateFaults(P)),
    "drift": (jm.RetentionDrift(P), tm.RetentionDrift(P)),
    "stuck": (jm.StuckAtFaults(P / 2, P / 2), tm.StuckAtFaults(P / 2, P / 2)),
    "composite": (
        jm.CompositeFault((jm.RetentionDrift(P), jm.StuckAtFaults(P, P / 3))),
        tm.CompositeFault((tm.RetentionDrift(P), tm.StuckAtFaults(P, P / 3)))),
}


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("seed", [0, 5])
def test_word_masks_match_reference(name, seed):
    jmod, tmod = MODELS[name]
    jk, tk = _key(seed)
    words = _words(1000, seed)
    ref = np.asarray(jmod.word_mask(jk, jnp.asarray(words), 2.0))
    got = tmod.word_mask(tk, _i32(words), 2.0)
    np.testing.assert_array_equal(_u32(got), ref)
    assert ref.any()
    ref_c = np.asarray(jmod.corrupt_words(jnp.asarray(words), jk, 2.0))
    np.testing.assert_array_equal(_u32(tmod.corrupt_words(_i32(words), tk,
                                                          2.0)), ref_c)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bool_planes_match_reference(name):
    jmod, tmod = MODELS[name]
    jk, tk = _key(3)
    bits = np.random.default_rng(3).random((37, 41)) < 0.5
    ref = np.asarray(jmod.corrupt_bits(jnp.asarray(bits), jk))
    got = tmod.corrupt_bits(torch.from_numpy(bits), tk)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref != bits).any()


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("trials", [1, 32, 77])
def test_gate_lane_masks_match_reference(name, trials):
    """Gate g under fold_in(key, g), as the reference's scheduler draws."""
    jmod, tmod = MODELS[name]
    jk, tk = _key(11)
    G = 9
    keys = jax.vmap(lambda g: jax.random.fold_in(jk, g))(jnp.arange(G))
    jkeep, jflip = jax.vmap(lambda k: jmod.gate_lane_masks(k, trials))(keys)
    keep, flip = tmod.gate_lane_masks(tk, G, trials)
    np.testing.assert_array_equal(_u32(flip), np.asarray(jflip))
    np.testing.assert_array_equal(_u32(keep.contiguous()), np.asarray(jkeep))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal(9).astype(np.float32),
                  "d": rng.standard_normal((3, 3)).astype(np.float32)}}


@pytest.mark.parametrize("name", ["bitflip", "stuck", "composite"])
@pytest.mark.parametrize("bf16", [False, True])
def test_corrupt_tree_matches_reference(name, bf16):
    """One split per leaf; a bf16 leaf through its packed word view."""
    jmod, tmod = MODELS[name]
    jk, tk = _key(21)
    tree = _tree(2)
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = {"a": torch.from_numpy(tree["a"].copy()),
             "b": {"c": torch.from_numpy(tree["b"]["c"].copy()),
                   "d": torch.from_numpy(tree["b"]["d"].copy())}}
    if bf16:
        jtree["b"]["c"] = jtree["b"]["c"].astype(jnp.bfloat16)
        ttree["b"]["c"] = ttree["b"]["c"].to(torch.bfloat16)
    ref = jmod.corrupt(jtree, jk, 1.0)
    tmod.corrupt(ttree, tk, 1.0)
    for path in (("a",), ("b", "c"), ("b", "d")):
        r, t = ref, ttree
        for p in path:
            r, t = r[p], t[p]
        rb = np.asarray(r).view(np.uint16 if bf16 and path == ("b", "c")
                                else np.uint32)
        tb = t.view(torch.int16 if t.dtype == torch.bfloat16
                    else torch.int32).numpy().view(rb.dtype)
        np.testing.assert_array_equal(tb, rb, err_msg=str(path))


def test_inject_bit_flips_matches_reference():
    jk, tk = _key(4)
    tree = _tree(4)
    ref = jm.inject_bit_flips(jax.tree.map(jnp.asarray, tree), jk, 0.01)
    ttree = {"a": torch.from_numpy(tree["a"].copy()),
             "b": {"c": torch.from_numpy(tree["b"]["c"].copy()),
                   "d": torch.from_numpy(tree["b"]["d"].copy())}}
    tm.inject_bit_flips(ttree, tk, 0.01)
    np.testing.assert_array_equal(ttree["a"].numpy().view(np.uint32),
                                  np.asarray(ref["a"]).view(np.uint32))
    np.testing.assert_array_equal(ttree["b"]["d"].numpy().view(np.uint32),
                                  np.asarray(ref["b"]["d"]).view(np.uint32))


def test_word_masks_cross_chunks():
    """A mask wider than a chunk equals the reference's (chunked packing)."""
    jk, tk = _key(9)
    n = 3000
    words = _words(n, 9)
    jmod = jm.StuckAtFaults(0.02, 0.01)
    ref = np.asarray(jmod.word_mask(jk, jnp.asarray(words)))
    t0, t01 = prng.threshold(0.02), prng.threshold(0.03)
    sa0, sa1 = prng.word_plane(tk, n, lambda m: (m < t0,
                                                 (m >= t0) & (m < t01)),
                               step=32 * 7)
    got = (_i32(words) & sa0) | (~_i32(words) & sa1)
    np.testing.assert_array_equal(_u32(got), ref)


def test_skip_is_a_no_op_with_a_key():
    _, tk = _key(0)
    x = {"w": torch.ones(8)}
    tm.TransientBitFlips(0.5).skip(x, tk)
    assert torch.equal(x["w"], torch.ones(8))


# -- stateful logic, the crossbar, the netlist engines -------------------------

def test_stateful_gates_match_reference():
    from repro.core import stateful_logic as jsl
    from repro_torch.core import stateful_logic as tsl
    rng = np.random.default_rng(0)
    a, b, c = (rng.random(300) < 0.5 for _ in range(3))
    jk, tk = _key(7)
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    for name, args in (("g_xor", 2), ("g_and", 2), ("g_maj3", 3),
                       ("g_min3", 3), ("g_nor", 2), ("g_not", 1)):
        for p in (0.05, jm.StuckAtFaults(0.02, 0.03)):
            tp = p if isinstance(p, float) else tm.StuckAtFaults(0.02, 0.03)
            ref = getattr(jsl, name)(*map(jnp.asarray, (a, b, c)[:args]),
                                     jk, p)
            got = getattr(tsl, name)(*(ta, tb, tc)[:args], tk, tp)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                          err_msg=name)


def test_crossbar_matches_reference():
    from repro.core.crossbar import Crossbar as JX
    from repro.core.crossbar import ErrorModel as JE
    from repro_torch.core.crossbar import Crossbar as TX
    from repro_torch.core.crossbar import ErrorModel as TE
    state = np.random.default_rng(1).random((16, 24)) < 0.5
    kw = dict(p_gate=0.05, p_input=0.03, p_retention=0.02)
    jx, tx = JX.from_array(state, JE(**kw)), TX.from_array(state, TE(**kw),
                                                           device="cpu")
    jk, tk = _key(3)
    steps = [("row_gate", ("xor", [0, 1], 2)), ("col_gate", ("maj3", [3, 4, 5],
                                                             6)),
             ("partitioned_row_gate", ("nor", 8, [0, 1], 2)),
             ("write_col", (5, state[:, 0])), ("drift", ())]
    for i, (op, args) in enumerate(steps):
        jki, tki = jax.random.fold_in(jk, i), prng.fold_in(tk, i)
        if op == "write_col":
            jx = jx.write_col(*args, key=jki, p_write=0.1)
            tx = tx.write_col(*args, generator=tki, p_write=0.1)
        else:
            jx = getattr(jx, op)(*args, jki)
            tx = getattr(tx, op)(*args, tki)
        np.testing.assert_array_equal(tx.state.numpy(), np.asarray(jx.state),
                                      err_msg=op)


def _mult_operands(n, n_bits, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**n_bits, n, dtype=np.uint64) for _ in range(2))


@pytest.mark.parametrize("impl", ["scan", "level"])
@pytest.mark.parametrize("model", ["float", "stuck", "composite"])
def test_netlist_monte_carlo_batch_matches_reference(impl, model):
    """A Monte Carlo batch of the 8-bit multiplier: every gate under
    fold_in(key, gid), through the port's gate-serial and levelized
    engines against the reference's levelized engine."""
    from repro.core import multpim as jmp
    from repro_torch.core import multpim as tmp
    a, b = _mult_operands(77, 8, 0)
    jp, tp = {"float": (2e-3, 2e-3),
              "stuck": (jm.StuckAtFaults(1e-3, 1e-3),
                        tm.StuckAtFaults(1e-3, 1e-3)),
              "composite": (
                  jm.CompositeFault((jm.TransientGateFaults(1e-3),
                                     jm.StuckAtFaults(1e-3, 0.0))),
                  tm.CompositeFault((tm.TransientGateFaults(1e-3),
                                     tm.StuckAtFaults(1e-3, 0.0))))}[model]
    jk, tk = _key(13)
    ref = np.asarray(jmp.multiply_bits(jnp.asarray(a.astype(np.uint32)),
                                       jnp.asarray(b.astype(np.uint32)), 8,
                                       key=jk, p_gate=jp))
    got = tmp.multiply_bits(torch.from_numpy(a.astype(np.int64)),
                            torch.from_numpy(b.astype(np.int64)), 8,
                            generator=tk, p_gate=tp, impl=impl)
    np.testing.assert_array_equal(got.numpy(), ref)
    clean = tmp.true_product_bits(torch.from_numpy(a.astype(np.int64)),
                                  torch.from_numpy(b.astype(np.int64)), 8)
    assert (got != clean).any()


def test_tmr_multiplier_matches_reference():
    from repro.core import multpim as jmp
    from repro_torch.core import multpim as tmp
    a, b = _mult_operands(64, 8, 1)
    jk, tk = _key(17)
    ref = np.asarray(jmp.multiply_tmr_bits(
        jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32)),
        8, jk, 3e-3))
    got = tmp.multiply_tmr_bits(torch.from_numpy(a.astype(np.int64)),
                                torch.from_numpy(b.astype(np.int64)), 8, tk,
                                3e-3, impl="level")
    np.testing.assert_array_equal(got.numpy(), ref)


# -- tmr and the schemes ------------------------------------------------------

def test_tmr_wrapper_matches_reference():
    from repro.core.tmr import tmr as jtmr
    from repro_torch.core.tmr import tmr as ttmr
    words = _words(500, 1)
    jfn = jtmr(lambda k, w: jm.TransientBitFlips(0.3).corrupt_words(w, k))
    tfn = ttmr(lambda g, w: tm.TransientBitFlips(0.3).corrupt_words(w, g),
               device="cpu")
    jk, tk = _key(2)
    ref = np.asarray(jfn(jk, jnp.asarray(words)))
    np.testing.assert_array_equal(_u32(tfn(tk, _i32(words))), ref)
    assert (ref != words).any()


SCHEMES = ["off", "ecc", "hsiao", "tmr-parallel", "ecc+tmr-serial",
           "hsiao+tmr-parallel"]


@pytest.mark.parametrize("spec", SCHEMES)
@pytest.mark.parametrize("fault", ["bitflip", "stuck"])
def test_corrupt_store_matches_reference(spec, fault):
    """Copy i under split(key, 3)[i]; the scrub's counters and the read
    payload equal the reference's."""
    from repro.reliability import parse_scheme as j_parse
    from repro_torch.models.params import from_numpy
    from repro_torch.reliability import parse_scheme
    p = {"bitflip": 2e-3, "stuck": 2e-3}[fault]
    jmod, tmod = (MODELS[fault][0].__class__(p), MODELS[fault][1].__class__(
        p)) if fault == "bitflip" else (jm.StuckAtFaults(p / 2, p / 2),
                                        tm.StuckAtFaults(p / 2, p / 2))
    rng = np.random.default_rng(5)
    payload = {"a": rng.standard_normal(600).astype(np.float32),
               "b": rng.standard_normal((4, 50)).astype(np.float32)}
    js, ts = j_parse(spec), parse_scheme(spec)
    jk, tk = _key(8)
    jprot = js.corrupt_store(js.protect(jax.tree.map(jnp.asarray, payload)),
                             jmod, jk)
    tprot = ts.corrupt_store(ts.protect(from_numpy(payload)), tmod, tk)
    jfixed, jrep = js.scrub(jprot)
    tfixed, trep = ts.scrub(tprot)
    assert (int(trep.corrected), int(trep.parity_fixed),
            int(trep.uncorrectable)) == (int(jrep.corrected),
                                         int(jrep.parity_fixed),
                                         int(jrep.uncorrectable))
    jout, tout = js.read(jfixed), ts.read(tfixed)
    for k in ("a", "b"):
        np.testing.assert_array_equal(
            tout[k].numpy().view(np.uint32), np.asarray(jout[k]).view(
                np.uint32), err_msg=k)
    if spec != "off":
        assert int(jrep.corrected) > 0


# -- the engine, the batcher, materialize and make_inputs ---------------------

def _cfgs(arch="phi3-mini-3.8b", **kw):
    import dataclasses
    from repro.configs import get_config
    from repro_torch.configs import get_config as port_config
    cfg_j, cfg = (g(arch).smoke().replace(**kw) for g in (get_config,
                                                           port_config))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    return cfg_j, cfg


def _assert_same_leaves(port_tree, ref_tree):
    from repro_torch.core import tree as T
    leaves, ref = T.leaves(port_tree), jax.tree.leaves(ref_tree)
    assert len(leaves) == len(ref)
    for t, r in zip(leaves, ref):
        np.testing.assert_array_equal(t.numpy().view(np.int32),
                                      np.asarray(r).view(np.int32))


def test_materialize_matches_reference():
    """A split per leaf; normal scaled as the reference scales it (the
    fan-in rule's root too), bit for bit."""
    from repro.models import params as JP
    from repro.models import transformer as JT
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T
    cfg_j, cfg = _cfgs("qwen2.5-14b")
    jk, tk = _key(0)
    ref = JP.materialize(jk, JT.model_specs(cfg_j))
    got = P.materialize(T.model_specs(cfg), tk, "float32", CPU)
    _assert_same_leaves(got, ref)


def test_make_inputs_takes_one_key():
    """The prompts and the stub modality inputs under the one unsplit key,
    as the reference's serve driver draws them."""
    from repro_torch.launch.serve import make_inputs
    for arch, name in (("llama-3.2-vision-11b", "vis_emb"),
                       ("seamless-m4t-medium", "enc_emb")):
        cfg_j, cfg = _cfgs(arch)
        jk, tk = _key(6)
        out = make_inputs(cfg, 2, 12, tk, "cpu")
        np.testing.assert_array_equal(
            out["tokens"].numpy(),
            np.asarray(jax.random.randint(jk, (2, 12), 0, cfg.vocab)))
        shape = tuple(out["modality"][name].shape)
        ref = np.asarray(jax.random.normal(jk, shape, np.float32))
        np.testing.assert_array_equal(
            out["modality"][name].numpy().view(np.int32), ref.view(np.int32))


@pytest.fixture(scope="module")
def engine_setup():
    from repro.models import params as JP
    from repro.models import transformer as JT
    cfg_j, cfg = _cfgs(n_layers=2, compute_dtype="float32")
    key = jax.random.PRNGKey(0)
    jparams = JP.materialize(key, JT.model_specs(cfg_j))
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab, size=(2, 8)).astype(np.int32)
    return cfg_j, cfg, jparams, jax.tree.map(np.asarray, jparams), tokens


ENGINE_RUNS = [("ecc+tmr-parallel", "stuck"), ("tmr-serial", "bitflip"),
               ("hsiao", "drift")]


@pytest.mark.parametrize("spec,fault", ENGINE_RUNS)
def test_engine_prepare_matches_reference(engine_setup, spec, fault):
    """Copy i under fold_in(key, 100 + i): stores, counters and tokens."""
    from repro.launch.engine import GenerationEngine as JEngine
    from repro.launch.engine import fetch_telemetry as j_fetch
    from repro.reliability import parse_scheme as j_parse
    from repro_torch.launch.engine import GenerationEngine, fetch_telemetry
    from repro_torch.models.params import from_numpy
    from repro_torch.reliability import parse_scheme
    cfg_j, cfg, jparams, params_np, tokens = engine_setup
    p = 2e-6
    jf, tf = {"bitflip": (jm.TransientBitFlips(p), tm.TransientBitFlips(p)),
              "drift": (jm.RetentionDrift(p), tm.RetentionDrift(p)),
              "stuck": (jm.StuckAtFaults(p / 2, p / 2),
                        tm.StuckAtFaults(p / 2, p / 2))}[fault]
    jk, tk = _key(3)
    jeng = JEngine(cfg_j, j_parse(spec), gen=4)
    jstore, jprep = jeng.prepare(jparams, key=jk, fault=jf)
    jtok, jtel = jeng.generate(jstore, {"tokens": jnp.asarray(tokens)})
    jstats = j_fetch({**jprep, **jtel})
    eng = GenerationEngine(cfg, parse_scheme(spec), gen=4, device="cpu")
    store, prep = eng.prepare(from_numpy(params_np), generator=tk, fault=tf)
    tok, tel = eng.generate(store, {"tokens": torch.from_numpy(tokens)})
    stats = fetch_telemetry({**prep, **tel})
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert sorted(stats) == sorted(jstats)
    for k in stats:
        np.testing.assert_array_equal(stats[k], np.asarray(jstats[k]),
                                      err_msg=k)
    copies = 3 if "tmr" in spec else 1
    words, _ = arena.words_of(store, copies=3 if copies == 3 else 0)
    for i in range(copies):
        jw = jarena.pack(jax.tree.map(lambda x, i=i: x[i], jstore)
                         if copies == 3 else jstore)[0]
        w = words[i] if copies == 3 else words
        np.testing.assert_array_equal(w.numpy(),
                                      np.asarray(jw).view(np.int32))
    if "ecc" in spec or "hsiao" in spec:
        assert int(stats["ecc_corrected"]) > 0


@pytest.mark.parametrize("name,exposure", [("ecc", "inject_scrub")])
def test_batcher_prepare_and_pool_match_reference(engine_setup, name,
                                                  exposure):
    """The batcher's prepare under a key, and the pool's exposure each tick
    under fold_in(tick key, tick): tokens and counters."""
    from repro.launch.batching import BatchSpec as JSpec
    from repro.launch.batching import ContinuousBatcher as JBatcher
    from repro.launch.batching import Request as JRequest
    from repro.launch.engine import fetch_telemetry as j_fetch
    from repro.reliability import parse_scheme as j_parse
    from repro_torch.launch.batching import (BatchSpec, ContinuousBatcher,
                                             Request)
    from repro_torch.models.params import from_numpy
    from repro_torch.obs import fetch_telemetry
    from repro_torch.reliability import parse_scheme
    cfg_j, cfg, jparams, params_np, _ = engine_setup
    spec = dict(slots=2, page_tokens=8, chunk=3, prompt_buckets=(4, 8),
                gen_cap=6)
    rs = np.random.RandomState(0)
    prompts = {n: rs.randint(0, cfg.vocab, size=n).astype(np.int32)
               for n in (4, 8)}

    def reqs(R):
        return [R(0, prompts[8], 6, arrival_s=0.0),
                R(1, prompts[4], 2, arrival_s=0.0),
                R(9, prompts[8], 5, arrival_s=0.1)]

    jk, tk = _key(0)
    jtick, ttick = _key(1)
    jpool, tpool = jm.TransientBitFlips(2e-5), tm.TransientBitFlips(2e-5)
    jb = JBatcher(cfg_j, j_parse(name), JSpec(**spec), scrub_every=2)
    jprep = jb.prepare(jparams, key=jk, fault=jm.TransientBitFlips(1e-6))
    jb.on_tick = lambda b: getattr(b.pool, exposure)(
        jax.random.fold_in(jtick, b.ticks), jpool)
    jres = jb.run(reqs(JRequest))
    jstats = j_fetch({**jprep, **jb.telemetry()})
    b = ContinuousBatcher(cfg, parse_scheme(name), BatchSpec(**spec),
                          scrub_every=2, device="cpu")
    prep = b.prepare(from_numpy(params_np), generator=tk,
                     fault=tm.TransientBitFlips(1e-6))
    b.on_tick = lambda b: getattr(b.pool, exposure)(
        prng.fold_in(ttick, b.ticks), tpool)
    res = b.run(reqs(Request))
    stats = fetch_telemetry({**prep, **b.telemetry()})
    for r, j in zip(res, jres):
        assert r.rid == j.rid
        np.testing.assert_array_equal(r.tokens, np.asarray(j.tokens))
    assert sorted(stats) == sorted(jstats)
    for k in stats:
        np.testing.assert_array_equal(stats[k], np.asarray(jstats[k]),
                                      err_msg=k)


# -- campaigns ----------------------------------------------------------------

def _bern_trials(p):
    def jb(k, n):
        f = jax.random.bernoulli(k, p, (n,))
        return f, {"hits": f.astype(jnp.int32) * 2}

    def tb(g, n):
        f = prng.bernoulli(g, p, (n,))
        return f, {"hits": f.to(torch.int32) * 2}
    return jb, tb


@pytest.mark.parametrize("batched", [True, False])
def test_campaign_matches_reference(batched):
    """Batch b under fold_in(key, b), trials under split of that (when not
    batched); early stop included: the same n, failures, p_hat, extras."""
    from repro.faults import CampaignConfig as JCfg
    from repro.faults import run_campaign as j_run
    from repro_torch.faults import CampaignConfig, run_campaign
    kw = dict(batch_size=64, max_trials=640, min_trials=128,
              ci_halfwidth=0.06)
    jk, tk = _key(12)
    if batched:
        jtrial, ttrial = _bern_trials(0.3)
    else:
        jtrial = lambda k: jax.random.bernoulli(k, 0.3)       # noqa: E731
        ttrial = lambda g: prng.bernoulli(g, 0.3, ())          # noqa: E731
    ref = j_run(jtrial, jk, JCfg(**kw), batched=batched)
    got = run_campaign(ttrial, tk, CampaignConfig(**kw), batched=batched,
                       device="cpu")
    assert (got.n_trials, got.failures) == (ref.n_trials, ref.failures)
    assert got.p_hat == ref.p_hat and got.extras == ref.extras
    assert got.n_trials < 640       # stopped early, as the reference did


def test_sweep_points_match_reference():
    from repro.faults import CampaignConfig as JCfg
    from repro.faults import sweep as j_sweep
    from repro_torch.faults import CampaignConfig, sweep
    points = [{"p": 0.05}, {"p": 0.2}, {"p": 0.6}]
    jk, tk = _key(19)
    ref = j_sweep(lambda p: _bern_trials(p)[0], points, jk,
                  JCfg(batch_size=50, max_trials=200), batched=True)
    got = sweep(lambda p: _bern_trials(p)[1], points, tk,
                CampaignConfig(batch_size=50, max_trials=200), batched=True,
                device="cpu")
    for (pt, r), (jpt, jr) in zip(got, ref):
        assert pt == jpt and r.name == jr.name
        assert (r.failures, r.n_trials, r.extras) == (jr.failures,
                                                      jr.n_trials, jr.extras)


def test_fig4_trials_match_reference_benchmark():
    """campaign_mc's keyed multiplication and NN trials against the
    reference benchmark's (32-bit multiplier): the same failures."""
    from benchmarks import campaign_mc as JCM
    from repro_torch.experiments import campaign_mc as CM
    if JCM.N_BITS != 32:
        pytest.skip("the reference benchmark runs in smoke mode")
    jk, tk = _key(23)
    ref = np.asarray(JCM.make_mult_trial(2e-4)(jk, 64))
    got = CM.make_mult_trial(2e-4, n_bits=32)(tk, 64)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.any()
    ref = np.asarray(JCM.make_nn_trial(1e-4)(jk, 8))
    got = CM.make_nn_trial(1e-4, 32, JCM.M_SCALED, JCM.P_MASK_SCALED)(tk, 8)
    np.testing.assert_array_equal(got.numpy(), ref)


# -- the training loop --------------------------------------------------------

@pytest.mark.parametrize("spec,fault", [("ecc", None), ("tmr-parallel", None),
                                        ("ecc+tmr-parallel", "stuck")])
def test_train_loop_injection_matches_reference(tmp_path, spec, fault):
    """`inject_keyed`: each interval's faults under the reference's
    `_inject_key` (a stable key for a permanent model): every scrub's
    counters and the final params."""
    from repro.reliability import parse_scheme as j_parse
    from repro_torch.reliability import parse_scheme
    from test_torch_train_loop import _jax_toy_loop, _toy_loop
    jkw = dict(total=8, n=256, scrub_every=2, max_scrub_restores=0,
               inject_p_bit=2e-3)
    tkw = dict(jkw, inject_keyed=True)
    if fault == "stuck":
        jkw["fault_model"] = jm.StuckAtFaults(1e-3, 1e-3)
        tkw["fault_model"] = tm.StuckAtFaults(1e-3, 1e-3)
    loop = _toy_loop(tmp_path / "port", scheme=parse_scheme(spec), **tkw)
    ref = _jax_toy_loop(tmp_path / "ref", scheme=j_parse(spec), **jkw)
    loop.attach_scheme()
    ref.attach_scheme()
    out, jout = loop.run(), ref.run()
    assert len(loop.scrub_reports) == len(ref.scrub_reports) == 4
    for (s, r), (js, jr) in zip(loop.scrub_reports, ref.scrub_reports):
        assert s == js
        assert (int(r.corrected), int(r.parity_fixed), int(r.uncorrectable)) \
            == (int(jr.corrected), int(jr.parity_fixed),
                int(jr.uncorrectable)), (spec, s)
    assert sum(int(r.corrected) for _, r in loop.scrub_reports) > 0
    assert out["scrub"] == jout["scrub"]
    np.testing.assert_array_equal(loop.state["params"]["w"].numpy(),
                                  np.asarray(ref.state["params"]["w"]))


# -- one end-to-end serve from one PRNGKey(seed) ------------------------------

@pytest.mark.parametrize("spec", ["ecc+tmr-parallel"])
def test_serve_main_path_matches_reference(spec):
    """The reference serve driver's main path at `smoke()` (its default
    arch, qwen2.5-14b) from one `PRNGKey(seed)`: params, prompts, the
    prepared store's fault masks, the scrub counters and the tokens.  The
    port takes `make_inputs` with the key and the engine with the key; its
    params are the reference's bits, none is carried across.  Compute is
    fp32, as in the port's other token cross-checks: the smoke config's
    bf16 matmuls round differently in the two frameworks."""
    from repro.launch.engine import GenerationEngine as JEngine
    from repro.launch.engine import fetch_telemetry as j_fetch
    from repro.models import params as JP
    from repro.models import transformer as JT
    from repro.reliability import parse_scheme as j_parse
    from repro_torch.launch.engine import GenerationEngine, fetch_telemetry
    from repro_torch.launch.serve import make_inputs
    from repro_torch.models.params import from_numpy
    from repro_torch.reliability import parse_scheme
    cfg_j, cfg = _cfgs("qwen2.5-14b", compute_dtype="float32")
    seed, batch, prompt_len, gen, p_bit = 5, 2, 16, 8, 1e-5
    jk = jax.random.PRNGKey(seed)
    jparams = JP.materialize(jk, JT.model_specs(cfg_j))
    jtokens = jax.random.randint(jk, (batch, prompt_len), 0, cfg_j.vocab)
    jeng = JEngine(cfg_j, j_parse(spec), gen=gen)
    jstore, jprep = jeng.prepare(jparams, key=jk,
                                 fault=jm.TransientBitFlips(p_bit))
    jtok, jtel = jeng.generate(jstore, {"tokens": jtokens})
    jstats = j_fetch({**jprep, **jtel})

    tk = prng.key(seed, CPU)
    inputs = make_inputs(cfg, batch, prompt_len, tk, "cpu")
    np.testing.assert_array_equal(inputs["tokens"].numpy(),
                                  np.asarray(jtokens))
    _assert_same_leaves(inputs["params"], jparams)
    params = inputs["params"]
    eng = GenerationEngine(cfg, parse_scheme(spec), gen=gen, device="cpu")
    store, prep = eng.prepare(params, generator=tk,
                              fault=tm.TransientBitFlips(p_bit))
    tok, tel = eng.generate(store, {"tokens": inputs["tokens"]})
    stats = fetch_telemetry({**prep, **tel})
    copies = 3 if "tmr" in spec else 1
    words, _ = arena.words_of(store, copies=3 if copies == 3 else 0)
    for i in range(copies):
        jw = jarena.pack(jax.tree.map(lambda x, i=i: x[i], jstore)
                         if copies == 3 else jstore)[0]
        w = words[i] if copies == 3 else words
        np.testing.assert_array_equal(w.numpy(),
                                      np.asarray(jw).view(np.int32))
    assert sorted(stats) == sorted(jstats)
    for k in stats:
        np.testing.assert_array_equal(stats[k], np.asarray(jstats[k]),
                                      err_msg=k)
    assert int(stats["ecc_corrected"]) > 0
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("arch,name", [("llama-3.2-vision-11b", "vis_emb"),
                                       ("seamless-m4t-medium", "enc_emb")])
def test_train_build_with_a_key(arch, name):
    """`train.build(key=)` as the reference's `build` from PRNGKey(seed):
    its params, and step s's modality input under fold_in(key, s); the
    loop draws its faults from keys."""
    from repro.models import params as JP
    from repro.models import transformer as JT
    from repro_torch.launch import train
    cfg_j, _ = _cfgs(arch)
    args = train.parser().parse_args(["--device", "cpu", "--arch", arch,
                                      "--smoke", "--steps", "2", "--batch",
                                      "2", "--seq", "32", "--seed", "3"])
    jk, tk = _key(3)
    _, loop, _ = train.build(args, key=tk)
    assert loop.cfg.inject_keyed
    _assert_same_leaves(loop.state["params"],
                        JP.materialize(jk, JT.model_specs(cfg_j)))
    for step in (0, 5):
        got = loop.batch_at(step)[name]
        ref = jax.random.normal(jax.random.fold_in(jk, step),
                                tuple(got.shape), jnp.float32)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(ref).view(np.int32))
