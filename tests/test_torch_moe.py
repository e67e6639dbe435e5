"""The port's MoE family (`repro_torch.models.moe`, the transformer's MoE
branch, the train step's per-layer leaves, the engine and the arena on a
tree with ``dense_layers``) against the JAX package's, in fp32:

* dispatch, fed the reference's router probabilities (recorded from an
  eager run of its `moe_apply`): the top-k expert ids, the stable sort
  order, each assignment's destination row and keep flag bit for bit,
  also on a batch whose load on one expert exceeds the capacity C, so
  that assignments drop;
* `moe_apply` on the same weights and inputs: output within 1e-4, the
  Switch aux loss within 1e-6 (phi3.5-moe's and llama4's smoke configs,
  every activation, and the dropping batch);
* `forward`, `prefill` and 8 greedy `decode_step`s of both MoE configs'
  `smoke()` (llama4's has ``moe_every=2`` and the shared expert): tokens
  bit for bit, hidden states and logits within 1e-4, aux within 1e-6;
* one train step (`make_train_step`, clipping out of reach) from the same
  state at weight std 0.02: the loss and aux within 1e-5, the grads
  (recovered from `m` after the first step) within 1e-3 of each leaf's
  largest grad;
* the engine under ``ecc+tmr-parallel`` (in-loop token and cache votes)
  and ``ecc+tmr`` with ``execution="loop"`` on llama4's smoke config and
  JAX's fault masks: the scrubbed store, tokens and counters bit for bit;
* the arena of a tree with ``dense_layers`` equal to the reference's words
  and unpacked back bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import arena as jarena
from repro.faults import TransientBitFlips as JFlips
from repro.launch.engine import GenerationEngine as JEngine
from repro.launch.engine import fetch_telemetry as j_fetch
from repro.models import moe as jmoe
from repro.models import params as JP
from repro.models import transformer as JT
from repro.models.steps import init_train_state as j_init_state
from repro.models.steps import make_train_step as j_train_step
from repro.optim import AdamWConfig as JAdamWConfig
from repro.reliability import parse_scheme as j_parse
from repro_torch.configs import get_config
from repro_torch.core import arena
from repro_torch.core import tree as T
from repro_torch.faults import FaultModel
from repro_torch.launch.engine import GenerationEngine, fetch_telemetry
from repro_torch.models import moe as pmoe
from repro_torch.models.params import from_numpy, train_state_from_reference
from repro_torch.models.steps import _grad_leaves, make_train_step
from repro_torch.optim import AdamWConfig
from repro_torch.reliability import parse_scheme
from test_torch_model_zoo import check_against_reference, numpy_params

PHI = "phi3.5-moe-42b-a6.6b"
LLAMA = "llama4-maverick-400b-a17b"
OUT_TOL, AUX_TOL = 1e-4, 1e-6
UNCLIPPED = 1e3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    kw = {"compute_dtype": "float32", **kw}
    return (jax_config(arch).smoke().replace(**kw),
            get_config(arch).smoke().replace(**kw))


def _moe_inputs(jcfg, seed, skew=0.0, tokens=(2, 32)):
    """numpy MoE-layer weights and inputs.  With `skew`, every token's
    first feature is at least 1 and the router weighs it by `skew` more
    toward expert 0, so that expert 0 takes every token's top pick (the
    other probabilities stay far from underflow, so no two tie)."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda s: (0.05 * rng.standard_normal(s.shape))
                     .astype(np.float32), jmoe.moe_specs(jcfg),
                     is_leaf=lambda v: isinstance(v, JP.Spec))
    x = rng.standard_normal(tokens + (jcfg.d_model,)).astype(np.float32)
    if skew:
        p["router"][0, 0] += skew
        x[..., 0] = np.abs(x[..., 0]) + 1
    return p, x


class _Spy:
    """Stands in for the reference module's `jnp`, recording what its
    argsort and its first `where` (the destination rows) return."""

    def __init__(self, real):
        self.real, self.seen = real, {}

    def __getattr__(self, name):
        return getattr(self.real, name)

    def argsort(self, *a, **k):
        out = self.real.argsort(*a, **k)
        self.seen["order"] = np.asarray(out)
        return out

    def where(self, cond, *a, **k):
        out = self.real.where(cond, *a, **k)
        if "dest" not in self.seen:
            self.seen["keep"] = np.asarray(cond)
            self.seen["dest"] = np.asarray(out)
        return out


def _reference_dispatch(monkeypatch, jcfg, p, x):
    """An eager run of the reference's `moe_apply`, with its router
    probabilities, top-k, order, dest and keep recorded."""
    spy = _Spy(jnp)
    real_top_k = jax.lax.top_k

    def top_k(probs, k):
        vals, idx = real_top_k(probs, k)
        spy.seen.update(probs=np.asarray(probs), gate=np.asarray(vals),
                        idx=np.asarray(idx))
        return vals, idx

    monkeypatch.setattr(jmoe, "jnp", spy)
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    with jax.disable_jit():
        y, aux = jmoe.moe_apply(p, jcfg, jnp.asarray(x))
    monkeypatch.undo()
    return spy.seen, np.asarray(y), float(aux)


@pytest.mark.parametrize("arch,skew", [(PHI, 0.0), (PHI, 4.0),
                                       (LLAMA, 0.0), (LLAMA, 4.0)],
                         ids=["phi", "phi-drops", "llama4", "llama4-drops"])
def test_dispatch_matches_reference(monkeypatch, arch, skew):
    jcfg, cfg = _cfgs(arch)
    p, x = _moe_inputs(jcfg, seed=1, skew=skew)
    seen, _, _ = _reference_dispatch(monkeypatch, jcfg, p, x)
    T_ = x.shape[0] * x.shape[1]
    C = pmoe._capacity(cfg, T_)
    assert C == jmoe._capacity(jcfg, T_)

    probs = torch.from_numpy(seen["probs"].copy())
    gate, idx = pmoe.route(cfg, probs)
    np.testing.assert_array_equal(idx.numpy(), seen["idx"])
    order, sorted_tok, dest, keep = pmoe.dispatch(idx, cfg.moe_experts, C)
    np.testing.assert_array_equal(order.numpy(), seen["order"])
    np.testing.assert_array_equal(sorted_tok.numpy(),
                                  seen["order"] // cfg.moe_topk)
    np.testing.assert_array_equal(keep.numpy(), seen["keep"])
    np.testing.assert_array_equal(dest.numpy(), seen["dest"])
    load = np.bincount(seen["idx"].ravel(), minlength=cfg.moe_experts)
    if skew:
        # expert 0 takes every token: C of them are kept, the rest drop
        assert load[0] == T_ > C
        assert int((~keep).sum()) == load[0] - C
        assert set(dest[~keep].tolist()) == {cfg.moe_experts * C}
    else:
        assert bool(keep.all())


@pytest.mark.parametrize("arch,act,skew", [
    (PHI, "swiglu", 0.0), (PHI, "swiglu", 4.0), (PHI, "geglu", 0.0),
    (PHI, "relu2", 0.0), (PHI, "gelu", 0.0), (LLAMA, "swiglu", 0.0)])
def test_moe_apply_matches_reference(arch, act, skew):
    jcfg, cfg = _cfgs(arch, act=act)
    p, x = _moe_inputs(jcfg, seed=2, skew=skew)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_apply(p, jcfg, x))(p, x)
    y, aux = pmoe.moe_apply(T.map_tree(torch.from_numpy, p), cfg,
                            torch.from_numpy(x))
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_TOL,
                               atol=AUX_TOL)


@pytest.mark.parametrize("arch", [PHI, LLAMA])
def test_moe_smoke_matches_reference(arch):
    aux, jaux = check_against_reference(arch)
    assert aux > 0
    np.testing.assert_allclose(aux, jaux, rtol=AUX_TOL, atol=AUX_TOL)


def _step_grads(m):
    """Grads from a first unclipped step's `m` = (1 - b1) g."""
    return T.map_tree(lambda x: np.asarray(x) / np.float32(
        1 - JAdamWConfig.b1), m)


@pytest.mark.parametrize("arch", [PHI, LLAMA])
def test_train_step_matches_reference(arch):
    jcfg, cfg = _cfgs(arch)
    params = numpy_params(jcfg, seed=3)
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32)
    state = jax.tree.map(np.asarray, j_init_state(
        jax.tree.map(jnp.asarray, params)))
    new, jm = jax.jit(j_train_step(jcfg, JAdamWConfig(clip_norm=UNCLIPPED)))(
        jax.tree.map(jnp.asarray, state), {"tokens": jnp.asarray(tokens)})
    out, m = make_train_step(cfg, AdamWConfig(clip_norm=UNCLIPPED))(
        train_state_from_reference(state),
        {"tokens": torch.from_numpy(tokens)})
    assert float(m["aux"]) > 0
    for k in ("total", "loss", "aux"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    want = _step_grads(new["opt"]["m"])
    got = _step_grads(T.map_tree(lambda t: t.numpy(), out["opt"]["m"]))
    jpaths = [tuple(k.key for k in p) for p, _ in
              jax.tree_util.tree_flatten_with_path(want)[0]]
    assert T.paths(got) == jpaths
    for a, b in zip(T.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=1e-3 * max(np.abs(b).max(), 1e-30))


def test_grad_leaves_alias_the_dense_layers_stack():
    _, cfg = _cfgs(LLAMA)
    jcfg = jax_config(LLAMA).smoke()
    params = from_numpy(numpy_params(jcfg))
    grads = T.map_tree(torch.zeros_like, params)
    leaves = _grad_leaves(params, grads)
    stacked, gstacked = params["dense_layers"], grads["dense_layers"]
    n, m = T.leaves(stacked)[0].shape[:2]
    assert (n, m) == (cfg.n_layers // cfg.moe_every, cfg.moe_every - 1)
    assert len(leaves["dense_layers"]) == n
    for i in range(n):
        assert len(leaves["dense_layers"][i]) == m
        for j in range(m):
            for a, p, g in zip(T.leaves(leaves["dense_layers"][i][j]),
                               T.leaves(stacked), T.leaves(gstacked)):
                assert a.requires_grad and a.shape == p.shape[2:]
                assert a.data_ptr() == p[i, j].data_ptr()
                assert a.grad.data_ptr() == g[i, j].data_ptr()


class JaxMasks(FaultModel):
    """Hands the port the word masks JAX drew, in corruption order."""

    def __init__(self, masks):
        self.masks = list(masks)

    def word_mask(self, generator, words, dt=1.0):
        m = self.masks.pop(0)
        assert m.shape == tuple(words.shape)
        return torch.from_numpy(m.view(np.int32).copy())


def _engine_masks(fault, key, jparams, copies):
    leaves = jax.tree.leaves(jparams)
    out = []
    for i in range(copies):
        ks = jax.random.split(jax.random.fold_in(key, 100 + i), len(leaves))
        out += [np.asarray(fault.word_mask(k, jarena.leaf_to_words(x)))
                for k, x in zip(ks, leaves)]
    return out


@pytest.mark.parametrize("spec,kw", [
    ("ecc+tmr-parallel", dict(vote_every=2, vote_cache=True)),
    ("ecc+tmr", dict(execution="loop"))], ids=["scan-votes", "loop"])
def test_engine_on_interleaved_moe_matches_reference(spec, kw):
    jcfg, cfg = _cfgs(LLAMA)
    key = jax.random.PRNGKey(0)
    jparams = JP.materialize(key, JT.model_specs(jcfg))
    params_np = jax.tree.map(np.asarray, jparams)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab, size=(2, 8)).astype(np.int32)
    fault = JFlips(1e-5)

    jeng = JEngine(jcfg, j_parse(spec), gen=5, **kw)
    jstore, jprep = jeng.prepare(jparams, key=key, fault=fault)
    jtok, jtel = jeng.generate(jstore, {"tokens": jnp.asarray(tokens)})
    jstats = j_fetch({**jprep, **jtel})

    eng = GenerationEngine(cfg, parse_scheme(spec), gen=5, device="cpu",
                           **kw)
    masks = JaxMasks(_engine_masks(fault, key, jparams, 3))
    store, prep = eng.prepare(from_numpy(params_np), fault=masks)
    assert not masks.masks
    tok, tel = eng.generate(store, {"tokens": torch.from_numpy(tokens)})
    stats = fetch_telemetry({**prep, **tel})

    words, _ = arena.words_of(store, copies=3)
    jwords = [np.asarray(jarena.pack(jax.tree.map(
        lambda x, i=i: x[i], jstore))[0]).view(np.int32) for i in range(3)]
    np.testing.assert_array_equal(words.numpy(), np.stack(jwords))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert sorted(stats) == sorted(jstats)
    for k in stats:
        np.testing.assert_array_equal(stats[k], np.asarray(jstats[k]),
                                      err_msg=k)
    assert int(stats["ecc_corrected"]) > 0


def test_arena_of_interleaved_tree_matches_reference():
    jcfg = jax_config(LLAMA).smoke()
    params_np = numpy_params(jcfg, seed=5)
    jwords = np.asarray(jarena.pack(jax.tree.map(jnp.asarray, params_np))[0]
                        ).view(np.int32)
    params = from_numpy(params_np)
    words, spec = arena.words_of(params)
    np.testing.assert_array_equal(words.numpy(), jwords)
    assert ("dense_layers", "mlp", "w_up") in spec.paths
    again = arena.unpack(arena.pack(params)[0], spec)
    for a, b in zip(T.leaves(again), T.leaves(params_np)):
        np.testing.assert_array_equal(a.numpy(), b)
