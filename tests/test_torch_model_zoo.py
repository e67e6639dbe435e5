"""The port's model zoo (`repro_torch.configs`, `repro_torch.models`)
against the JAX package's:

* the registry is the reference's ten archs; for each, `model_specs(
  CONFIG)` equals the reference's Spec tree (key paths, shapes, axes,
  init, scale, dtype) and `count_params` its count, at full and smoke
  size (Spec trees only, nothing materialized), and `CONFIG` equals the
  reference's field for field; the continuous batcher refuses the ssm,
  hybrid, vlm and encdec families with the reference's message;
* `act_fn` and `mlp_apply` for relu2, gelu, geglu and swiglu within 1e-6
  in fp32; GELU is the tanh form (`jax.nn.gelu`'s default), and the erf
  form misses that tolerance;
* `forward`, `prefill` and 8 greedy `decode_step`s of each dense config's
  `smoke()` in fp32 from the same numpy weights (std 0.02): tokens bit for
  bit, hidden states and logits within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_config
from repro.configs import list_archs as jax_list_archs
from repro.launch.batching import ContinuousBatcher as JContinuousBatcher
from repro.models import nn as JN
from repro.models import params as JP
from repro.models import transformer as JT
from repro.models.steps import make_decode_step as j_decode_step
from repro.models.steps import make_prefill_step as j_prefill_step
from repro_torch.configs import ARCHS, get_config, list_archs
from repro_torch.core import tree as T
from repro_torch.launch.batching import ContinuousBatcher
from repro_torch.models import nn as PN
from repro_torch.models import params as PP
from repro_torch.models import transformer as PT
from repro_torch.models.params import from_numpy
from repro_torch.models.steps import make_decode_step, make_prefill_step

DENSE = ["phi3-mini-3.8b", "qwen2.5-14b", "nemotron-4-15b", "deepseek-67b"]
MOE = ["phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"]
OTHER = ["mamba2-130m", "recurrentgemma-2b", "llama-3.2-vision-11b",
         "seamless-m4t-medium"]
HIDDEN_TOL = 1e-4
DECODE_STEPS = 8


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_params(jcfg, seed=0, std=0.02):
    """numpy weights for the reference's spec tree (zeros where the spec
    says zeros, else normal(0, std))."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32) if s.init == "zeros"
        else (std * rng.standard_normal(s.shape)).astype(np.float32),
        JT.model_specs(jcfg), is_leaf=lambda x: isinstance(x, JP.Spec))


def test_registry_holds_the_six_ported_archs():
    """The six dense and MoE archs, and since the SSM, hybrid, VLM and
    enc-dec families were ported the reference's other four: its whole
    registry, in its order."""
    assert set(DENSE + MOE) <= set(list_archs())
    assert list_archs() == jax_list_archs()
    assert ARCHS == JAX_ARCHS and len(ARCHS) == 10
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("mamba3-1b")


@pytest.mark.parametrize("arch", DENSE + MOE + OTHER)
def test_specs_and_count_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    got = PT.model_specs(cfg)
    want = JT.model_specs(jcfg)
    jleaves = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, JP.Spec))[0]
    jpaths = [tuple(k.key for k in p) for p, _ in jleaves]
    assert T.paths(got) == jpaths
    for s, (_, j) in zip(T.leaves(got), jleaves):
        assert (s.shape, s.axes, s.init, s.scale, s.dtype) == \
            (j.shape, j.axes, j.init, j.scale, j.dtype)
    assert PP.count_params(got) == JP.count_params(want)
    smoke = PT.model_specs(cfg.smoke())
    assert PP.count_params(smoke) == JP.count_params(
        JT.model_specs(jcfg.smoke()))


@pytest.mark.parametrize("arch", OTHER)
def test_batcher_refuses_unpaged_families(arch):
    """The ssm, hybrid, vlm and encdec families have a model (`model_specs`
    and `smoke()` take them), and the continuous batcher refuses them with
    the reference's message: their caches are not paged, there either."""
    cfg, jcfg = get_config(arch).smoke(), jax_config(arch).smoke()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert PP.count_params(PT.model_specs(cfg)) == JP.count_params(
        JT.model_specs(jcfg))
    with pytest.raises(ValueError) as want:
        JContinuousBatcher(jcfg)
    with pytest.raises(ValueError) as got:
        ContinuousBatcher(cfg, device="cpu")
    assert str(got.value) == str(want.value)
    assert f"{cfg.family!r} caches are not paged yet" in str(got.value)


ACTS = ["relu2", "gelu", "geglu", "swiglu"]


@pytest.mark.parametrize("act", ACTS)
def test_act_and_mlp_match_reference(act):
    rng = np.random.default_rng(ACTS.index(act))
    x = (3 * rng.standard_normal((2, 5, 32))).astype(np.float32)
    got = PN.act_fn(act, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(JN.act_fn(act, x)),
                               rtol=1e-6, atol=1e-6)
    jcfg = jax_config("phi3-mini-3.8b").smoke().replace(act=act, d_ff=48)
    cfg = get_config("phi3-mini-3.8b").smoke().replace(act=act, d_ff=48)
    p = jax.tree.map(lambda s: (0.1 * rng.standard_normal(s.shape))
                     .astype(np.float32), JN.mlp_specs(jcfg),
                     is_leaf=lambda v: isinstance(v, JP.Spec))
    h = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    want = np.asarray(JN.mlp_apply(p, jcfg, h))
    got = PN.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()}, cfg,
                       torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; the erf form that
    torch defaults to misses the 1e-6 tolerance by orders of magnitude."""
    x = np.linspace(-4, 4, 801, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(x))
    t = torch.from_numpy(x)
    np.testing.assert_allclose(PN.gelu(t).numpy(), want, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(PN.act_fn("gelu", t).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    assert np.abs(F.gelu(t).numpy() - want).max() > 1e-4


def _run_reference(jcfg, params, tokens):
    jh, jaux = jax.jit(lambda p, t: JT.forward(p, jcfg, {"tokens": t}))(
        params, tokens)
    cache_len = tokens.shape[1] + DECODE_STEPS
    tok, logits, cache = jax.jit(j_prefill_step(jcfg, cache_len))(
        params, {"tokens": tokens})
    dec = jax.jit(j_decode_step(jcfg))
    toks, step_logits = [tok], [logits]
    for _ in range(DECODE_STEPS):
        tok, logits, cache = dec(params, tok, cache)
        toks.append(tok)
        step_logits.append(logits)
    return (np.asarray(jh), float(jaux),
            np.concatenate([np.asarray(t) for t in toks], 1),
            np.stack([np.asarray(x) for x in step_logits]))


def run_port(cfg, params_np, tokens):
    """(hidden, aux, greedy tokens (B, 1 + steps), the logits of the
    prefill and each step) of the port in no-grad mode."""
    params = from_numpy(params_np)
    with torch.no_grad():
        h, aux = PT.forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
        tok, logits, cache = make_prefill_step(
            cfg, tokens.shape[1] + DECODE_STEPS)(
                params, {"tokens": torch.from_numpy(tokens)})
        dec = make_decode_step(cfg)
        toks, step_logits = [tok], [logits]
        for _ in range(DECODE_STEPS):
            tok, logits, cache = dec(params, tok, cache)
            toks.append(tok)
            step_logits.append(logits)
    return (h.numpy(), float(aux), torch.cat(toks, 1).numpy(),
            torch.stack(step_logits).numpy())


def check_against_reference(arch, seed=0, tol=HIDDEN_TOL):
    """The port's forward, prefill and greedy decode of `arch`'s smoke
    config in fp32 against the reference's; returns both aux losses."""
    jcfg = jax_config(arch).smoke().replace(compute_dtype="float32")
    cfg = get_config(arch).smoke().replace(compute_dtype="float32")
    params = numpy_params(jcfg, seed)
    tokens = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32)
    jh, jaux, jtok, jlog = _run_reference(jcfg, params, tokens)
    h, aux, tok, log = run_port(cfg, params, tokens)
    np.testing.assert_allclose(h, jh, rtol=tol, atol=tol)
    assert tok.dtype == np.int32 and tok.shape == (2, 1 + DECODE_STEPS)
    np.testing.assert_array_equal(tok, jtok)
    np.testing.assert_allclose(log, jlog, rtol=tol, atol=tol)
    return aux, jaux


@pytest.mark.parametrize("arch", DENSE)
def test_dense_smoke_matches_reference(arch):
    aux, jaux = check_against_reference(arch)
    assert aux == jaux == 0.0
