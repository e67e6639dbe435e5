"""The port's cross-attention pieces against the JAX package's, in fp32
from numpy inputs, with the gate at 0.7 (tanh(0) = 0, the init, would
zero every output and hold nothing):

* `attention.cross_attention` on the VLM smoke config (a 16-token image
  memory of width vis_dim = 128, GQA 4 heads over 1 kv head) and the
  enc-dec one (a memory of d_model, MHA), through the blocked, naive and
  flash (the plain version on the CPU) paths, within 1e-5;
* `transformer._precompute_cross_kv` (the K/V of the whole memory) and
  `_cross_cached` (one query token against them) within 1e-5, and
  `_cross_cached` against `cross_attention` of the same token;
* `nn.layer_norm` (exported by the reference, used by no model) within
  1e-6 in fp32 and to the bf16 rounding step in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as JA
from repro.models import nn as JN
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.core import tree as T
from repro_torch.models import attention as PA
from repro_torch.models import nn as PN
from repro_torch.models import transformer as PT

TOL = 1e-5
ARCHS = {"vlm": "llama-3.2-vision-11b", "encdec": "seamless-m4t-medium"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(family, impl="blocked"):
    kw = dict(compute_dtype="float32", attention_impl=impl)
    return (jax_config(ARCHS[family]).smoke().replace(**kw),
            get_config(ARCHS[family]).smoke().replace(**kw))


def xattn_params(cfg, seed=0, std=0.1):
    rng = np.random.default_rng(seed)
    mem_dim = cfg.vis_dim if cfg.family == "vlm" else None
    out = {}
    for k, s in PA.cross_attn_specs(cfg, mem_dim).items():
        out[k] = (np.full(s.shape, 0.7, np.float32) if k == "gate" else
                  (std * rng.standard_normal(s.shape)).astype(np.float32))
    return out


def _t(tree):
    return T.map_tree(lambda a: torch.from_numpy(np.asarray(a)), tree)


def _inputs(cfg, S=12, seed=1):
    rng = np.random.default_rng(seed)
    M, md = ((cfg.vis_tokens, cfg.vis_dim) if cfg.family == "vlm"
             else (20, cfg.d_model))
    return (rng.standard_normal((2, S, cfg.d_model)).astype(np.float32),
            rng.standard_normal((2, M, md)).astype(np.float32))


@pytest.mark.parametrize("impl", ["blocked", "naive", "pallas"])
@pytest.mark.parametrize("family", list(ARCHS))
def test_cross_attention_matches_reference(family, impl):
    jcfg, cfg = _cfgs(family, impl)
    p = xattn_params(cfg)
    x, mem = _inputs(cfg)
    jref = jcfg.replace(attention_impl="naive")     # the JAX jnp path
    want = JA.cross_attention(p, jref, jnp.asarray(x), jnp.asarray(mem))
    got = PA.cross_attention(_t(p), cfg, torch.from_numpy(x),
                             torch.from_numpy(mem))
    assert tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert np.abs(np.asarray(want)).max() > 1e-2


@pytest.mark.parametrize("family", list(ARCHS))
def test_cached_cross_attention_matches_reference(family):
    jcfg, cfg = _cfgs(family)
    p = xattn_params(cfg, seed=2)
    x, mem = _inputs(cfg, S=1, seed=3)
    jk, jv = JT._precompute_cross_kv(p, jcfg, jnp.asarray(mem))
    k, v = PT._precompute_cross_kv(_t(p), cfg, torch.from_numpy(mem))
    assert tuple(k.shape) == (2, mem.shape[1], cfg.n_kv, cfg.head_dim)
    for got, want in ((k, jk), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    want = JT._cross_cached(p, jcfg, jnp.asarray(x), jk, jv)
    got = PT._cross_cached(_t(p), cfg, torch.from_numpy(x), k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    full = PA.cross_attention(_t(p), cfg, torch.from_numpy(x),
                              torch.from_numpy(mem))
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(4)
    x = (3 * rng.standard_normal((2, 5, 48)) + 1).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    want = JN.layer_norm(jnp.asarray(x).astype(dtype), jnp.asarray(scale),
                         jnp.asarray(bias))
    got = PN.layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2 ** -6 * np.abs(
        np.asarray(want, np.float32)).max()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=tol)
