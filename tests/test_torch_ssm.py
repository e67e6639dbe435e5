"""The port's Mamba-2 block (`repro_torch.models.ssm`) against the JAX
package's, on the mamba2-130m smoke config (d_model 64, 2 SSD heads of 32,
state 16, chunk 16) in fp32, from numpy inputs:

* `_ssd_chunked` at S a multiple of the chunk (48) and not (40: the
  identity padding), outputs and final state within 1e-5 (the same sums
  in another order: two-operand products here, `opt_einsum`'s order
  there), and the same outputs at chunk 8 as at 16 and as a step-by-step
  numpy recurrence;
* `mamba_forward`'s output and its cache (the conv tail, a projection's
  rows, and the final state) within 1e-5, also for a sequence as short
  as the conv tail;
* `mamba_decode_step` from one cache: output and new cache within 1e-5,
  the update landing in the given cache's tensors;
* a prefill, then decode steps, against `mamba_forward` over the whole
  sequence (teacher forcing: the chunked scan against the recurrence),
  within 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import ssm as JS
from repro_torch.configs import get_config
from repro_torch.core import tree as T
from repro_torch.models import ssm as PS

TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (jax_config("mamba2-130m").smoke().replace(
        compute_dtype="float32"),
            get_config("mamba2-130m").smoke().replace(compute_dtype="float32"))


def block_params(cfg, seed=0, std=0.1):
    """numpy weights for one Mamba-2 block (zeros as the spec says; A_log
    and D near their ones init)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in PS.mamba_specs(cfg).items():
        if s.init == "zeros":
            out[k] = np.zeros(s.shape, np.float32)
        elif s.init == "ones":
            out[k] = (1 + std * rng.standard_normal(s.shape)).astype(
                np.float32)
        else:
            out[k] = (std * rng.standard_normal(s.shape)).astype(np.float32)
    return out


def _t(tree):
    return T.map_tree(lambda a: torch.from_numpy(np.asarray(a)), tree)


def ssd_inputs(S, H=2, P=32, N=16, B=2, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def ssd_loop(x, dt, A, Bm, Cm):
    """The recurrence step by step in float64: h_t = exp(dt_t A) h_{t-1} +
    dt_t x_t B_t^T, y_t = h_t C_t."""
    Bsz, S, H, P = x.shape
    h = np.zeros((Bsz, H, P, Bm.shape[-1]))
    ys = []
    for t in range(S):
        dec = np.exp(dt[:, t] * A)                              # (B,H)
        h = h * dec[..., None, None] + np.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], Bm[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return np.stack(ys, 1), h


@pytest.mark.parametrize("S", [48, 40], ids=["multiple", "padded"])
def test_ssd_chunked_matches_reference(S):
    args = ssd_inputs(S)
    jy, js = JS._ssd_chunked(*(jnp.asarray(a) for a in args), chunk=16)
    y, s = PS._ssd_chunked(*(torch.from_numpy(a) for a in args), chunk=16)
    assert tuple(y.shape) == args[0].shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=TOL, atol=TOL)


def test_ssd_chunk_size_invariance():
    args = ssd_inputs(40, seed=2)
    t = [torch.from_numpy(a) for a in args]
    y8, s8 = PS._ssd_chunked(*t, chunk=8)
    y16, s16 = PS._ssd_chunked(*t, chunk=16)
    ly, ls = ssd_loop(*(a.astype(np.float64) for a in args))
    for y, s in ((y8, s8), (y16, s16)):
        np.testing.assert_allclose(y.numpy(), ly, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(s.numpy(), ls, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(y8.numpy(), y16.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("S", [40, 3], ids=["padded", "tail-length"])
def test_mamba_forward_and_cache_match_reference(S):
    jcfg, cfg = _cfgs()
    p = block_params(cfg)
    x = np.random.default_rng(3).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    jout, (jconv, jstate) = JS.mamba_forward(p, jcfg, jnp.asarray(x))
    out, (conv, state) = PS.mamba_forward(_t(p), cfg, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(conv.numpy(), np.asarray(jconv), rtol=TOL,
                               atol=TOL)
    assert state.dtype == torch.float32
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), rtol=TOL,
                               atol=TOL)


def test_mamba_decode_step_matches_reference():
    jcfg, cfg = _cfgs()
    p = block_params(cfg, seed=4)
    rng = np.random.default_rng(5)
    specs = PS.mamba_cache_specs(cfg, 2)
    cache = {k: rng.standard_normal(s.shape).astype(np.float32)
             for k, s in specs.items()}
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jout, jcache = JS.mamba_decode_step(p, jcfg, jnp.asarray(x),
                                        {k: jnp.asarray(v)
                                         for k, v in cache.items()})
    tc = _t(cache)
    held = dict(tc)
    out, new = PS.mamba_decode_step(_t(p), cfg, torch.from_numpy(x), tc)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    for k in specs:
        assert new[k] is held[k]            # updated in place
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jcache[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_prefill_then_decode_matches_forward():
    """Teacher forcing at the block: a 21-token prefix through
    `mamba_forward` (not a multiple of the chunk), then 6 decode steps,
    give the outputs of `mamba_forward` over all 27 tokens."""
    _, cfg = _cfgs()
    p = _t(block_params(cfg, seed=6))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 27, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        full, _ = PS.mamba_forward(p, cfg, x)
        _, (conv, state) = PS.mamba_forward(p, cfg, x[:, :21])
        cache = {"conv": conv.clone(), "state": state.clone()}
        outs = [PS.mamba_decode_step(p, cfg, x[:, t:t + 1], cache)[0]
                for t in range(21, 27)]
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                               full[:, 21:].numpy(), rtol=1e-4, atol=1e-4)
