"""The port's RG-LRU block (`repro_torch.models.rglru`) against the JAX
package's, on the recurrentgemma-2b smoke config (d_model 128, LRU width
128 in 16 blocks of 8) in fp32, from numpy inputs:

* `linear_scan`, the doubling scan, against `jax.lax.associative_scan`
  with the reference's combine and against a step-by-step loop, within
  1e-6 (fp32 products and sums in another order), at lengths that are and
  are not powers of two;
* `_gates` against the reference's and against a dense block-diagonal
  matrix built from the (nb, bw, bw) blocks, within 1e-6; and at the
  scale of the reference's fan-in init (gate weights of std 1, inputs of
  std 50), `a` within two ulps of 1 and `b` within 1e-4 wherever
  1 - a >= 1e-3, and within 1e-5 of the op-by-op reference's
  (`jax.disable_jit`) wherever the two `a` agree bit for bit; where `a`
  rounds to within 1e-6 of 1 (four in ten values there) sqrt(1 - a^2)
  keeps no correct digit in fp32 once `a`'s last bit differs or the
  compiler fuses it otherwise, the reference's as the port's;
* `rglru_forward` (output, conv tail and last state) and
  `rglru_decode_step` (output and the cache, updated in place) within
  1e-5; and a prefix through the forward then decode steps against the
  forward over the whole sequence, within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import rglru as JR
from repro_torch.configs import get_config
from repro_torch.core import tree as T
from repro_torch.models import rglru as PR

TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (jax_config("recurrentgemma-2b").smoke().replace(
        compute_dtype="float32"),
            get_config("recurrentgemma-2b").smoke().replace(
                compute_dtype="float32"))


def block_params(cfg, seed=0, std=0.1):
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in PR.rglru_specs(cfg).items():
        base = {"zeros": 0.0, "ones": 1.0}.get(s.init, 0.0)
        out[k] = (base + std * rng.standard_normal(s.shape)).astype(
            np.float32)
    return out


def _t(tree):
    return T.map_tree(lambda a: torch.from_numpy(np.asarray(a)), tree)


def _combine(l, r):
    al, bl = l
    ar, br = r
    return al * ar, bl * ar + br


@pytest.mark.parametrize("S", [1, 37, 64])
def test_linear_scan_matches_associative_scan_and_loop(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 24)).astype(np.float32)
    b = rng.standard_normal((2, S, 24)).astype(np.float32)
    _, want = jax.lax.associative_scan(_combine, (jnp.asarray(a),
                                                  jnp.asarray(b)), axis=1)
    got = PR.linear_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    h, loop = np.zeros((2, 24), np.float32), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        loop.append(h)
    np.testing.assert_allclose(got, np.stack(loop, 1), rtol=1e-6, atol=1e-6)


def test_block_diagonal_gates():
    jcfg, cfg = _cfgs()
    p = block_params(cfg)
    nb, bw = p["wa"].shape[:2]
    assert (nb, bw) == (16, 8) == (PR._blocks(cfg), cfg.lru_width // 16)
    xc = np.random.default_rng(1).standard_normal(
        (2, 5, cfg.lru_width)).astype(np.float32)
    ja, jb = JR._gates(p, jnp.asarray(xc), jcfg)
    a, b = PR._gates(_t(p), torch.from_numpy(xc), cfg)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)
    # the same gates from a dense (W, W) block-diagonal matrix
    dense = np.zeros((cfg.lru_width,) * 2, np.float32)
    for k in range(nb):
        dense[k * bw:(k + 1) * bw, k * bw:(k + 1) * bw] = p["wa"][k]
    r = 1 / (1 + np.exp(-(xc @ dense)))
    sp = np.log1p(np.exp(p["lam"]))
    np.testing.assert_allclose(a.numpy(), np.exp(-8.0 * sp * r), rtol=1e-6,
                               atol=1e-6)


def test_gates_at_the_fan_in_scale():
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(5)
    p = {k: (np.ones(s.shape) if s.init == "ones" else
             rng.standard_normal(s.shape)).astype(np.float32)
         for k, s in PR.rglru_specs(cfg).items()}
    xc = (50 * rng.standard_normal((2, 40, cfg.lru_width))).astype(
        np.float32)
    ja, jb = (np.asarray(x) for x in jax.jit(
        lambda p, x: JR._gates(p, x, jcfg))(p, xc))
    a, b = (x.numpy() for x in PR._gates(_t(p), torch.from_numpy(xc), cfg))
    np.testing.assert_allclose(a, ja, rtol=2e-6, atol=2 * 2.0 ** -24)
    well = 1 - ja >= 1e-3
    np.testing.assert_allclose(b[well], jb[well], rtol=1e-4, atol=1e-30)
    # sqrt(1 - a^2) with a an ulp or two below 1 (or at 1, where the
    # clamp gives 1e-6): a last-bit difference in a changes it wholly, and
    # so does the compiled reference's fusion, whose b there departs from
    # its own op-by-op b; so b is held there against the op-by-op
    # reference, where the two a agree bit for bit
    ill = 1 - ja < 1e-6
    assert 0.3 < ill.mean() < 0.6
    with jax.disable_jit():
        ea, eb = (np.asarray(x) for x in JR._gates(p, jnp.asarray(xc),
                                                   jcfg))
    same = a == ea
    assert same[ill].mean() > 0.9
    np.testing.assert_allclose(b[same], eb[same], rtol=1e-5, atol=1e-30)


def test_rglru_forward_matches_reference():
    jcfg, cfg = _cfgs()
    p = block_params(cfg, seed=2)
    x = np.random.default_rng(3).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    jout, (jconv, jh) = JR.rglru_forward(p, jcfg, jnp.asarray(x))
    out, (conv, h) = PR.rglru_forward(_t(p), cfg, torch.from_numpy(x))
    for got, want in ((out, jout), (conv, jconv), (h, jh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    assert h.dtype == torch.float32


def test_rglru_decode_step_matches_reference():
    jcfg, cfg = _cfgs()
    p = block_params(cfg, seed=4)
    rng = np.random.default_rng(5)
    specs = PR.rglru_cache_specs(cfg, 2)
    cache = {k: rng.standard_normal(s.shape).astype(np.float32)
             for k, s in specs.items()}
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jout, jcache = JR.rglru_decode_step(p, jcfg, jnp.asarray(x),
                                        {k: jnp.asarray(v)
                                         for k, v in cache.items()})
    tc = _t(cache)
    held = dict(tc)
    out, new = PR.rglru_decode_step(_t(p), cfg, torch.from_numpy(x), tc)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    for k in specs:
        assert new[k] is held[k]            # updated in place
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jcache[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_prefill_then_decode_matches_forward():
    _, cfg = _cfgs()
    p = _t(block_params(cfg, seed=6))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 30, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        full, _ = PR.rglru_forward(p, cfg, x)
        _, (conv, h) = PR.rglru_forward(p, cfg, x[:, :23])
        cache = {"conv": conv.clone(), "h": h.clone()}
        outs = [PR.rglru_decode_step(p, cfg, x[:, t:t + 1], cache)[0]
                for t in range(23, 30)]
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                               full[:, 23:].numpy(), rtol=TOL, atol=TOL)
