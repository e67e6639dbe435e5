"""The port's optimizer (`repro_torch.optim`) against the JAX package's,
on the same numpy inputs (seeded):

* `warmup_cosine` within 1e-6 of the reference's at every step;
* one `adamw_update` (clipping active and not) within rtol 1e-6 on the
  params, `m`, `v`, the grad norm and the learning rate; the update
  happens in place (the params, moments and count are the given tensors);
* the int8 error-feedback round trip bit for bit (grads and error), over
  leaves with and without a partial last tile, and over several steps.
  The reference runs op by op here: jitted, XLA's CPU fusion contracts
  its ``target - q * scale`` into a fused multiply-add, which moves the
  error state's last bit (the dequantized grads stay equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as j_adamw
from repro.optim import compress_decompress as j_compress
from repro.optim import init_error_state as j_init_err
from repro.optim import init_opt_state as j_init_opt
from repro.optim import warmup_cosine as j_warmup
from repro_torch.core import tree as T
from repro_torch.optim import (AdamWConfig, adamw_update, compress_decompress,
                               global_norm, init_error_state, init_opt_state,
                               warmup_cosine)
from repro_torch.optim import adamw as adamw_mod


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = {"a": (300,), "b": {"c": (4, 64), "d": (3, 5, 7)}}


def _tree(rng, scale=1.0):
    return T.map_tree(
        lambda s: (scale * rng.standard_normal(s)).astype(np.float32), SHAPES)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return T.map_tree(lambda a: torch.from_numpy(np.array(a)), tree)


SCHEDULES = [dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
             dict(lr=3e-4, warmup_steps=5, total_steps=4),
             dict(lr=3e-4, warmup_steps=100, total_steps=10000)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda k: f"w{k['warmup_steps']}")
def test_warmup_cosine_matches_reference(kw):
    steps = np.arange(0, kw["total_steps"] + 20, dtype=np.int32)
    got = warmup_cosine(AdamWConfig(**kw), torch.from_numpy(steps)).numpy()
    want = np.asarray(j_warmup(JAdamWConfig(**kw), jnp.asarray(steps)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    assert float(warmup_cosine(cfg, 5)) == pytest.approx(0.5)
    assert float(warmup_cosine(cfg, 10)) == pytest.approx(1.0, abs=0.02)
    assert float(warmup_cosine(cfg, 100)) == pytest.approx(0.1, abs=0.01)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["unclipped",
                                                          "clipped"])
@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_matches_reference(grad_scale, steps, monkeypatch):
    # a small chunk, so the leaves are walked over several chunks
    monkeypatch.setattr(adamw_mod, "CHUNK", 64)
    rng = np.random.default_rng(steps)
    params = _tree(rng)
    grads = [_tree(rng, grad_scale) for _ in range(steps)]
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jp, jo = _j(params), j_init_opt(_j(params))
    p = _t(params)
    o = init_opt_state(p)
    leaves, m_leaves = T.leaves(p), T.leaves(o["m"])
    j_step = jax.jit(lambda g, o, p: j_adamw(JAdamWConfig(**cfg), g, o, p))
    for g in grads:
        jp, jo, jm = j_step(_j(g), jo, jp)
        p, o, m = adamw_update(AdamWConfig(**cfg), _t(g), o, p)
    assert all(a is b for a, b in zip(T.leaves(p), leaves))      # in place
    assert all(a is b for a, b in zip(T.leaves(o["m"]), m_leaves))
    assert int(o["count"]) == int(jo["count"]) == steps
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    for got, want in ((p, jp), (o["m"], jo["m"]), (o["v"], jo["v"])):
        for a, b in zip(T.leaves(got), jax.tree.leaves(want)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max())


def test_global_norm_matches_reference():
    from repro.optim.adamw import global_norm as j_global_norm
    tree = _tree(np.random.default_rng(5))
    np.testing.assert_allclose(float(global_norm(_t(tree))),
                               float(j_global_norm(_j(tree))), rtol=1e-6)


def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=5,
                      total_steps=200)
    params = {"x": torch.tensor([5.0, -3.0])}
    opt = init_opt_state(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(200):
        g = {"x": 2 * (params["x"] - target)}
        params, opt, m = adamw_update(cfg, g, opt, params)
    np.testing.assert_allclose(params["x"].numpy(), target.numpy(),
                               atol=0.05)


def test_grad_clipping():
    params = {"x": torch.zeros(4)}
    opt = init_opt_state(params)
    g = {"x": torch.full((4,), 100.0)}
    _, _, m = adamw_update(AdamWConfig(clip_norm=1.0), g, opt, params)
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    # the clipped grads are written back
    np.testing.assert_allclose(g["x"].numpy(), np.full(4, 0.5), rtol=1e-6)


def test_bf16_moments_supported():
    params = {"x": torch.ones(8)}
    opt = init_opt_state(params, dtype=torch.bfloat16)
    _, o2, _ = adamw_update(AdamWConfig(), {"x": torch.ones(8)}, opt, params)
    assert o2["m"]["x"].dtype == torch.bfloat16
    jo = j_init_opt({"x": jnp.ones(8)}, dtype=jnp.bfloat16)
    _, jo2, _ = j_adamw(JAdamWConfig(), {"x": jnp.ones(8)}, jo,
                        {"x": jnp.ones(8)})
    np.testing.assert_array_equal(
        o2["m"]["x"].float().numpy(),
        np.asarray(jo2["m"]["x"].astype(jnp.float32)))


# --- error-feedback compression ---------------------------------------------

COMP_SHAPES = [(300,), (1024,), (3, 5, 7), (2, 256)]


@pytest.mark.parametrize("shape", COMP_SHAPES, ids=str)
def test_compression_matches_reference_bit_for_bit(shape):
    rng = np.random.default_rng(len(shape))
    gs = [(0.01 * rng.standard_normal(shape)).astype(np.float32)
          for _ in range(3)]
    je = j_init_err({"w": jnp.zeros(shape)})
    e = init_error_state({"w": torch.zeros(shape)})
    for g in gs:                      # three steps of error feedback
        jd, je = j_compress({"w": jnp.asarray(g)}, je)
        gt = {"w": torch.from_numpy(g.copy())}
        d, e = compress_decompress(gt, e)
        assert d is gt                # in place
        np.testing.assert_array_equal(d["w"].numpy(), np.asarray(jd["w"]))
        np.testing.assert_array_equal(e["w"].numpy(), np.asarray(je["w"]))


@pytest.mark.parametrize("seed", range(5))
def test_compression_error_feedback_identity(seed):
    """Q(g+e) + e' == g + e exactly (the error carries all rounding)."""
    g0 = 0.01 * torch.randn(300, generator=torch.Generator().manual_seed(seed))
    g = {"w": g0.clone()}
    deq, e2 = compress_decompress(g, init_error_state(g))
    np.testing.assert_allclose((deq["w"] + e2["w"]).numpy(), g0.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_compression_error_stays_bounded():
    gen = torch.Generator().manual_seed(0)
    e = init_error_state({"w": torch.zeros(1024)})
    for _ in range(20):
        _, e = compress_decompress({"w": torch.randn(1024, generator=gen)}, e)
    assert float(e["w"].abs().max()) < 0.2
