"""The port's training steps (`repro_torch.models.steps`) against the JAX
package's on the phi3-mini smoke config at 4 layers, d_model 128, float32
compute, batch 4 x 32 tokens of numpy-seeded ids:

* `chunked_xent` (and with a mask) and `softmax_xent` within rtol 1e-5;
* the loss and its grads (through the forward's per-layer remat, the
  blocked attention's recompute backward and the chunked loss) within rtol
  1e-4, atol 1e-4 of each leaf's largest reference grad;
* `microbatches=2` gives the full batch's grads within the same
  tolerance;
* one `make_train_step` step from `train_state_from_reference` gives the
  params, `m`, `v` within rtol 1e-5 (atol 1e-5 of the leaf's largest
  value) and the loss within 1e-5, also with ``microbatches=2`` and the
  int8 compression.  Its error state holds at most half a quantum an
  element, so it is held to 1e-5 of the quantized range (127 x its largest
  value, the grads' scale).  Compressed, an element whose
  two fp32 grads (equal within rounding) straddle a rounding boundary of
  its tile's int8 grid lands one quantum apart: there at most 1e-4 of the
  elements may miss 1e-5, and none by more than two quanta of the leaf's
  largest tile (2/127 of its largest value).
  The step runs with clipping out of reach (`clip_norm` 1e3): the
  reference's jitted `global_norm` (an fp32 `dot_general` per leaf) is
  6e-4 below the float64 norm of its own grads here, so a clipped step
  would carry that error into every moment.  The port's grad norm is held
  to the float64 norm within 1e-5 and to the reference's within 1e-3; the
  clipped update itself is held to the reference's in
  `tests/test_torch_optim.py`, on leaves where its norm is exact.

The weights are drawn with numpy at std 0.02.  The reference's own init
(`materialize`: std 1/sqrt(n_layers) for the "scaled" leaves of the stacked
layers) makes this 4-layer model amplify rounding: there JAX's jitted and
eager grads differ from each other by up to 2.9e-4 of a leaf's largest
grad (6e-5, 2.9e-4 and 1.2e-4 for keys 0, 1 and 2), so no two
implementations could agree to 1e-4.  At that init the port's loss is held
to the jitted reference's within 1e-5 and its grads within 1e-3 (the
port's own distance is 3.3e-4, 1.9e-4 and 6.4e-4 for the same keys).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import params as JP
from repro.models import transformer as JT
from repro.models.nn import softmax_xent as j_softmax_xent
from repro.models.steps import chunked_xent as j_chunked_xent
from repro.models.steps import init_train_state as j_init_state
from repro.models.steps import make_train_step as j_train_step
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.configs import get_config
from repro_torch.core import tree as T
from repro_torch.models.nn import softmax_xent
from repro_torch.models.params import from_numpy, train_state_from_reference
from repro_torch.models.steps import (_grad_leaves, chunked_xent,
                                      init_train_state, make_loss_fn,
                                      make_train_step)
from repro_torch.optim import AdamWConfig

SMOKE = dict(compute_dtype="float32", n_layers=4)
#: a clip norm the smoke grads (norm ~2.8) never reach
UNCLIPPED = 1e3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_params(jcfg, seed=0, std=0.02):
    """numpy params for the reference's spec tree (zeros where the spec
    says zeros, else normal(0, std))."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32) if s.init == "zeros"
        else (std * rng.standard_normal(s.shape)).astype(np.float32),
        JT.model_specs(jcfg), is_leaf=lambda x: isinstance(x, JP.Spec))


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config("phi3-mini-3.8b").smoke().replace(**SMOKE)
    cfg = get_config("phi3-mini-3.8b").smoke().replace(**SMOKE)
    params = smoke_params(jcfg)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32)
    ref = {"steps": {}, "jit": {}}
    for K, comp in ((1, False), (2, True)):
        state = jax.tree.map(np.asarray, j_init_state(_j(params),
                                                      grad_compression=comp))
        ref["jit"][K, comp] = jax.jit(j_train_step(
            jcfg, JAdamWConfig(clip_norm=UNCLIPPED), grad_compression=comp,
            microbatches=K))
        new, m = ref["jit"][K, comp](_j(state),
                                     {"tokens": jnp.asarray(tokens)})
        ref["steps"][K, comp] = (state, jax.tree.map(np.asarray, new),
                                 {k: float(v) for k, v in m.items()})
    _, new, m = ref["steps"][1, False]
    ref["total"], ref["grads"] = m["total"], _step_grads(new)
    return cfg, params, tokens, ref


def _step_grads(new):
    """The reference's grads, from its first unclipped step: there
    m = (1 - b1) g, one fp32 rounding away from the grads."""
    return T.map_tree(lambda x: x / np.float32(1 - JAdamWConfig.b1),
                      new["opt"]["m"])


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _grads(cfg, params, tokens, microbatches=1):
    """The port's loss and grads, through the train step's leaves."""
    p = from_numpy(params)
    g = T.map_tree(torch.zeros_like, p)
    leaves = _grad_leaves(p, g)
    loss_fn = make_loss_fn(cfg)
    B = tokens.shape[0] // microbatches
    total = 0.0
    for i in range(microbatches):
        t, _ = loss_fn(leaves, {"tokens": torch.from_numpy(
            tokens[i * B:(i + 1) * B])})
        t.backward()
        total += float(t.detach()) / microbatches
    for x in T.leaves(g):
        x.div_(microbatches)
    return total, g


@pytest.mark.parametrize("chunk,masked", [(16, False), (8, True),
                                          (64, False)])
def test_chunked_xent_matches_reference(chunk, masked):
    rng = np.random.default_rng(chunk)
    B, S, D, V = 2, 32, 16, 50
    h = rng.standard_normal((B, S, D), np.float32)
    head = rng.standard_normal((D, V), np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = ((np.arange(S)[None] < 20) * np.ones((B, 1))).astype(np.float32) \
        if masked else None
    tm = torch.from_numpy(mask) if masked else None
    got = chunked_xent(torch.from_numpy(h), torch.from_numpy(head),
                       torch.from_numpy(labels), tm, chunk=chunk)
    want = jax.jit(lambda *a: j_chunked_xent(*a, chunk=chunk))(
        jnp.asarray(h), jnp.asarray(head), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    oracle = softmax_xent(torch.from_numpy(h @ head),
                          torch.from_numpy(labels), tm)
    np.testing.assert_allclose(float(oracle), float(j_softmax_xent(
        jnp.asarray(h @ head), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(oracle), rtol=1e-5)


def test_chunked_xent_grads_match_full_logits():
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal((2, 32, 16), np.float32))
    head = torch.from_numpy(rng.standard_normal((16, 40), np.float32))
    labels = torch.from_numpy(rng.integers(0, 40, (2, 32)))
    grads = []
    for f in (lambda h, w: chunked_xent(h, w, labels, chunk=8),
              lambda h, w: softmax_xent(h @ w, labels)):
        a, b = h.clone().requires_grad_(), head.clone().requires_grad_()
        f(a, b).backward()
        grads.append((a.grad, b.grad))
    for x, y in zip(*grads):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_loss_and_grads_match_reference(setup):
    cfg, params, tokens, ref = setup
    total, g = _grads(cfg, params, tokens)
    np.testing.assert_allclose(total, ref["total"], rtol=1e-5)
    for pth, a, b in zip(T.paths(g), T.leaves(g), T.leaves(ref["grads"])):
        _close(a.numpy(), b, 1e-4)


def test_loss_and_grads_match_reference_at_its_init(setup):
    """From the reference's own init (`materialize`, key 0): the one the
    CLI and `launch.train.build` use."""
    cfg, _, tokens, ref = setup
    jcfg = jax_config("phi3-mini-3.8b").smoke().replace(**SMOKE)
    params = jax.tree.map(np.asarray, JP.materialize(jax.random.PRNGKey(0),
                                                     JT.model_specs(jcfg)))
    # the setup's compiled step (same shapes, so no second compile); its
    # grad norm here (about 207) is far from the clip norm
    new, m = ref["jit"][1, False](j_init_state(_j(params)),
                                  {"tokens": jnp.asarray(tokens)})
    assert float(m["grad_norm"]) < UNCLIPPED
    grads = _step_grads(jax.tree.map(np.asarray, new))
    total, g = _grads(cfg, params, tokens)
    np.testing.assert_allclose(total, float(m["total"]), rtol=1e-5)
    assert T.paths(g) == T.paths(grads)
    for a, b in zip(T.leaves(g), T.leaves(grads)):
        _close(a.numpy(), b, 1e-3)


def test_microbatched_grads_match_full_batch(setup):
    cfg, params, tokens, ref = setup
    total1, g1 = _grads(cfg, params, tokens)
    total2, g2 = _grads(cfg, params, tokens, microbatches=2)
    np.testing.assert_allclose(total2, total1, rtol=1e-4)
    for a, b in zip(T.leaves(g2), T.leaves(g1)):
        _close(a.numpy(), b.numpy(), 1e-4)
    for a, b in zip(T.leaves(g2), T.leaves(ref["grads"])):
        _close(a.numpy(), b, 1e-4)


@pytest.mark.parametrize("K,comp", [(1, False), (2, True)],
                         ids=["full", "micro2-compressed"])
def test_train_step_matches_reference(setup, K, comp):
    cfg, _, tokens, ref = setup
    start, want, jm = ref["steps"][K, comp]
    state = train_state_from_reference(start)
    leaves = T.leaves(state["params"])
    out, m = make_train_step(cfg, AdamWConfig(clip_norm=UNCLIPPED),
                             grad_compression=comp, microbatches=K)(
        state, {"tokens": torch.from_numpy(tokens)})
    assert out is state
    assert all(a is b for a, b in zip(T.leaves(out["params"]), leaves))
    assert int(out["opt"]["count"]) == int(want["opt"]["count"]) == 1
    for k in ("total", "loss", "lr"):
        np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"],
                               rtol=1e-3)
    if not comp:
        exact = np.sqrt(sum((b.astype(np.float64) ** 2).sum()
                            for b in T.leaves(ref["grads"])))
        np.testing.assert_allclose(float(m["grad_norm"]), exact, rtol=1e-5)
    pairs = [(out["params"], want["params"]),
             (out["opt"]["m"], want["opt"]["m"]),
             (out["opt"]["v"], want["opt"]["v"])]
    for got, exp in pairs:
        for a, b in zip(T.leaves(got), T.leaves(exp)):
            if comp:
                _close_quantized(a.numpy(), b)
            else:
                _close(a.numpy(), b, 1e-5)
    if comp:
        for a, b in zip(T.leaves(out["err"]), T.leaves(want["err"])):
            _close_quantized(a.numpy(), b, range_x=127)


def _close_quantized(got, want, rtol=1e-5, range_x=1):
    scale = range_x * max(np.abs(want).max(), 1e-30)
    off = ~np.isclose(got, want, rtol=rtol, atol=rtol * scale)
    assert off.mean() <= 1e-4, off.mean()
    assert np.abs(got - want).max() <= 2 / 127 * scale


def test_state_from_reference_is_bit_for_bit(setup):
    _, _, _, ref = setup
    start = ref["steps"][2, True][0]
    state = train_state_from_reference(start)
    for a, b in zip(T.leaves(state["params"]), T.leaves(start["params"])):
        np.testing.assert_array_equal(a.numpy(), b)
    for key in ("m", "v"):
        for a, b in zip(T.leaves(state["opt"][key]),
                        T.leaves(start["opt"][key])):
            np.testing.assert_array_equal(a.numpy(), b)
    assert state["opt"]["count"].dtype == torch.int32
    assert T.paths(state["err"]) == T.paths(start["err"])


def test_loss_decreases_on_learnable_data():
    from repro_torch.data import SyntheticLM
    cfg = get_config("phi3-mini-3.8b").smoke().replace(
        d_model=64, d_ff=128, vocab=64, n_layers=2, compute_dtype="float32")
    jcfg = jax_config("phi3-mini-3.8b").smoke().replace(
        d_model=64, d_ff=128, vocab=64, n_layers=2)
    state = init_train_state(from_numpy(smoke_params(jcfg, std=0.1)))
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch_per_rank=8, seed=1)
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=5,
                                            total_steps=30))
    losses = []
    for i in range(30):
        state, m = step(state, {"tokens": torch.from_numpy(
            data.batch_at(i))})
        losses.append(float(m["total"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


#: bf16 params, K = 2 micro-batches, a step large enough to move bf16
#: params (lr 1e-2 from the first step)
BF16 = dict(SMOKE, param_dtype="bfloat16")
BIG_STEP = dict(clip_norm=UNCLIPPED, lr=1e-2, warmup_steps=0)


@pytest.fixture(scope="module")
def bf16_setup():
    jcfg = jax_config("phi3-mini-3.8b").smoke().replace(**BF16)
    cfg = get_config("phi3-mini-3.8b").smoke().replace(**BF16)
    params = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                          smoke_params(jcfg))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32)
    state = jax.tree.map(np.asarray, j_init_state(_j(params)))
    new, m = jax.jit(j_train_step(jcfg, JAdamWConfig(**BIG_STEP),
                                  microbatches=2))(
        _j(state), {"tokens": jnp.asarray(tokens)})
    return cfg, state, tokens, jax.tree.map(np.asarray, new), m


def _port_step_grads(monkeypatch, cfg, state, tokens, K, **kw):
    """(state after one port step, metrics, the grads AdamW was given)."""
    from repro_torch.models import steps as S
    seen = {}
    real = S.adamw_update

    def spy(opt_cfg, grads, opt, params):
        seen["grads"] = T.map_tree(lambda g: g.clone(), grads)
        return real(opt_cfg, grads, opt, params)

    monkeypatch.setattr(S, "adamw_update", spy)
    out, m = make_train_step(cfg, AdamWConfig(**BIG_STEP), microbatches=K,
                             **kw)(train_state_from_reference(state),
                                   {"tokens": torch.from_numpy(tokens)})
    return out, m, seen["grads"]


def test_bf16_microbatch_grads_accumulate_in_fp32(bf16_setup, monkeypatch):
    """The reference adds each micro-batch's bf16 grads in fp32 into fp32
    accumulators, then divides by K; so does the port.  Each slice's
    grads are rounded to bf16 on both sides, and where the two fp32 values
    straddle a bf16 rounding boundary they land one bf16 ulp apart: every
    element is held within 2^-8 of its leaf's largest grad, and at most 1%
    of a leaf's elements may miss rtol 1e-3 (atol 1e-6 of the leaf's
    largest).  Summed in bf16 instead, about half of them miss it."""
    cfg, state, tokens, new, jm = bf16_setup
    out, m, grads = _port_step_grads(monkeypatch, cfg, state, tokens, K=2)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    want = _step_grads(new)
    for key in ("grads", "m"):
        got = grads if key == "grads" else T.map_tree(
            lambda x: x / np.float32(1 - JAdamWConfig.b1), out["opt"]["m"])
        for a, b in zip(T.leaves(got), T.leaves(want)):
            assert a.dtype == torch.float32
            a = a.numpy()
            scale = max(np.abs(b).max(), 1e-30)
            assert np.abs(a - b).max() <= 2 ** -8 * scale, key
            off = np.abs(a - b) > 1e-3 * np.abs(b) + 1e-6 * scale
            assert off.mean() <= 1e-2, (key, off.mean())


def test_bf16_microbatch_params_match_reference(bf16_setup, monkeypatch):
    """The updated bf16 params: at lr 1e-2 from the first step, an update
    is about lr x sign(g), so a near-zero grad of the other sign moves an
    element 2 lr the other way.  At most 0.2% of a leaf's elements may
    differ at all, none by more than 2.5 lr."""
    cfg, state, tokens, new, _ = bf16_setup
    out, _, _ = _port_step_grads(monkeypatch, cfg, state, tokens, K=2)
    moved = 0
    for a, b, p0 in zip(T.leaves(out["params"]), T.leaves(new["params"]),
                        T.leaves(state["params"])):
        assert a.dtype == torch.bfloat16
        a, b = a.float().numpy(), np.asarray(b).astype(np.float32)
        d = np.abs(a - b)
        assert (d > 0).mean() <= 2e-3
        assert d.max() <= 2.5 * BIG_STEP["lr"]
        moved += int((b != np.asarray(p0).astype(np.float32)).sum())
    assert moved > 0


def test_single_batch_grads_stay_in_the_params_dtype(bf16_setup,
                                                     monkeypatch):
    cfg, state, tokens, _, _ = bf16_setup
    _, _, grads = _port_step_grads(monkeypatch, cfg, state, tokens, K=1)
    assert {g.dtype for g in T.leaves(grads)} == {torch.bfloat16}


@pytest.fixture(scope="module")
def bf16_acc_setup(bf16_setup):
    """The reference's step from bf16_setup's state with a bf16 gradient
    accumulator (`grad_dtype=jnp.bfloat16`, llama4's policy), K = 2, 4."""
    cfg, state, tokens, _, _ = bf16_setup
    jcfg = jax_config("phi3-mini-3.8b").smoke().replace(**BF16)
    out = {}
    for K in (2, 4):
        new, m = jax.jit(j_train_step(jcfg, JAdamWConfig(**BIG_STEP),
                                      microbatches=K,
                                      grad_dtype=jnp.bfloat16))(
            _j(state), {"tokens": jnp.asarray(tokens)})
        out[K] = jax.tree.map(np.asarray, new), m
    return out


@pytest.mark.parametrize("K", [2, 4])
def test_bf16_accumulator_matches_reference(bf16_setup, bf16_acc_setup,
                                            monkeypatch, K):
    """`grad_dtype=torch.bfloat16`: each slice's grads are added in fp32
    and rounded once to the bf16 accumulator, then divided by K, as the
    reference does.  The criteria of the two tests above, except that each
    grad is held within one bf16 step at its leaf's largest grad
    (2^(floor(log2 max) - 7)) where they hold 2^-8 of it: those grads
    reached AdamW in fp32, these in bf16, where two sums straddling a
    rounding boundary land one step apart (2^-8 to 2^-7 of the largest
    element)."""
    cfg, state, tokens, _, _ = bf16_setup
    new, jm = bf16_acc_setup[K]
    out, m, grads = _port_step_grads(monkeypatch, cfg, state, tokens, K=K,
                                     grad_dtype=torch.bfloat16)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    want = _step_grads(new)
    for a, b in zip(T.leaves(grads), T.leaves(want)):
        assert a.dtype == torch.bfloat16
        a = a.float().numpy()
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= 2.0 ** (np.floor(np.log2(scale)) - 7)
        off = np.abs(a - b) > 1e-3 * np.abs(b) + 1e-6 * scale
        assert off.mean() <= 1e-2, off.mean()
    for a, b in zip(T.leaves(out["params"]), T.leaves(new["params"])):
        d = np.abs(a.float().numpy() - np.asarray(b).astype(np.float32))
        assert (d > 0).mean() <= 2e-3
        assert d.max() <= 2.5 * BIG_STEP["lr"]


def test_fp32_four_microbatches_match_reference(setup):
    """K = 4 in fp32 (the accumulator is the grad buffers): the loss, the
    grad norm and the params, `m`, `v` as the K = 1 and 2 steps are held."""
    cfg, params, tokens, _ = setup
    jcfg = jax_config("phi3-mini-3.8b").smoke().replace(**SMOKE)
    start = jax.tree.map(np.asarray, j_init_state(_j(params)))
    new, jm = jax.jit(j_train_step(jcfg, JAdamWConfig(clip_norm=UNCLIPPED),
                                   microbatches=4))(
        _j(start), {"tokens": jnp.asarray(tokens)})
    want = jax.tree.map(np.asarray, new)
    out, m = make_train_step(cfg, AdamWConfig(clip_norm=UNCLIPPED),
                             microbatches=4)(
        train_state_from_reference(start),
        {"tokens": torch.from_numpy(tokens)})
    for k in ("total", "loss", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-3)
    for got, exp in ((out["params"], want["params"]),
                     (out["opt"]["m"], want["opt"]["m"]),
                     (out["opt"]["v"], want["opt"]["v"])):
        for a, b in zip(T.leaves(got), T.leaves(exp)):
            assert a.dtype == torch.float32
            _close(a.numpy(), b, 1e-5)


def test_bf16_embedding_grads_sum_in_compute_dtype(monkeypatch):
    """bf16 params under fp32 compute: the reference converts the
    embedding table, then gathers, so its backward adds the token grads in
    fp32 and rounds the table's grad to bf16 once.  The port gathers bf16
    rows then converts; its backward must still add in fp32
    (`transformer._EmbedLookup`): at 8 x 256 tokens over a 512-word vocab
    (32 occurrences a word), bf16 adds put about a fifth of the table's
    grads an ulp or more away.  K = 1, so these bf16 grads reach AdamW
    as they are on both sides."""
    jcfg = jax_config("phi3-mini-3.8b").smoke().replace(**BF16)
    cfg = get_config("phi3-mini-3.8b").smoke().replace(**BF16)
    params = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                          smoke_params(jcfg))
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab, (8, 256)).astype(np.int32)
    state = jax.tree.map(np.asarray, j_init_state(_j(params)))
    new, _ = jax.jit(j_train_step(jcfg, JAdamWConfig(**BIG_STEP)))(
        _j(state), {"tokens": jnp.asarray(tokens)})
    want = _step_grads(jax.tree.map(np.asarray, new))["embed"]["tok"]
    _, _, grads = _port_step_grads(monkeypatch, cfg, state, tokens, K=1)
    got = grads["embed"]["tok"]
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = np.abs(want).max()
    off = np.abs(got - want) > 1e-3 * np.abs(want) + 1e-6 * scale
    assert off.mean() <= 1e-2, off.mean()
