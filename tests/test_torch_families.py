"""The port's ssm, hybrid, vlm and encdec families (`repro_torch.models`)
against the JAX package's, at each arch's `smoke()` size and from the same
numpy weights (std 0.02; the specs' zeros and ones kept, every cross-
attention ``gate`` and the VLM's ``gate_mlp`` set to 1.0, since tanh(0)
would zero the whole cross path):

* `forward`'s hidden states and aux loss, in fp32 within 1e-4 (two
  frameworks' fp32 matmuls, and the SSD and RG-LRU scans summed in another
  order), and in bf16 within 5e-2 of the largest hidden value (the
  frameworks round at other places; measured at most 2e-2);
* `prefill`'s cache, leaf for leaf: the positions bit for bit, the K/V,
  conv tails and states within 1e-4, at a 40-token prompt (not a multiple
  of the SSD chunk of 16; past the hybrid's window of 32, so its ring is
  rolled, and its remainder layers run);
* 8 greedy decode steps: tokens bit for bit, logits within 1e-4;
* teacher forcing: the decode steps' logits equal `forward`'s over the
  extended sequence within 1e-4 (the chunked scan against the recurrence),
  also for the hybrid below its window, where the port keeps a ring of
  min(cache_len, window) slots (the reference keeps the prompt's);
* the loss within 1e-5 and the grads within 1e-3, through the train
  step's per-layer leaves, so every stack (``r_layers`` ... ``dec_layers``)
  gets its grads in place;
* at the reference's own fan-in init (`materialize`, key 0: what the CLIs
  and the card's phase 12 serve from), ssm and hybrid at 3 layers and a
  40-token prompt: prefill and 8 teacher-forced decode steps give the
  port's own `forward`'s logits within 1e-4 of the largest, and the
  reference's within 1e-4 (ssm), or (hybrid) within 2e-3, which is how
  far the reference's own op-by-op run (`jax.disable_jit`) lies from its
  compiled one (measured 6e-4 of 0.89, the port 7e-4), and within 1e-4
  with the reference's RG-LRU `_gates` swapped into the port.  That init
  puts a third of the RG-LRU's a_t within an ulp of 1, where
  sqrt(1 - a_t^2) keeps no correct digit in fp32
  (`test_torch_rglru.test_gates_at_the_fan_in_scale`): the gates are the
  one place the logits move by more than fp32 rounding, in the reference
  as in the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import params as JP
from repro.models import rglru as JR
from repro.models import transformer as JT
from repro.models.steps import make_decode_step as j_decode_step
from repro.models.steps import make_loss_fn as j_loss_fn
from repro.models.steps import make_prefill_step as j_prefill_step
from repro_torch.configs import get_config
from repro_torch.core import tree as T
from repro_torch.models import transformer as PT
from repro_torch.models import params as PP
from repro_torch.models import rglru as PR
from repro_torch.models.params import from_numpy
from repro_torch.models.steps import (_grad_leaves, make_decode_step,
                                      make_loss_fn, make_prefill_step)

ARCHS = {"ssm": "mamba2-130m", "hybrid": "recurrentgemma-2b",
         "vlm": "llama-3.2-vision-11b", "encdec": "seamless-m4t-medium"}
B, S, STEPS = 2, 40, 8
TOL = 1e-4
BF16_TOL = 5e-2
FAN_IN_TOL = 2e-3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def family_params(jcfg, seed=0, std=0.02):
    """numpy weights for the reference's spec tree: zeros and ones as the
    spec says, normal(0, std) else, and every gate at 1.0."""
    rng = np.random.default_rng(seed)
    specs = JT.model_specs(jcfg)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP.Spec))
    out = []
    for path, s in leaves:
        if path[-1].key in ("gate", "gate_mlp"):
            out.append(np.ones(s.shape, np.float32))
        elif s.init == "zeros":
            out.append(np.zeros(s.shape, np.float32))
        elif s.init == "ones":
            out.append(np.ones(s.shape, np.float32))
        else:
            out.append((std * rng.standard_normal(s.shape)).astype(
                np.float32))
    return jax.tree_util.tree_unflatten(jax.tree.structure(
        specs, is_leaf=lambda x: isinstance(x, JP.Spec)), out)


def family_batch(cfg, seed=1, S=S):
    """numpy tokens (B, S) and the family's stub modality input."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vis_emb"] = rng.standard_normal(
            (B, cfg.vis_tokens, cfg.vis_dim)).astype(np.float32)
    if cfg.family == "encdec":
        batch["enc_emb"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    return batch


def configs(family, **kw):
    jcfg = jax_config(ARCHS[family]).smoke().replace(
        compute_dtype="float32", **kw)
    cfg = get_config(ARCHS[family]).smoke().replace(
        compute_dtype="float32", **kw)
    return jcfg, cfg


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=list(ARCHS))
def family(request):
    """(family, cfgs, params, batch, the reference's forward, prefill and
    decode outputs)."""
    jcfg, cfg = configs(request.param)
    params = family_params(jcfg)
    batch = family_batch(cfg)
    jh, jaux = jax.jit(lambda p, b: JT.forward(p, jcfg, b))(params,
                                                              _j(batch))
    tok, logits, cache = jax.jit(j_prefill_step(jcfg, S + STEPS))(
        params, _j(batch))
    jcache = jax.tree.map(np.asarray, cache)
    dec = jax.jit(j_decode_step(jcfg))
    toks, lgs = [tok], [logits]
    for _ in range(STEPS):
        tok, logits, cache = dec(params, tok, cache)
        toks.append(tok)
        lgs.append(logits)
    ref = {"hidden": np.asarray(jh), "aux": float(jaux), "cache": jcache,
           "tokens": np.concatenate([np.asarray(t) for t in toks], 1),
           "logits": np.stack([np.asarray(x) for x in lgs])}
    return request.param, jcfg, cfg, params, batch, ref


def test_forward_matches_reference(family):
    fam, _, cfg, params, batch, ref = family
    with torch.no_grad():
        h, aux = PT.forward(from_numpy(params), cfg, _t(batch))
    assert tuple(h.shape) == (B, S, cfg.d_model)
    np.testing.assert_allclose(h.numpy(), ref["hidden"], rtol=TOL, atol=TOL)
    assert float(aux) == ref["aux"] == 0.0


def test_prefill_cache_matches_reference(family):
    fam, _, cfg, params, batch, ref = family
    with torch.no_grad():
        _, _, cache = make_prefill_step(cfg, S + STEPS)(from_numpy(params),
                                                        _t(batch))
    jcache = ref["cache"]
    assert T.paths(cache) == [tuple(k.key for k in p) for p, _ in
                              jax.tree_util.tree_flatten_with_path(jcache)[0]]
    for path, got, want in zip(T.paths(cache), T.leaves(cache),
                               jax.tree.leaves(jcache)):
        assert tuple(got.shape) == want.shape, path
        if path == ("pos",):
            assert got.dtype == torch.int32 and int(got) == int(want) == S
        else:
            assert got.dtype == (torch.float32), path
            np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                                       atol=TOL, err_msg=str(path))
    if fam == "hybrid":
        # past the window: a rolled ring of 32 slots (slot p % 32 holds
        # position p); the pattern (R, R, A) over 5 layers gives 4 R layers
        # (two in the remainder) and 1 A layer
        assert tuple(cache["k"].shape)[:3] == (1, B, cfg.local_window)
        assert tuple(cache["rg"]["h"].shape) == (4, B, cfg.lru_width)


def _decode(cfg, params, batch, steps=STEPS, cache_len=S + STEPS,
            forced=None):
    """Greedy (or forced) decode: (tokens (B, 1 + steps), logits)."""
    with torch.no_grad():
        tok, logits, cache = make_prefill_step(cfg, cache_len)(params, batch)
        toks, lgs = [tok], [logits]
        dec = make_decode_step(cfg)
        for i in range(steps):
            if forced is not None:
                tok = forced[:, i:i + 1]
            tok, logits, cache = dec(params, tok, cache)
            toks.append(tok)
            lgs.append(logits)
    return torch.cat(toks, 1).numpy(), torch.stack(lgs).numpy()


def test_greedy_decode_matches_reference(family):
    fam, _, cfg, params, batch, ref = family
    tok, logits = _decode(cfg, from_numpy(params), _t(batch))
    assert tok.dtype == np.int32 and tok.shape == (B, 1 + STEPS)
    np.testing.assert_array_equal(tok, ref["tokens"])
    np.testing.assert_allclose(logits, ref["logits"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("prompt", [S, 12], ids=["past-window", "short"])
def test_decode_matches_teacher_forcing(family, prompt):
    """Forced tokens through the decode steps give the logits `forward`
    gives over the extended sequence."""
    fam, _, cfg, params, _, _ = family
    p = from_numpy(params)
    batch = _t(family_batch(cfg, seed=3, S=prompt))
    forced = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (B, STEPS)).astype(np.int32))
    _, logits = _decode(cfg, p, batch, cache_len=prompt + STEPS,
                        forced=forced)
    ext = dict(batch, tokens=torch.cat([batch["tokens"], forced], 1))
    if fam == "encdec":
        # the encoder's memory is the prompt's frames in both runs
        ext["enc_emb"] = batch["enc_emb"]
    with torch.no_grad():
        h, _ = PT.forward(p, cfg, ext)
        full = (h @ p["embed"]["tok"].T if cfg.tie_embeddings
                else h @ p["embed"]["head"]).float()
    want = full[:, prompt - 1:prompt + STEPS].permute(1, 0, 2)[:, :, None]
    np.testing.assert_allclose(logits, want.numpy(), rtol=TOL, atol=TOL)


def _forward_logits(cfg, p, batch):
    with torch.no_grad():
        h, _ = PT.forward(p, cfg, batch)
        return (h @ p["embed"]["tok"].T if cfg.tie_embeddings
                else h @ p["embed"]["head"]).float()


def _reference_forced(jcfg, params, batch, forced, jit=jax.jit):
    """The reference's prefill and teacher-forced decode logits."""
    _, logits, cache = jit(j_prefill_step(jcfg, S + STEPS))(params,
                                                             _j(batch))
    dec = jit(j_decode_step(jcfg))
    out = [np.asarray(logits)]
    for i in range(STEPS):
        _, logits, cache = dec(params, jnp.asarray(forced[:, i:i + 1]),
                               cache)
        out.append(np.asarray(logits))
    return np.stack(out)


@pytest.mark.parametrize("fam", ["ssm", "hybrid"])
def test_fan_in_init_matches_reference(fam, monkeypatch):
    jcfg, cfg = configs(fam, n_layers=3)
    params = jax.tree.map(np.asarray, JP.materialize(
        jax.random.PRNGKey(0), JT.model_specs(jcfg)))
    batch = family_batch(cfg, seed=3)
    forced = np.random.default_rng(7).integers(
        0, cfg.vocab, (B, STEPS)).astype(np.int32)
    want = _reference_forced(jcfg, params, batch, forced)
    scale = np.abs(want).max()
    p = from_numpy(params)
    _, got = _decode(cfg, p, _t(batch), forced=torch.from_numpy(forced))
    ext = {"tokens": torch.from_numpy(np.concatenate(
        [batch["tokens"], forced], 1))}
    full = _forward_logits(cfg, p, ext)[:, S - 1:S + STEPS]
    np.testing.assert_allclose(got, full.permute(1, 0, 2)[:, :, None],
                               rtol=0, atol=TOL * scale)
    if fam == "ssm":
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)
        return
    with jax.disable_jit():
        eager = _reference_forced(jcfg, params, batch, forced,
                                  jit=lambda f: f)
    np.testing.assert_allclose(eager, want, rtol=0, atol=FAN_IN_TOL * scale)
    np.testing.assert_allclose(got, want, rtol=0, atol=FAN_IN_TOL * scale)
    gates = jax.jit(lambda wa, wi, lam, x: JR._gates(
        {"wa": wa, "wi": wi, "lam": lam}, x, jcfg))
    monkeypatch.setattr(PR, "_gates", lambda q, x, _: tuple(
        torch.from_numpy(np.array(y)) for y in gates(
            *(q[k].numpy() for k in ("wa", "wi", "lam")), x.numpy())))
    _, shared = _decode(cfg, p, _t(batch), forced=torch.from_numpy(forced))
    np.testing.assert_allclose(shared, want, rtol=0, atol=TOL * scale)


def test_bf16_forward_near_reference(family):
    fam, _, _, params, batch, ref = family
    jcfg, cfg = (c.replace(compute_dtype="bfloat16")
                 for c in configs(fam))
    jh, _ = jax.jit(lambda p, b: JT.forward(p, jcfg, b))(params, _j(batch))
    with torch.no_grad():
        h, _ = PT.forward(from_numpy(params), cfg, _t(batch))
    assert h.dtype == torch.bfloat16
    want = _np(jh)
    np.testing.assert_allclose(_np(h), want, rtol=0,
                               atol=BF16_TOL * np.abs(want).max())


def test_loss_and_grads_match_reference(family):
    fam, jcfg, cfg, params, batch, _ = family
    (jtotal, _), jgrads = jax.jit(jax.value_and_grad(
        j_loss_fn(jcfg), has_aux=True))(jax.tree.map(jnp.asarray, params),
                                        _j(batch))
    p = from_numpy(params)
    g = T.map_tree(torch.zeros_like, p)
    leaves = _grad_leaves(p, g)
    for k, depth in PT.STACKED.items():
        if k in p:
            assert isinstance(leaves[k], list)
            if depth == 2:
                assert isinstance(leaves[k][0], list)
    total, _ = make_loss_fn(cfg)(leaves, _t(batch))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-5)
    jg = jax.tree.leaves(jgrads)
    assert T.paths(g) == [tuple(k.key for k in path) for path, _ in
                          jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    for path, a, b in zip(T.paths(g), T.leaves(g), jg):
        b = np.asarray(b)
        np.testing.assert_allclose(
            a.numpy(), b, rtol=1e-3,
            atol=1e-3 * max(np.abs(b).max(), 1e-30), err_msg=str(path))
    for k in PT.STACKED:
        if k in g:
            assert all(bool(torch.isfinite(x).all())
                       and bool(x.abs().sum() > 0)
                       for x in T.leaves(g[k])), k


@pytest.mark.parametrize("fam", list(ARCHS))
def test_cache_specs_match_reference(fam):
    """`cache_specs` equals the reference's Spec tree (with a memory of 20
    for the cross K/V), and `materialize` keeps its pinned dtypes: the
    int32 position and the fp32 SSM state and RG-LRU h under a bf16
    default."""
    jcfg, cfg = configs(fam)
    want = JT.cache_specs(jcfg, 3, 50, mem_len=20)
    got = PT.cache_specs(cfg, 3, 50, mem_len=20)
    jleaves = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, JP.Spec))[0]
    assert T.paths(got) == [tuple(k.key for k in p) for p, _ in jleaves]
    for s, (_, j) in zip(T.leaves(got), jleaves):
        assert (s.shape, s.axes, s.init, s.dtype) == \
            (j.shape, j.axes, j.init, j.dtype)
    cache = PP.materialize(got, torch.Generator().manual_seed(0),
                           "bfloat16")
    for path, x in zip(T.paths(cache), T.leaves(cache)):
        pinned = {"pos": torch.int32, "state": torch.float32,
                  "h": torch.float32}.get(path[-1], torch.bfloat16)
        assert x.dtype == pinned and not bool(x.abs().sum()), path
