"""The reference's side of the mesh tests (`tests/test_torch_mesh.py`,
`tests/test_torch_mesh_serve.py`): the micro config of
tests/test_sharded_engine.py, its parameters, prompt and fault masks
(drawn by JAX under the engine's ``fold_in(key, 100 + copy)``
convention), and the runs both packages make."""
import numpy as np

import jax

from repro.configs import get_config as j_get_config
from repro.core import arena as jarena
from repro.faults import TransientBitFlips as JFlips
from repro.models import params as JP
from repro.models import transformer as JT
from repro.reliability.scheme import parse_scheme as j_parse
from repro.reliability.scheme import standard_grid as j_grid
from repro_torch.configs import get_config
from repro_torch.reliability import (Compose, Tmr, parse_scheme,
                                     standard_grid)

P_BIT = 2e-3   # dense enough that ECC/vote counters are nonzero
B, PROMPT, GEN = 2, 4, 3
NB = 37        # not a multiple of the 4-way shard count
MESH_SCHEMES = ["ecc", "tmr-parallel", "ecc+tmr-serial"]
SPEC = dict(slots=2, page_tokens=8, chunk=3, prompt_buckets=(4, 8),
            gen_cap=6)
#: the grid plus the folded Compose with in-loop token and cache votes
EXTRA = [("ecc+tmr-parallel-votes", "ecc+tmr-parallel",
          dict(vote_every=1, vote_cache=True))]


def cfgs():
    kw = dict(n_layers=1, d_model=16, n_heads=2, n_kv=2, d_ff=32, vocab=512)
    return (j_get_config("phi3-mini-3.8b").smoke().replace(**kw),
            get_config("phi3-mini-3.8b").smoke().replace(**kw))


def masks(fault, key, jparams, copies):
    """The masks JAX's `prepare` applies: copy i under fold_in(key,
    100 + i), leaf j under split(., n_leaves)[j]."""
    leaves = jax.tree.leaves(jparams)
    out = []
    for i in range(copies):
        ks = jax.random.split(jax.random.fold_in(key, 100 + i), len(leaves))
        out += [np.asarray(fault.word_mask(k, jarena.leaf_to_words(x)))
                for k, x in zip(ks, leaves)]
    return out


def runs():
    """(name, port scheme, engine kwargs, reference scheme) of every
    engine run."""
    out = [(s.name, p, dict(gen=GEN), s)
           for s, p in zip(j_grid(), standard_grid())]
    for name, spec, kw in EXTRA:
        out.append((name, parse_scheme(spec), dict(gen=GEN, **kw),
                    j_parse(spec)))
    return out


def reference_setup():
    """The reference's parameters, prompt and fault masks (cheap: no
    engine runs)."""
    cfg_j, cfg = cfgs()
    key = jax.random.PRNGKey(0)
    jparams = JP.materialize(key, JT.model_specs(cfg_j))
    params_np = jax.tree.map(np.asarray, jparams)
    tokens = np.asarray(jax.random.randint(key, (B, PROMPT), 0, cfg.vocab),
                        np.int32)
    fault = JFlips(P_BIT)
    by_copies = {c: masks(fault, key, jparams, c) for c in (1, 3)}
    port_runs = [(name, scheme, kw,
                  by_copies[3 if isinstance(scheme, (Tmr, Compose)) else 1])
                 for name, scheme, kw, _ in runs()]
    rs = np.random.RandomState(0)
    prompts = {n: rs.randint(0, cfg.vocab, size=n).astype(np.int32)
               for n in (4, 8)}
    return dict(cfg=cfg, cfg_j=cfg_j, key=key, jparams=jparams,
                params_np=params_np, tokens=tokens, masks=by_copies,
                port_runs=port_runs, prompts=prompts)


def ops_inputs():
    rs = np.random.RandomState(3)
    words = rs.randint(0, 2**32, size=NB * 32, dtype=np.uint64) \
        .astype(np.uint32)
    bits = rs.random_sample((NB * 32, 32)) < 5e-4
    mask = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)) \
        .sum(axis=1).astype(np.uint32)
    return words, mask


# -- the training step (tests/test_torch_train_mesh.py) -------------------------

def smoke_params(jcfg, seed=0, std=0.02):
    """numpy params for the reference's spec tree (zeros where the spec
    says zeros, else normal(0, std)), float32."""
    from repro.models import transformer as JTr
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32) if s.init == "zeros"
        else (std * rng.standard_normal(s.shape)).astype(np.float32),
        JTr.model_specs(jcfg), is_leaf=lambda x: isinstance(x, JP.Spec))


def train_batch(cfg, B, S, seed=1):
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


def reference_train(jcfg, params, batch, K, policy, opt, steps):
    """The reference's single-device `make_train_step` (jitted) from
    `params` (numpy, float32) in the policy's dtypes, zero moments: the
    metrics of every step, the params and `m` after the first step and
    the params after the last (numpy; bf16 as float32)."""
    import jax.numpy as jnp
    from repro.models.steps import make_train_step as j_step
    from repro.optim import AdamWConfig as JAdamW
    pdt, odt = jnp.dtype(policy["param_dtype"]), jnp.dtype(policy["opt_dtype"])
    p = jax.tree.map(lambda a: jnp.asarray(a, pdt), params)
    state = {"params": p,
             "opt": {"m": jax.tree.map(lambda a: jnp.zeros(a.shape, odt), p),
                     "v": jax.tree.map(lambda a: jnp.zeros(a.shape, odt), p),
                     "count": jnp.zeros((), jnp.int32)}}
    step = jax.jit(j_step(jcfg, JAdamW(**opt), microbatches=K,
                          grad_dtype=jnp.dtype(policy["grad_dtype"])))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    host = lambda t: [np.asarray(x, np.float32) for x in jax.tree.leaves(t)]
    metrics, first = [], None
    for s in range(steps):
        state, m = step(state, jb)
        metrics.append({k: float(v) for k, v in m.items()})
        if s == 0:
            first = {"params": host(state["params"]),
                     "m": host(state["opt"]["m"])}
    return {"metrics": metrics, "first": first,
            "last": {"params": host(state["params"])},
            "count": int(state["opt"]["count"])}
