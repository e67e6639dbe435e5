"""Expert parallelism in the port's MoE (`models.moe._expert_parallel`):
where a serving store keeps the ``expert`` axis local, every rank's
dispatch buffers are gathered over the expert axes, each rank runs its
own experts on every token group's rows for them, and the rows go back.

* On a 4x1 gloo world on the CPU (experts over data, one row of the
  batch and one token group a rank), `moe_apply` with a rank's quarter
  of the experts equals one process holding every expert and the whole
  batch, which forms the same four token groups itself (`_dp_groups`
  under a 4x1 ambient mesh): llama4's `smoke()` (top-1, a shared expert)
  and phi3.5-moe's (top-2) at capacity factor 0.5 (tokens dropped),
  output bit for bit (the same products on the same per-expert shapes,
  one intra-op thread on both sides); a rank's aux equals the one
  process's on that rank's group.
* That one process's four-group output equals the reference's
  `moe_apply` without a mesh run group by group on each group's tokens
  (its capacity is then the group's, so the two are the same function),
  within the MoE tests' 1e-4 (two frameworks' fp32 products), and so do
  the aux losses, each group's, within 1e-5.
* The engine end to end on llama4's `smoke()` under its serving rules
  on the 4x1 world, its store built from a `core.prng` key: tokens and
  counters equal one process's with the same four token groups, every
  rank reads one of the four experts, and the exchanges include the
  dispatch all-gathers.

One world, started while the reference runs.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _store_worker as W
from repro.configs import get_config as j_get_config
from repro.models import params as JP
from repro.models.moe import moe_apply as j_moe
from repro.models.moe import moe_specs as j_moe_specs
from repro_torch.configs import get_config, get_rules_overrides
from repro_torch.launch.mesh import spawn
from repro_torch.models import moe as pmoe
from repro_torch.models.params import from_numpy
from repro_torch.pshard import DEFAULT_RULES, AbstractMesh, use_mesh_and_rules

#: (arch, capacity factor, tokens a group): phi3.5-moe's 96 tokens at
#: 0.5 put 12 assignments an expert on average against 8 slots
ARCHS = [("llama4-maverick-400b-a17b", 1.25, 6),
         ("phi3.5-moe-42b-a6.6b", 0.5, 96)]
N = 4
MESH = AbstractMesh((N, 1), ("data", "model"))
EP_RULES = DEFAULT_RULES.replace(expert=("data",), model_dim=())
#: the engine run: weight fault rate, prompt and decode steps
P_BIT, PROMPT, GEN = 1e-5, 8, 4


def _cfgs(arch, cf):
    kw = dict(compute_dtype="float32", capacity_factor=cf)
    return (j_get_config(arch).smoke().replace(**kw),
            get_config(arch).smoke().replace(**kw))


@pytest.fixture(scope="module")
def setup():
    cases, ref = [], {}
    for i, (arch, cf, seq) in enumerate(ARCHS):
        jcfg, cfg = _cfgs(arch, cf)
        key = jax.random.PRNGKey(10 + i)
        jp = JP.materialize(key, j_moe_specs(jcfg))
        x = np.array(jax.random.normal(jax.random.fold_in(key, 2),
                                       (N, seq, cfg.d_model)) / 16,
                     np.float32)
        params = jax.tree.map(np.asarray, jp)
        cases.append((arch, cfg, params, x))
        ref[arch] = (jcfg, jp)
    cfg = get_config("llama4-maverick-400b-a17b").smoke()
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, (N, PROMPT)) \
        .astype(np.int32)
    return {"cases": cases, "ref": ref, "engine_cfg": cfg, "tokens": tokens}


@pytest.fixture(scope="module")
def world(setup):
    tasks = [("ep", (N, 1), W.expert_parallel, (setup["cases"],)),
             ("engine", (N, 1), W.engine_ep,
              (setup["engine_cfg"], "ecc", P_BIT, setup["tokens"], GEN))]
    pool = ThreadPoolExecutor(1)
    future = pool.submit(spawn, W.world, N, args=((N, 1), tasks),
                         device="cpu")
    yield future
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def one_process(setup, world):
    """Every case's one-process output and aux with the four groups
    formed here, and each group's aux alone (one intra-op thread, as a
    rank runs; computed while the world runs)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for arch, cfg, params, x in setup["cases"]:
            p = from_numpy(params)
            with torch.no_grad():
                with use_mesh_and_rules(MESH, EP_RULES):
                    assert pmoe._dp_groups(x.shape[0] * x.shape[1]) == N
                    y, aux = pmoe.moe_apply(p, cfg, torch.from_numpy(x))
                with use_mesh_and_rules(MESH, EP_RULES, batch_shards=N):
                    group_aux = [float(pmoe.moe_apply(
                        p, cfg, torch.from_numpy(x[g:g + 1]))[1])
                        for g in range(N)]
            out[arch] = (y.numpy(), float(aux), group_aux)
        return out
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(world):
    return world.result()


@pytest.mark.parametrize("arch", [a for a, _, _ in ARCHS])
def test_expert_parallel_equals_one_process(setup, one_process, ranks, arch):
    y, _, group_aux = one_process[arch]
    for k, r in enumerate(ranks):
        got, aux = r["ep"][arch]
        np.testing.assert_array_equal(got, y[k:k + 1], err_msg=f"rank {k}")
        assert aux == group_aux[k], (k, aux, group_aux[k])


def test_low_capacity_drops_tokens(setup):
    """phi3.5-moe's case at capacity factor 0.5 drops assignments (the
    path with drops is exercised)."""
    arch, cfg, params, x = setup["cases"][1]
    p = from_numpy(params)
    xg = torch.from_numpy(x).reshape(N, -1, cfg.d_model)
    probs = torch.softmax(xg @ p["router"], dim=-1)
    _, idx = pmoe.route(cfg, probs)
    _, _, _, keep = pmoe.dispatch(idx, cfg.moe_experts,
                                  pmoe._capacity(cfg, xg.shape[1]))
    assert (~keep).any()


@pytest.mark.parametrize("arch", [a for a, _, _ in ARCHS])
def test_groups_equal_reference_group_by_group(setup, one_process, arch):
    """The four-group output equals the reference's `moe_apply` on each
    group's tokens alone within 1e-4; each group's aux within 1e-5."""
    jcfg, jp = setup["ref"][arch]
    x = setup["cases"][[a for a, _, _ in ARCHS].index(arch)][3]
    y, _, group_aux = one_process[arch]
    outs = [j_moe(jp, jcfg, jnp.asarray(x[g:g + 1])) for g in range(N)]
    want = np.concatenate([np.asarray(o[0]) for o in outs])
    np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(group_aux, [float(o[1]) for o in outs],
                               rtol=1e-5, atol=1e-5)


def test_engine_end_to_end(setup, ranks):
    """llama4's `smoke()` served on 4x1 under its serving rules, its
    store from a key: tokens and counters equal one process's (the same
    key, the same four token groups) on every rank."""
    from repro_torch.core import prng
    from repro_torch.faults import TransientBitFlips
    from repro_torch.launch.engine import GenerationEngine, fetch_telemetry
    from repro_torch.models import params as P
    from repro_torch.models.transformer import model_specs
    from repro_torch.reliability import parse_scheme
    cfg = setup["engine_cfg"]
    rules = DEFAULT_RULES.replace(**get_rules_overrides(cfg.name,
                                                        serve=True))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        eng = GenerationEngine(cfg, parse_scheme("ecc"), gen=GEN,
                               device="cpu")
        params = P.materialize(model_specs(cfg), prng.key(5, "cpu"),
                               cfg.param_dtype, "cpu")
        store, prep = eng.prepare(params, generator=prng.key(105, "cpu"),
                                  fault=TransientBitFlips(P_BIT))
        with use_mesh_and_rules(MESH, rules):
            toks, tel = eng.generate(
                store, {"tokens": torch.from_numpy(setup["tokens"])})
    finally:
        torch.set_num_threads(threads)
    stats = fetch_telemetry({**prep, **tel})
    assert int(stats["ecc_corrected"]) > 0
    assert len(set(toks.numpy().reshape(-1).tolist())) > 1
    for k, r in enumerate(ranks):
        got = r["engine"]
        np.testing.assert_array_equal(got["tokens"], toks.numpy(),
                                      err_msg=f"rank {k}")
        assert set(got["stats"]) == set(stats)
        for q, v in stats.items():
            np.testing.assert_array_equal(got["stats"][q], np.asarray(v),
                                          err_msg=f"rank {k} {q}")
        assert got["experts"][0] == cfg.moe_experts // N
        # two all-gathers a MoE layer a forward (the prefill and GEN - 1
        # decode steps)
        n_moe = cfg.n_layers // cfg.moe_every
        assert got["exchanges"].count("all-gather") == 2 * n_moe * GEN
