"""The port's serving engine on a mesh against the JAX package's
single-device engine, on worlds of gloo ranks on the CPU
(`launch.mesh.spawn`: one process a rank, one intra-op thread each, a
`FileStore` in a fresh temporary directory).  The reference's own mesh
tests need forced host devices and fail on this jax (ROADMAP C); these
hold the port's mesh to the reference's single-device results instead,
bit for bit:

* the engine on the reference's MESHES (2, 1), (2, 2), (3, 1) for every
  `standard_grid()` scheme plus ecc+tmr-parallel with in-loop token and
  cache votes, at the reference's micro config and fault rate
  (tests/test_sharded_engine.py:33-41), the faults JAX's masks: tokens and
  every counter, with live counters asserted; every rank holds only its
  shard (local elements summed over ranks = global elements times the
  replication the specs give), and `shard_store` of the unmeshed store is
  that shard; one host sync for generate + fetch;
* `exec_mesh` folding on 3x1 (parallel and semi fold, serial does not;
  2x2 cannot), `make_tmr_serving_mesh`, `MetricsRegistry.psum`;
* MoE's token groups: G = 2 under a 2x1 ambient mesh against the
  reference's G = 1 applied to each group's tokens.

One world per mesh shape, the three started at once while the reference
runs.  The sharded scrub ops, the batcher and ``serve --mesh`` are in
tests/test_torch_mesh_serve.py.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _mesh_worker as W
from _mesh_refs import P_BIT, reference_setup, runs
from repro.configs import get_config as j_get_config
from repro.faults import TransientBitFlips as JFlips
from repro.launch.engine import GenerationEngine as JEngine
from repro.launch.engine import fetch_telemetry as j_fetch
from repro.models import params as JP
from repro_torch.configs import get_config
from repro_torch.launch.mesh import spawn
from repro_torch.models import transformer as PT
from repro_torch.pshard import AbstractMesh, spec_axes, spec_for

MESHES = [(2, 1), (2, 2), (3, 1)]


@pytest.fixture(scope="module")
def setup():
    return reference_setup()


@pytest.fixture(scope="module")
def launched(setup):
    """Every mesh shape's world, started at once in the background (one
    thread waits on each spawn), so the worlds and the reference's runs
    overlap."""
    s = setup
    engine = ("engine", W.engine_grid,
              (s["cfg"], s["params_np"], s["tokens"], s["port_runs"]))
    pool = ThreadPoolExecutor(len(MESHES))
    futures = {shape: pool.submit(spawn, W.world, shape[0] * shape[1],
                                  args=(shape, [engine]), device="cpu")
               for shape in MESHES}
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def refs(setup, launched):
    """The reference's single-device engine on every run (while the
    worlds run)."""
    s = setup
    out = {}
    for name, _, kw, jscheme in runs():
        eng = JEngine(s["cfg_j"], jscheme, **kw)
        store, prep = eng.prepare(s["jparams"], key=s["key"],
                                  fault=JFlips(P_BIT))
        toks, tel = eng.generate(store, {"tokens": jnp.asarray(s["tokens"])})
        out[name] = (np.asarray(toks), j_fetch({**prep, **tel}))
    return out


@pytest.fixture(scope="module")
def worlds(launched, refs):
    return {shape: f.result() for shape, f in launched.items()}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_engine_matches_reference(refs, worlds, shape):
    """Tokens and every counter equal the reference's single-device
    engine on every rank, for every scheme; one host sync a run."""
    assert int(refs["ecc"][1]["ecc_corrected"]) > 0
    assert int(refs["ecc+tmr-serial"][1]["ecc_corrected"]) > 0
    for r in worlds[shape]:
        for name, (ref_toks, ref_tel) in refs.items():
            got = r["engine"][name]
            np.testing.assert_array_equal(got["tokens"], ref_toks,
                                          err_msg=name)
            assert set(got["stats"]) == set(ref_tel), name
            for k in ref_tel:
                np.testing.assert_array_equal(got["stats"][k], ref_tel[k],
                                              err_msg=f"{name} {k}")
            assert got["syncs"] == 1, name
            assert got["placed"], f"{name}: shard_store != prepare's shard"


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_each_rank_holds_its_shard(setup, worlds, shape):
    """Local elements summed over the ranks equal the global elements
    times the replication factor each leaf's spec gives (copies held by
    every rank, or one copy group each on a folded mesh)."""
    cfg, ranks = setup["cfg"], worlds[shape]
    specs = PT.model_specs(cfg)
    from repro_torch.core import tree as T
    for name, _, _, _ in setup["port_runs"]:
        r0 = ranks[0]["engine"][name]
        m = AbstractMesh(tuple(r0["exec_shape"].values()),
                         tuple(r0["exec_axes"]))
        n_ranks = shape[0] * shape[1]
        want = 0
        for s in T.leaves(specs):
            spec = spec_for(s.shape, s.axes, m)
            shards = int(np.prod([m.shape[a] for e in spec
                                  for a in spec_axes(e)] or [1]))
            want += int(np.prod(s.shape)) * (n_ranks // shards)
        held = r0["held"]
        if held is not None:
            # three copies a rank unless folded (one copy a copy group)
            want *= len(held)
        assert sum(r["engine"][name]["elements"] for r in ranks) == want, \
            name


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_registry_psum_and_serving_meshes(worlds, shape):
    """`MetricsRegistry.psum` sums every rank's counters; the dedicated
    TMR serving mesh is the folded test mesh."""
    n = shape[0] * shape[1]
    for r in worlds[shape]:
        assert r["psum"] == {"ecc_corrected": n * (n + 1) // 2,
                             "tmr_step_disagreements": [n * (n - 1) // 2] * 2}
        if shape == (3, 1):
            names, tmr_shape, folded_shape, coords = r["tmr_mesh"]
            assert names == ("copy", "data", "model")
            assert tmr_shape == folded_shape == {"copy": 3, "data": 1,
                                                 "model": 1}
            assert coords["copy"] == r["rank"]


def test_exec_mesh_folding(worlds):
    r3 = worlds[(3, 1)][0]["engine"]
    assert r3["tmr-parallel"]["exec_axes"] == ("copy", "data", "model")
    assert r3["tmr-parallel"]["exec_shape"] == {"copy": 3, "data": 1,
                                                "model": 1}
    assert r3["tmr-semi-parallel"]["exec_axes"][0] == "copy"
    assert r3["ecc+tmr-parallel-votes"]["exec_axes"][0] == "copy"
    # serial runs one copy at a time: nothing to fold
    assert r3["tmr-serial"]["exec_axes"] == ("data", "model")
    assert r3["ecc+tmr-serial"]["held"] == (0, 1, 2)
    held = sorted(r["engine"]["tmr-parallel"]["held"]
                  for r in worlds[(3, 1)])
    assert held == [(0,), (1,), (2,)]
    # 2x2: data=2 cannot host three copies
    assert worlds[(2, 2)][0]["engine"]["tmr-parallel"]["exec_axes"] == \
        ("data", "model")


def test_moe_groups_under_a_mesh():
    """G = 2 under a 2x1 ambient mesh (the batch not split across
    processes) equals the port's own G = 1 on each half of the tokens bit
    for bit, and the reference's G = 1 on each half within the MoE tests'
    1e-4 (two frameworks' fp32 products); with the batch split in two,
    each process's tokens are one group (G = 1)."""
    from repro.models.moe import moe_apply as j_moe
    from repro.models.moe import moe_specs as j_moe_specs
    from repro_torch.models import moe as pmoe
    from repro_torch.models.params import from_numpy
    from repro_torch.pshard import use_mesh_and_rules
    jcfg = j_get_config("phi3.5-moe-42b-a6.6b").smoke().replace(
        compute_dtype="float32")
    cfg = get_config("phi3.5-moe-42b-a6.6b").smoke().replace(
        compute_dtype="float32")
    key = jax.random.PRNGKey(1)
    jp = JP.materialize(key, j_moe_specs(jcfg))
    x = np.array(jax.random.normal(jax.random.fold_in(key, 2),
                                   (4, 6, cfg.d_model)) / 16, np.float32)
    p = from_numpy(jax.tree.map(np.asarray, jp))
    mesh = AbstractMesh((2, 1), ("data", "model"))
    assert pmoe._dp_groups(24) == 1
    with use_mesh_and_rules(mesh):
        assert pmoe._dp_groups(24) == 2
        y, _ = pmoe.moe_apply(p, cfg, torch.from_numpy(x))
    with use_mesh_and_rules(mesh, batch_shards=2):
        assert pmoe._dp_groups(12) == 1
    halves = (x[:2], x[2:])
    own = torch.cat([pmoe.moe_apply(p, cfg, torch.from_numpy(h))[0]
                     for h in halves])
    np.testing.assert_array_equal(y.numpy(), own.numpy())
    want = np.concatenate([np.asarray(j_moe(jp, jcfg, jnp.asarray(h))[0])
                           for h in halves])
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-4, atol=1e-4)
