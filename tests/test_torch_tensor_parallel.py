"""Heads, ff and vocab computed where they live on a serving mesh: the
engine on (data, model) worlds of gloo ranks on the CPU, whose stores
keep every dimension split over ``model`` local (`placement.local_dims`)
-- column-parallel ``wq`` / ``wkv`` / ``w_up`` / ``head``, the packed
``[k | v]`` and ``[u | g]`` re-aligned, row-parallel ``wo`` / ``w_down``
summed in rank order, the greedy token from every rank's vocab columns.

* Worlds: phi3-mini's `smoke()` at 1x2 and 2x2 (its 4 heads and 4 KV
  heads split: 2 a rank), and llama4's `smoke()` under its serving rules
  at 2x2 (experts over data, ``ff`` over model, its one KV head: q, k, v
  gathered whole after the projections, ``wo`` still row-parallel), fp32
  compute, ECC with flips from a key.
* Against one process of the port (the same key; llama4's four rows in
  the mesh's two token groups): first-step and teacher-forced decode
  logits within 1e-5 of the largest, tokens equal, counters bit for bit.
* Across ranks: the residual stream after every layer of the prefill
  equal bit for bit on every rank of a model group.
* Against the reference's unmeshed prefill and decode steps (params from
  numpy, llama4 group by group): logits within 1e-4 of the largest.
* No rank reads a whole ``wq`` / ``wkv`` / ``wo`` / ``w_up`` /
  ``w_down`` / ``head``: every read is its ``1 / model`` slice.
* Units: the re-aligned pieces equal the whole product's columns, the
  vocab-parallel greedy equals `torch.argmax` (ties, padded columns,
  NaNs), the ordered sum has the same bits on every rank, and ``keep``
  from the rules equals `expert_dims` where only experts are local.

Two worlds (2 and 4 ranks), started while the reference runs.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _store_worker as SW
import _tp_worker as W
from _mesh_refs import smoke_params
from repro.configs import get_config as j_get_config
from repro.models.steps import make_decode_step as j_decode_step
from repro.models.steps import make_prefill_step as j_prefill_step
from repro_torch.configs import get_config, get_rules_overrides
from repro_torch.core import tree as T
from repro_torch.launch.engine import GenerationEngine
from repro_torch.launch.mesh import spawn
from repro_torch.launch.placement import expert_dims, local_dims
from repro_torch.models.transformer import model_specs
from repro_torch.pshard import DEFAULT_RULES, AbstractMesh, use_mesh_and_rules
from repro_torch.reliability import parse_scheme

B, PROMPT, GEN = 4, 8, 4
#: (case, arch, serving rules, meshes)
CASES = [("phi3", "phi3-mini-3.8b", False, [(1, 2), (2, 2)]),
         ("llama4", "llama4-maverick-400b-a17b", True, [(2, 2)])]
#: the leaves whose columns or rows the rules put on ``model``
SPLIT = ("wq", "wkv", "wo", "w_up", "w_down", "head")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as a rank runs: the one process's products
    then take the ranks' kernels."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _overrides(arch, serve):
    return get_rules_overrides(arch, serve=serve)


@pytest.fixture(scope="module")
def setup():
    out = {}
    for i, (case, arch, serve, meshes) in enumerate(CASES):
        kw = dict(compute_dtype="float32")
        jcfg = j_get_config(arch).smoke().replace(**kw)
        cfg = get_config(arch).smoke().replace(**kw)
        # weights at std 0.02, as the cross-checks draw them (ROADMAP C,
        # "Reference precision")
        params = smoke_params(jcfg, seed=20 + i)
        tokens = np.random.RandomState(i).randint(
            0, cfg.vocab, (B, PROMPT)).astype(np.int32)
        out[case] = dict(jcfg=jcfg, cfg=cfg, params=params,
                         jparams=jax.tree.map(jnp.asarray, params),
                         tokens=tokens, meshes=meshes,
                         overrides=_overrides(arch, serve), key=30 + i)
    return out


@pytest.fixture(scope="module")
def launched(setup):
    """A 2-rank world (1x2) and a 4-rank world (2x2), both started at
    once in the background."""
    def tasks(shape):
        cases = [(case, s["cfg"], s["overrides"], s["params"], s["tokens"],
                  GEN, s["key"]) for case, s in setup.items()
                 if shape in s["meshes"]]
        out = [("tp", shape, W.tensor_parallel, (cases,)),
               ("ex", shape, W.exchanges, (7,))]
        if shape == (2, 2):     # a model group of four over the same ranks
            out.append(("ex4", (1, 4), W.exchanges, (7,)))
        return out
    pool = ThreadPoolExecutor(2)
    futures = {shape: pool.submit(spawn, SW.world, shape[0] * shape[1],
                                  args=(shape, tasks(shape)), device="cpu")
               for shape in [(1, 2), (2, 2)]}
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def one_process(setup, launched):
    """Each case's engine run in one process (computed while the worlds
    run): the same key and faults; llama4's rows in the mesh's token
    groups (an ambient 2x2 mesh with no processes)."""
    out = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for case, s in setup.items():
            rules = DEFAULT_RULES.replace(**s["overrides"])
            eng = GenerationEngine(s["cfg"], parse_scheme(W.SCHEME), gen=GEN,
                                   device="cpu")
            with use_mesh_and_rules(AbstractMesh((2, 2), ("data", "model")),
                                    rules):
                out[case] = W.engine_run(eng, s["params"], s["tokens"], GEN,
                                         s["key"])
    finally:
        torch.set_num_threads(n)
    return out


@pytest.fixture(scope="module")
def reference(setup, launched):
    """The reference's unmeshed prefill and decode steps, teacher-forced
    on the one process's tokens (llama4's each token group alone): the
    logits of every step, (GEN, B, 1, V)."""
    out = {}
    for case, s in setup.items():
        groups = 2 if s["cfg"].family == "moe" else 1
        prefill = jax.jit(j_prefill_step(s["jcfg"], PROMPT + GEN))
        decode = jax.jit(j_decode_step(s["jcfg"]))
        out[case] = {"groups": groups, "prefill": prefill, "decode": decode}
    return out


def _ref_logits(setup, reference, case, tokens):
    s, r = setup[case], reference[case]
    per = B // r["groups"]
    rows = []
    for g in range(r["groups"]):
        sl = slice(g * per, (g + 1) * per)
        _, lg, cache = r["prefill"](s["jparams"],
                                    {"tokens": jnp.asarray(s["tokens"][sl])})
        steps = [np.asarray(lg)]
        for i in range(GEN - 1):
            _, lg, cache = r["decode"](s["jparams"],
                                       jnp.asarray(tokens[sl, i:i + 1]),
                                       cache)
            steps.append(np.asarray(lg))
        rows.append(np.stack(steps))
    return np.concatenate(rows, axis=1)


@pytest.fixture(scope="module")
def worlds(launched, one_process, reference):
    return {shape: f.result() for shape, f in launched.items()}


def _runs(setup, worlds):
    for case, s in setup.items():
        for shape in s["meshes"]:
            for k, r in enumerate(worlds[shape]):
                yield case, shape, k, r["tp"][case]


def test_ranks_equal_one_process(setup, one_process, worlds):
    """Tokens equal, counters bit for bit, logits within 1e-5 of the
    largest."""
    for case, shape, k, got in _runs(setup, worlds):
        want = one_process[case]
        what = f"{case} {shape} rank {k}"
        np.testing.assert_array_equal(got["tokens"], want["tokens"], what)
        assert set(got["stats"]) == set(want["stats"]), what
        for q, v in want["stats"].items():
            np.testing.assert_array_equal(got["stats"][q], v, f"{what} {q}")
        assert int(want["stats"]["ecc_corrected"]) > 0
        assert int(want["stats"]["ecc_uncorrectable"]) == 0
        assert len(np.unique(want["tokens"])) > 1
        tol = 1e-5 * np.abs(want["logits"]).max()
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                                   atol=tol, err_msg=what)


def test_residual_stream_equal_across_the_model_group(setup, worlds):
    """After every layer of the prefill, every rank of a model group
    holds the same residual stream to the bit."""
    for case, s in setup.items():
        for shape in s["meshes"]:
            ranks = worlds[shape]
            for d in range(shape[0]):
                group = [ranks[d * shape[1] + m]["tp"][case]["stream"]
                         for m in range(shape[1])]
                assert len(group[0]) == s["cfg"].n_layers
                for m, other in enumerate(group[1:], start=1):
                    for layer, (a, b) in enumerate(zip(group[0], other)):
                        np.testing.assert_array_equal(
                            a, b, f"{case} {shape} data {d} model {m} "
                                  f"layer {layer}")


def test_ranks_equal_reference(setup, reference, worlds):
    """Every step's logits within 1e-4 of the largest of the reference's
    unmeshed prefill and decode steps fed the same tokens."""
    for case, shape, k, got in _runs(setup, worlds):
        want = _ref_logits(setup, reference, case, got["tokens"])
        tol = 1e-4 * np.abs(want).max()
        np.testing.assert_allclose(got["logits"], want, rtol=0, atol=tol,
                                   err_msg=f"{case} {shape} rank {k}")


def test_no_rank_reads_a_whole_split_leaf(setup, worlds):
    """Every read of a leaf whose dimension the rules put on ``model`` is
    this rank's slice of it: 1 / model of the whole along that
    dimension; the largest storage allocated from that read to the next
    is under the whole layer's leaf; and every such leaf was read."""
    for case, shape, k, got in _runs(setup, worlds):
        specs = model_specs(setup[case]["cfg"])
        whole = dict(zip(T.paths(specs), T.leaves(specs)))
        seen = set()
        for path, shape_read, largest in got["reads"]:
            if path[-1] not in SPLIT:
                continue
            spec = whole[path]
            layer = 4 * int(np.prod(spec.shape[len(spec.shape)
                                               - len(shape_read):]))
            assert largest < layer, (case, shape, k, path, largest, layer)
            dims = [d for d, a in enumerate(spec.axes)
                    if a in ("heads", "kv_heads", "ff", "vocab")]
            lead = len(shape_read) - len(spec.shape)
            for d in dims:
                assert shape_read[d + lead] * shape[1] == spec.shape[d], \
                    (case, shape, k, path, shape_read)
            seen.add(path[-1])
        assert seen == set(SPLIT), (case, shape, k, seen)


@pytest.mark.parametrize("shape,task", [((1, 2), "ex"), ((2, 2), "ex"),
                                        ((2, 2), "ex4")],
                         ids=["1x2", "2x2", "1x4"])
def test_exchanges(worlds, shape, task):
    """The re-aligned ``[u | g]`` and ``[k | v]`` pieces equal the whole
    product's matching columns; the vocab-parallel greedy equals
    `torch.argmax` of the whole row; the ordered sum is the same bits on
    every rank of the model group (four parts on 1x4, whose order
    matters), in fp32 and bf16; in row chunks each gives one exchange's
    bits."""
    sums = {}
    for k, r in enumerate(worlds[shape]):
        ex = r[task]
        assert ex["ug"] and ex["kv"] and ex["chunked"], (shape, task, k)
        got, want = ex["greedy"]
        np.testing.assert_array_equal(got, want, f"{task} rank {k}")
        group = k // 2 if task == "ex" and shape == (2, 2) else 0
        sums.setdefault(group, []).append((ex["sum"], ex["sum_bf16"]))
    for parts in sums.values():
        for a, b in parts[1:]:
            np.testing.assert_array_equal(a, parts[0][0])
            np.testing.assert_array_equal(b, parts[0][1])


def test_keep_from_the_rules():
    """Where only the experts are local (llama4's serving rules on 4x1:
    ``model`` is one rank), ``keep`` from the rules is `expert_dims`; on
    2x2 it adds the heads, ff and vocab dimensions, never FSDP's
    ``model_dim`` over data, and a cross-attention or RG-LRU leaf keeps
    only its experts (none)."""
    cfg = get_config("llama4-maverick-400b-a17b")
    rules = DEFAULT_RULES.replace(**_overrides(cfg.name, True))
    specs = model_specs(cfg)
    assert local_dims(cfg, AbstractMesh((4, 1), ("data", "model")),
                      rules) == expert_dims(specs)
    keep = local_dims(cfg, AbstractMesh((2, 2), ("data", "model")), rules)
    for path, spec, dims in zip(T.paths(specs), T.leaves(specs), keep):
        axes = [spec.axes[d] for d in dims]
        assert set(axes) <= {"expert", "heads", "kv_heads", "ff", "vocab"}
        if path[-1] in SPLIT:
            assert {"heads", "kv_heads", "ff", "vocab"} & set(axes), path
    phi3 = get_config("phi3-mini-3.8b")
    mesh = AbstractMesh((2, 2), ("data", "model"))
    for path, spec, dims in zip(T.paths(model_specs(phi3)),
                                T.leaves(model_specs(phi3)),
                                local_dims(phi3, mesh, DEFAULT_RULES)):
        assert "model_dim" not in [spec.axes[d] for d in dims], path
    for arch in ("llama-3.2-vision-11b", "recurrentgemma-2b"):
        c = get_config(arch)
        for path, dims in zip(T.paths(model_specs(c)),
                              local_dims(c, mesh, DEFAULT_RULES)):
            if "xattn" in path or "temporal" in path:
                assert dims == (), path
