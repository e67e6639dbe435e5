"""What each rank of the block-range build and expert-parallel test
worlds runs (`tests/test_torch_range_build.py`,
`tests/test_torch_expert_parallel.py`).

`launch.mesh.spawn` starts these in fresh processes, which import this
module by name: it imports torch and the port only, so a rank never pays
for JAX.  Each returns host values for the test process to check.
"""
from __future__ import annotations

import numpy as np
import torch


def micro_llama4():
    """llama4's `smoke()` cut narrower still: one dense + MoE pair of
    d_model 16 (4 experts, top-1, a shared expert), vocab 512."""
    from repro_torch.configs import get_config
    return get_config("llama4-maverick-400b-a17b").smoke().replace(
        n_layers=2, d_model=16, n_heads=2, n_kv=2, d_ff=32, moe_dff=32,
        vocab=512)


def _sources(route: str, cfg, dtype: str, seed: int):
    """(the mesh build's params source, the one-process params, a fresh
    fault source maker) of a route: ``key`` draws the params and the
    faults from `core.prng` keys (the rank fills its range alone), ``gen``
    from seeded generators (the whole clean arena in hand)."""
    from repro_torch.core import prng
    from repro_torch.launch.placement import KeyedParams
    from repro_torch.models import params as P
    from repro_torch.models.transformer import model_specs
    specs = model_specs(cfg)
    if route == "key":
        src = KeyedParams(specs, prng.key(seed, "cpu"), dtype, "cpu")
        return src, src.materialize, lambda: prng.key(seed + 100, "cpu")

    def params():
        return P.materialize(specs, torch.Generator().manual_seed(seed),
                             dtype, "cpu")
    return params(), params, \
        lambda: torch.Generator().manual_seed(seed + 100)


def range_builds(mesh, runs):
    """Per run (name, cfg, scheme spec, rules overrides, route, p_bit,
    dtype): this rank's store built from its block range on `mesh`, and
    the whole-arena build (one process's store, placed on the mesh):
    both local arenas, both counters, the copies held, the largest
    storage the build allocated and the whole store's bytes."""
    from repro_torch.core import prng
    from repro_torch.faults import TransientBitFlips
    from repro_torch.kernels.diag_parity import ref as diag_ref
    from repro_torch.kernels.hsiao_secded import ref as hsiao_ref
    from repro_torch.launch.engine import GenerationEngine, fetch_telemetry
    from repro_torch.launch.placement import LargestAllocation
    from repro_torch.pshard import DEFAULT_RULES
    from repro_torch.reliability import parse_scheme
    # the keyed draws and the plain block codes work in chunks whose
    # temporaries are fixed sizes (outputs do not depend on them); cut so
    # that the arena, not a chunk, is what the largest allocation weighs
    prng.CPU_CHUNK = 1 << 10
    diag_ref.CHUNK_BLOCKS = hsiao_ref.CHUNK_BLOCKS = 8
    out = {}
    for name, cfg, spec, overrides, route, p_bit, dtype in runs:
        scheme = parse_scheme(spec)
        rules = DEFAULT_RULES.replace(**overrides)
        src, whole, faults = _sources(route, cfg, dtype, 3)
        fault = TransientBitFlips(p_bit)
        eng = GenerationEngine(cfg, scheme, gen=2, device="cpu", mesh=mesh,
                               rules=rules)
        with LargestAllocation() as largest:
            store, prep = eng.prepare(src, generator=faults(), fault=fault)
        alone = GenerationEngine(cfg, scheme, gen=2, device="cpu")
        ref, ref_prep = alone.prepare(whole(), generator=faults(),
                                      fault=fault)
        placed = eng.shard_store(ref)
        copies = 3 if eng.copy_axis else 1
        out[name] = {
            "words": store.words.numpy().copy(),
            "placed": placed.words.numpy().copy(),
            "stats": {k: np.asarray(v) for k, v in
                      fetch_telemetry(prep).items()},
            "ref_stats": {k: np.asarray(v) for k, v in
                          fetch_telemetry(ref_prep).items()},
            "held": store.held, "largest": largest.bytes,
            "whole": copies * store.global_spec.n_words * 4}
    return out


def expert_parallel(mesh, cases):
    """`moe_apply` with the expert axis over data on `mesh` (a (n, 1)
    world): per case (name, cfg, params as numpy, x (n, S, D) float32),
    this rank's output on its row of x with its n-th of the experts, and
    its aux."""
    from repro_torch.models.moe import moe_apply
    from repro_torch.models.params import from_numpy
    from repro_torch.pshard import DEFAULT_RULES, use_mesh_and_rules
    rules = DEFAULT_RULES.replace(expert=("data",), model_dim=())
    n, k = mesh.size, mesh.rank
    out = {}
    for name, cfg, params, x in cases:
        p = from_numpy(params)
        el = cfg.moe_experts // n
        for leaf in ("w_up", "w_down"):
            p[leaf] = p[leaf][k * el:(k + 1) * el].clone()
        with torch.no_grad(), use_mesh_and_rules(mesh, rules,
                                                 batch_shards=n):
            y, aux = moe_apply(p, cfg, torch.from_numpy(x[k:k + 1]))
        out[name] = (y.numpy().copy(), float(aux))
    return out


def engine_ep(mesh, cfg, spec, p_bit, tokens, gen):
    """The engine on `mesh` under llama4's serving rules, its store built
    from a key (`KeyedParams`): tokens, counters, the experts this rank
    reads, and the exchanges of one generate."""
    from repro_torch.configs import get_rules_overrides
    from repro_torch.core import prng
    from repro_torch.faults import TransientBitFlips
    from repro_torch.launch.engine import GenerationEngine, fetch_telemetry
    from repro_torch.launch.mesh import collective_log
    from repro_torch.launch.placement import KeyedParams, gathered
    from repro_torch.models.transformer import model_specs
    from repro_torch.pshard import DEFAULT_RULES
    from repro_torch.reliability import parse_scheme
    rules = DEFAULT_RULES.replace(**get_rules_overrides(cfg.name,
                                                        serve=True))
    eng = GenerationEngine(cfg, parse_scheme(spec), gen=gen, device="cpu",
                           mesh=mesh, rules=rules)
    src = KeyedParams(model_specs(cfg), prng.key(5, "cpu"),
                      cfg.param_dtype, "cpu")
    store, prep = eng.prepare(src, generator=prng.key(105, "cpu"),
                              fault=TransientBitFlips(p_bit))
    with collective_log() as log:
        toks, tel = eng.generate(store, {"tokens": torch.from_numpy(tokens)})
    return {"tokens": toks.numpy().copy(),
            "stats": {k: np.asarray(v) for k, v in
                      fetch_telemetry({**prep, **tel}).items()},
            "experts": tuple(gathered(store)["layers"][0]["moe"]["w_up"]
                             .shape),
            "exchanges": [op for op, _, _ in log]}


def world(device, shape, tasks):
    """One rank of a world: a (data, model) mesh per task over the same
    ranks, then the task."""
    from repro_torch.launch.mesh import make_test_mesh
    out = {}
    meshes = {}
    for name, mesh_shape, fn, args in tasks:
        if mesh_shape not in meshes:
            meshes[mesh_shape] = make_test_mesh(*mesh_shape, device=device)
        out[name] = fn(meshes[mesh_shape], *args)
    return out
