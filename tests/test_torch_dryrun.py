"""The dry run (`repro_torch.launch.dryrun`) and its inputs against the JAX
package and against a real world of ranks, on the CPU.

* `specs.abstract_inputs` on every applicable (arch x shape) of the
  production meshes 16x16 and 2x16x16, and the TMR engine's copy-stacked
  store on 3x5x16, against the reference's `abstract_inputs` /
  `abstractify` + `copy_stack_pspec` on a `jax.sharding.AbstractMesh`:
  every leaf's whole shape, dtype and shard shape (`shard_shape`).  The
  reference's own dry run cannot be the oracle: its lowering fails on the
  installed JAX (ROADMAP C, `test_mini_dryrun_8_devices`).
* A `RecordingMesh` against four gloo ranks (`tests/_dryrun_worker.py`,
  one spawn for a 2x2 and a 4x1 mesh): every rank's recorded collectives
  (kind, result bytes, group), FLOPs and argument bytes equal what the
  real rank issued, counted and held in one training step.
* Phase 14 (d)'s four-card cell, phi3-mini at full width and depth on
  2x2, K = 1, batch 8 x 256: 680 collectives a rank a step, the count four
  H100 cards measured.
* `MemoryTally` against a hand count on a chain of ops whose live set is
  known.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import _dryrun_worker as W
from repro_torch.configs import DEFAULT_TRAIN_POLICY, get_config, list_archs
from repro_torch.core import tree as T
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as PS
from repro_torch.launch.mesh import RecordingMesh, fold_copy_axis, spawn
from repro_torch.pshard import (DEFAULT_RULES, AbstractMesh, named_sharding,
                                spec_for, to_placements)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
KEYS = ("state", "params", "batch", "cache", "token")


def _leaves_match(ref, port, what):
    import jax
    rl = jax.tree_util.tree_leaves_with_path(ref)
    pl = T.leaves(port)
    assert len(rl) == len(pl), what
    for (path, a), b in zip(rl, pl):
        assert b.device.type == "meta", (what, path)
        assert str(np.dtype(a.dtype)) == str(b.dtype).replace("torch.", ""), \
            (what, path, a.dtype, b.dtype)
        assert tuple(a.sharding.shard_shape(a.shape)) == tuple(b.shape), \
            (what, path, a.shape, b.shape)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_abstract_inputs_match_reference(arch, mesh):
    """Whole shape (the shard's, by `launch.shards.global_shape`), dtype
    and shard shape of every input leaf of every applicable shape."""
    from jax.sharding import AbstractMesh as JaxMesh

    from repro.launch import specs as RS
    from repro_torch.launch.shards import global_shape
    from repro_torch.models.params import partition_specs
    sizes, names = MESHES[mesh]
    jm, pm = JaxMesh(sizes, names), AbstractMesh(sizes, names)
    cfg = get_config(arch)
    n = 0
    for shape in PS.SHAPES:
        if PS.skip_reason(cfg, PS.SHAPES[shape]):
            with pytest.raises(ValueError):
                PS.abstract_inputs(arch, shape, pm)
            continue
        ref = RS.abstract_inputs(arch, shape, jm)
        got = PS.abstract_inputs(arch, shape, pm)
        assert [k for k in KEYS if k in ref] == [k for k in KEYS if k in got]
        assert got["cfg"] == cfg and got["shape"] == PS.SHAPES[shape]
        for k in KEYS:
            if k in ref:
                _leaves_match(ref[k], got[k], (arch, shape, mesh, k))
        # the shards' whole shapes are the reference's global shapes
        from repro_torch.models.transformer import model_specs
        params = got["state"]["params"] if "state" in got else got["params"]
        specs = partition_specs(model_specs(cfg), pm, got["rules"])
        ref_p = ref["state"]["params"] if "state" in ref else ref["params"]
        import jax
        for a, x, s in zip(jax.tree.leaves(ref_p), T.leaves(params),
                           T.leaves(specs)):
            assert global_shape(x.shape, s, pm) == tuple(a.shape)
        n += 1
    assert n == (4 if cfg.family in ("ssm", "hybrid") else 3)


def test_engine_store_matches_reference():
    """The 3x5x16 TMR engine's store: rank 0's copy-stacked shard of every
    leaf against the reference's `abstractify` + `copy_stack_pspec`."""
    import jax
    from jax.sharding import AbstractMesh as JaxMesh
    from jax.sharding import NamedSharding

    from repro.models.params import abstractify, partition_specs
    from repro.models.transformer import model_specs
    from repro.optim.sharding_rules import copy_stack_pspec
    from repro.pshard import DEFAULT_RULES as J_RULES
    from repro.configs import get_config as j_get_config
    from repro_torch.core import arena
    from repro_torch.launch.engine import GenerationEngine
    from repro_torch.reliability import parse_scheme
    jm = JaxMesh((3, 5, 16), ("copy", "data", "model"))
    jcfg = j_get_config("phi3-mini-3.8b")
    specs = model_specs(jcfg)
    one = abstractify(specs, jm, rules=J_RULES)
    pspecs = partition_specs(specs, jm, J_RULES)
    ref = jax.tree.map(
        lambda a, s: jax.ShapeDtypeStruct(
            (3,) + a.shape, a.dtype, sharding=NamedSharding(
                jm, copy_stack_pspec(s, jm, rules=J_RULES))), one, pspecs)
    mesh = RecordingMesh((3, 5, 16), ("copy", "data", "model"))
    eng = GenerationEngine(get_config("phi3-mini-3.8b"),
                           parse_scheme("tmr-parallel", impl=D.IMPL), gen=8,
                           mesh=mesh)
    store = D.engine_store(eng)
    assert store.held == (0,) and store.words.device.type == "meta"
    shards = T.unflatten(store.spec.paths, [
        x[None] for x in T.leaves(arena.unpack(store.words[0], store.spec))])
    _leaves_match(ref, shards, "engine store")


def test_named_sharding_is_the_placements_of_spec_for():
    from torch.distributed.tensor import Replicate, Shard
    mesh = AbstractMesh((2, 4), ("data", "model"))
    shape, logical = (8, 12), ("model_dim", "ff")
    assert named_sharding(shape, logical, mesh) == to_placements(
        spec_for(shape, logical, mesh), mesh) == [Shard(0), Shard(1)]
    assert named_sharding((3, 12), logical, mesh) == [Replicate(), Shard(1)]
    assert named_sharding(shape, logical) is None


def test_recording_mesh_groups_and_fold():
    mesh = RecordingMesh((6, 2), ("data", "model"), rank=7)
    assert mesh.coords == {"data": 3, "model": 1}
    assert mesh.group_ranks(("model",)) == (6, 7)
    assert mesh.group_ranks(("data",)) == (1, 3, 5, 7, 9, 11)
    assert mesh.group_ranks(("data", "model")) == tuple(range(12))
    assert mesh.index_in(("data",)) == 3 and mesh.group_size(()) == 1
    folded = fold_copy_axis(mesh)
    assert folded is fold_copy_axis(mesh)
    assert folded.sizes == (3, 2, 2) and folded.rank == 7
    assert folded.coords == {"copy": 1, "data": 1, "model": 1}
    x = torch.empty((4, 3), dtype=torch.bfloat16, device="meta")
    parts = folded.all_gather(x, ("copy",))
    folded.all_reduce(x, ("data", "model"))
    folded.barrier()
    assert len(parts) == 3 and all(p.device.type == "meta" for p in parts)
    assert mesh.log == [("all-gather", 72, 3), ("all-reduce", 24, 4),
                        ("barrier", 0, 12)]
    assert folded.all_gather(x, ()) == [x] and len(mesh.log) == 3
    # ranks sharing a card read their peers' staging: only their own
    # tensor is theirs, and the record is the same
    shared = RecordingMesh((2, 2), ("data", "model"), rank=2,
                           peer_views=True)
    y = torch.empty((64, 32), device="meta")
    r = D.measure(lambda: shared.all_gather(y, ("data", "model")), y,
                  shared.log)
    assert r["out_bytes"] == 8192 + 3 * 512
    assert shared.log == [("all-gather", 4 * 8192, 4)]
    parts = shared.all_gather(y, ("data", "model"))
    assert parts[2] is y and [p.shape for p in parts] == [y.shape] * 4
    assert fold_copy_axis(RecordingMesh((3, 1), ("data", "model"),
                                        peer_views=True)).peer_views


def test_memory_tally_hand_count():
    """A 1000-float argument (4000 B -> 4096), two temporaries of its size
    alive at once, a 0-d result; then an in-place update."""
    a = torch.empty(1000, device="meta")

    def chain():
        b = a * 2
        c = b + 1           # a, b, c live: the peak
        del b
        return c.sum()

    r = D.measure(chain, a)
    assert (r["arg_bytes"], r["out_bytes"], r["alias_bytes"]) == (4096, 512, 0)
    assert r["peak_bytes"] == 3 * 4096
    assert r["temp_bytes"] == 3 * 4096 - 4096 - 512
    assert r["bytes_accessed"] == 4 * 4000 + 4000 + 4
    assert r["flops"] == 0 and r["collectives"]["per_op_count"] == {}

    w = torch.empty((64, 32), device="meta")
    r = D.measure(lambda: a[:64].view(64, 1).mul_(w.sum(1, keepdim=True))
                  .add_((w @ w.T).sum(1, keepdim=True)), (a, w))
    assert r["arg_bytes"] == 4096 + 8192 and r["alias_bytes"] == 4096
    assert r["out_bytes"] == 4096
    # w.sum (512) is freed after the mul_; then w @ w.T (16384) and its
    # row sums (512) are alive at once
    assert r["peak_bytes"] == 4096 + 8192 + 16384 + 512
    assert r["flops"] == 2 * 64 * 32 * 64


def test_storage_bytes_counts_shared_storages_once():
    x = torch.zeros(1000)
    assert D.storage_bytes({"a": x, "b": x[10:], "c": torch.zeros(3)}) \
        == 4096 + 512


def _cases():
    phi3 = get_config("phi3-mini-3.8b").smoke().replace(
        compute_dtype="float32")
    mamba = get_config("mamba2-130m").smoke().replace(compute_dtype="float32")
    return [("phi3", phi3, 2, 8, 32), ("mamba2", mamba, 1, 4, 32)]


@pytest.fixture(scope="module")
def world():
    return spawn(W.train_cases, 4, args=(_cases(),), device="cpu")


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
@pytest.mark.parametrize("case", ["phi3", "mamba2"])
def test_recorder_equals_a_real_world(world, case, shape):
    """Each rank's dry run records the collectives its real step issued
    (kind, result bytes, group, in order), counts its FLOPs and its
    argument bytes."""
    name, cfg, K, B, S = next(c for c in _cases() if c[0] == case)
    for rank, real in enumerate(world):
        mesh = RecordingMesh(shape, ("data", "model"), rank)
        thunk, args, inp = D.lower(cfg, PS.ShapeSpec("t", "train", S, B),
                                   mesh, DEFAULT_RULES,
                                   dict(DEFAULT_TRAIN_POLICY), K)
        res = D.measure(thunk, args, mesh.log)
        got = real[(name, shape)]
        assert mesh.log == got["log"], (case, shape, rank)
        assert len(got["log"]) > 0
        assert res["flops"] == got["flops"] > 0
        assert res["arg_bytes"] == got["arg_bytes"]
        counts = {}
        for op, _, _ in got["log"]:
            counts[op] = counts.get(op, 0) + 1
        assert res["collectives"]["per_op_count"] == counts


def test_four_card_cell_records_680_collectives():
    """Phase 14 (d): phi3-mini at full width and depth, fp32 compute, on
    2x2 with K = 1 and batch 8 x 256: 680 collectives a rank a step, as
    four H100 cards counted them."""
    cfg = get_config("phi3-mini-3.8b").replace(compute_dtype="float32")
    mesh = RecordingMesh((2, 2), ("data", "model"), 0)
    thunk, args, _ = D.lower(cfg, PS.ShapeSpec("p14d", "train", 256, 8),
                             mesh, DEFAULT_RULES, dict(DEFAULT_TRAIN_POLICY),
                             K=1)
    res = D.measure(thunk, args, mesh.log)
    assert res["collectives"]["per_op_count"] == {"all-gather": 680}
    # fp32 params, m and v, each a quarter or a half of a leaf a rank
    assert 11.7e9 < res["arg_bytes"] < 11.8e9
    assert res["peak_bytes"] > res["arg_bytes"]


def test_cli_writes_the_reference_keys(tmp_path):
    out = tmp_path / "cells.jsonl"
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "mamba2-130m", "--shape", "decode_32k",
                "--both-meshes", "--out", str(out)])
    assert e.value.code == 0
    rows = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["multi_pod"] for r in rows] == [False, True]
    want = {"arch", "shape", "multi_pod", "devices", "kind", "seq", "batch",
            "lower_s", "arg_bytes", "out_bytes", "temp_bytes", "alias_bytes",
            "peak_bytes", "flops", "bytes_accessed", "collectives", "impl"}
    for r in rows:
        assert set(r) == want and r["impl"] == "torch"
        assert r["peak_bytes"] == (r["arg_bytes"] + r["out_bytes"]
                                   + r["temp_bytes"] - r["alias_bytes"])
        assert set(r["collectives"]) == {"per_op_bytes", "per_op_count",
                                         "per_op_group", "link_traffic_bytes"}
    assert [r["devices"] for r in rows] == [256, 512]
