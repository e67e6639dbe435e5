"""The port's training step on a mesh (`make_train_step(param_pspecs=...,
grad_dtype=...)`, `launch.shards`, `launch.specs.train_state`) against the
JAX package's single-device `make_train_step`, on worlds of gloo ranks on
the CPU (`launch.mesh.spawn`: one process a rank, one intra-op thread
each, a `FileStore` in a fresh temporary directory).  The reference's own
sharded step raises on this jax (`pshard.constrain`, ROADMAP C), so the
port's mesh is held to the reference's single-device step, the same
function, on the same params, batch, K and `grad_dtype`:

* worlds (2, 1), (2, 2) and (4, 1) (the last a second mesh over the
  (2, 2) world's ranks), one step of each run and three of the saved
  one: phi3-mini's smoke config in fp32 at K = 1 and 2 (the saved run);
  the MoE smoke (phi3.5-moe); the mamba2-130m and seamless-m4t-medium
  smoke configs under their `RULES_OVERRIDES`; llama4's smoke config at
  two layers under its bf16 `TRAIN_POLICY` (bf16 params, moments and
  accumulator; its K = 16 clamped as the reference's `lower_cell` clamps
  it, 16 on every world at batch 64);
* fp32: the loss of every step within 1e-5 relative, the grads that
  reach AdamW (its first `m` over 1 - b1) within 1e-5 of each leaf's
  largest, the params after the first step with at most 0.1% of a leaf's
  elements more than 1e-3 lr apart and none more than 2.5 lr, `count`
  exact.  bf16: the criteria of `test_torch_steps.py`'s fp32-accumulator
  bf16 tests (at most 1% of a leaf's grads outside rtol 1e-3, at most
  0.2% of a leaf's params apart at all, none by more than 2.5 lr),
  except that each grad is held within one bf16 step at the leaf's
  largest grad, 2^(floor(log2 max) - 7), where those hold
  2^-8 of it: the policy's accumulator and moments are bf16 (theirs
  were fp32), so two sums that straddle a rounding boundary land one
  step apart, which at the largest element is 2^-8 to 2^-7 of it (0.07%
  of elements differ, the worst by 0.00395 of the largest); the first
  loss within 1e-5 (and later ones within 1e-3: a bf16 param one ulp
  apart moves the next loss; the reference and the port's one-device
  step differ by 7.5e-5 there);
* every rank holds only its shards: the elements summed over the ranks
  equal each leaf's count times its spec's replication, and under
  mamba2's overrides on (4, 1) every rank's `m` and `v` are a quarter of
  its params (ZeRO-1 over wholly replicated params); the shards that
  several ranks hold are bit-identical after the last step (three for
  the saved run);
* `Checkpointer.save(shardings=)` then `restore_resharded` onto another
  mesh shape of the same world ((2, 2) -> (4, 1), (4, 1) -> (2, 2),
  (2, 1) -> (1, 2)): every rank's shards are the saved leaves' slices
  bit for bit; and a (1, 1) world restores the (2, 2) snapshot and takes
  one more step, equal bit for bit to one process's step from
  `restore_tensors`.

The step applies AdamW at lr 1e-2 from the first step with clipping out
of reach (the reference's jitted norm is 6e-4 off in fp32,
tests/test_torch_steps.py): Adam's first update is about lr x sign(g), so
a near-zero grad of the other sign moves an element 2 lr the other way.
The MoE configs' capacity is set out of reach: the reference's single
device runs one token group where the mesh runs one a rank (ROADMAP C,
"MoE token groups"), so a capacity drop would route by design otherwise.
"""
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import _mesh_worker as W
from _mesh_refs import reference_train, smoke_params, train_batch
from repro.configs import get_config as j_get_config
from repro_torch.configs import (get_config, get_rules_overrides,
                                 get_train_policy)
from repro_torch.core import tree as T
from repro_torch.launch.mesh import spawn
from repro_torch.models import transformer as PT
from repro_torch.pshard import AbstractMesh, DEFAULT_RULES, spec_axes
from repro_torch.models.params import partition_specs
from repro_torch.optim.sharding_rules import opt_spec_tree

MESHES = [(2, 1), (2, 2), (4, 1)]
#: the restore target of each world's snapshot (a mesh of the same ranks)
RESTORE = {(2, 1): (1, 2), (2, 2): (4, 1), (4, 1): (2, 2)}
OPT = dict(clip_norm=1e3, lr=1e-2, warmup_steps=0)
B1 = 0.9
#: steps of each run; the saved run takes three (its replicas are held
#: after three steps, then saved and restored)
STEPS = 1
SAVED_STEPS = 3
FP32 = dict(compute_dtype="float32")
#: (name, arch, config kwargs, K (None: the policy's, clamped), batch,
#: seq, rules overrides)
RUNS = [
    ("dense-k1", "phi3-mini-3.8b", dict(n_layers=2), 1, 4, 16, False),
    ("dense-k2", "phi3-mini-3.8b", dict(n_layers=2), 2, 4, 16, False),
    ("moe", "phi3.5-moe-42b-a6.6b", dict(n_layers=2, capacity_factor=8.0),
     2, 4, 16, False),
    ("ssm", "mamba2-130m", {}, 2, 4, 16, True),
    ("encdec", "seamless-m4t-medium", dict(n_layers=2), 2, 4, 16, True),
    ("bf16", "llama4-maverick-400b-a17b",
     dict(n_layers=2, capacity_factor=8.0), None, 64, 8, True),
]
#: the run whose snapshot is saved and restored
SAVED = "dense-k2"


def _steps(name):
    return SAVED_STEPS if name == SAVED else STEPS


def _configs(arch, kw):
    kw = dict(FP32, **kw)
    return (j_get_config(arch).smoke().replace(**kw),
            get_config(arch).smoke().replace(**kw))


def _policy(arch, own):
    """The arch's own train policy for the runs that ask for it, else the
    default fp32 policy."""
    return get_train_policy(arch) if own else get_train_policy(
        "phi3-mini-3.8b")


def _k(K, policy, B, shape):
    from repro_torch.launch.specs import microbatches
    if K is not None:
        return K
    return microbatches(policy["microbatches"], B,
                        AbstractMesh(shape, ("data", "model")))


@pytest.fixture(scope="module")
def setup():
    out = {}
    for name, arch, kw, K, B, S, own in RUNS:
        jcfg, cfg = _configs(arch, kw)
        policy = _policy(arch, own)
        out[name] = dict(jcfg=jcfg, cfg=cfg, policy=policy, K=K,
                         overrides=get_rules_overrides(arch) if own else {},
                         params=smoke_params(jcfg),
                         batch=train_batch(cfg, B, S))
    return out


def _runs(setup, shape, save_dir):
    runs = []
    for name, _, _, K, B, _, _ in RUNS:
        s = setup[name]
        run = dict(name=name, cfg=s["cfg"], overrides=s["overrides"],
                   policy=s["policy"], K=_k(K, s["policy"], B, shape),
                   params=s["params"], batch=s["batch"], opt=OPT,
                   steps=_steps(name))
        if name == SAVED:
            run.update(save=os.path.join(save_dir, f"{shape[0]}x{shape[1]}"),
                       restore=[RESTORE[shape]])
        runs.append(run)
    return runs


def _continue(dev, run, ckpt_dir):
    """One rank of a (1, 1) world: the snapshot restored onto it once the
    (2, 2) world has published it (a snapshot directory appears whole, by
    a rename), one more step."""
    import time
    from repro_torch.checkpoint import Checkpointer, restore_resharded
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.shards import plan_for, state_shardings
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import AdamWConfig
    from repro_torch.pshard import DEFAULT_RULES, use_mesh_and_rules
    mesh = make_test_mesh(1, 1, device=dev)
    plan = plan_for(run["cfg"], mesh, DEFAULT_RULES)
    deadline = time.monotonic() + 900
    while not (os.path.isdir(ckpt_dir)
               and Checkpointer(ckpt_dir).latest_step() is not None):
        assert time.monotonic() < deadline, "no snapshot from the 2x2 world"
        time.sleep(0.2)
    state = restore_resharded(Checkpointer(ckpt_dir), state_shardings(plan),
                              mesh=mesh)
    with use_mesh_and_rules(mesh, DEFAULT_RULES):
        step = make_train_step(run["cfg"], AdamWConfig(**run["opt"]),
                               microbatches=run["K"],
                               param_pspecs=plan.pspecs)
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in run["batch"].items()})
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state": [W._np(x) for x in T.leaves(state)]}


#: the worlds and the meshes each runs over its ranks, in order
WORLDS = {(2, 1): [(2, 1)], (2, 2): [(2, 2), (4, 1)]}


@pytest.fixture(scope="module")
def launched(setup):
    """Every world, started at once in the background (one thread waits
    on each spawn), so the worlds and the reference's runs overlap; the
    (1, 1) world waits for the (2, 2) snapshot."""
    tmp = tempfile.TemporaryDirectory(prefix="train-mesh-")
    pool = ThreadPoolExecutor(len(WORLDS) + 1)
    futures = {world: pool.submit(
        spawn, W.world, world[0] * world[1],
        args=(world, [("train", W.train_meshes, (
            {shape: _runs(setup, shape, tmp.name) for shape in shapes},))]),
        device="cpu")
        for world, shapes in WORLDS.items()}
    run = [r for r in _runs(setup, (2, 2), tmp.name) if r["name"] == SAVED][0]
    ckpt = os.path.join(tmp.name, "2x2")

    futures["continue"] = pool.submit(
        lambda: spawn(_continue, 1, args=(run, ckpt), device="cpu")[0])
    yield futures, run, ckpt
    pool.shutdown(wait=True)
    tmp.cleanup()


@pytest.fixture(scope="module")
def refs(setup, launched):
    """The reference's single-device step of every run at every K the
    worlds use (while the worlds run)."""
    out = {}
    for name, _, _, K, B, _, _ in RUNS:
        s = setup[name]
        for shape in MESHES:
            k = _k(K, s["policy"], B, shape)
            if (name, k) not in out:
                out[name, k] = reference_train(s["jcfg"], s["params"],
                                               s["batch"], k, s["policy"],
                                               OPT, _steps(name))
    return out


@pytest.fixture(scope="module")
def worlds(launched, refs):
    futures = launched[0]
    return {shape: [r["train"][shape] for r in futures[world].result()]
            for world, shapes in WORLDS.items() for shape in shapes}


def _global(ranks, name, key, which, slices_key, shape_of):
    """The whole leaves of `key` (params / m / v) from every rank's
    shards, asserting that the ranks holding one slice agree bit for
    bit."""
    out = []
    for i, full_shape in enumerate(shape_of):
        full = np.zeros(full_shape, np.float32)
        seen = {}
        for r in ranks:
            res = r[name]
            sl = tuple(res[slices_key][i])
            x = res[which][key][i]
            k = tuple((s.start, s.stop) for s in sl)
            if k in seen:
                np.testing.assert_array_equal(
                    x, seen[k], err_msg=f"{name} {key} leaf {i}: replicas "
                    f"of one shard differ")
            seen[k] = x
            full[sl] = x
        out.append(full)
    return out


def _shapes(cfg):
    return [tuple(s.shape) for s in T.leaves(PT.model_specs(cfg))]


def _ids(x):
    return f"{x[0]}x{x[1]}" if isinstance(x, tuple) else str(x)


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
@pytest.mark.parametrize("run", [r[0] for r in RUNS])
def test_step_matches_reference(setup, refs, worlds, shape, run):
    """Losses, the grads that reach AdamW and the updated params against
    the reference's single-device step (module doc)."""
    s = setup[run]
    K, B = [(r[3], r[4]) for r in RUNS if r[0] == run][0]
    k = _k(K, s["policy"], B, shape)
    ref = refs[run, k]
    ranks = worlds[shape]
    bf16 = s["policy"]["param_dtype"] == "bfloat16"
    shapes = _shapes(s["cfg"])
    for r in ranks:
        got = r[run]
        assert got["count"] == ref["count"] == _steps(run)
        for st, (a, b) in enumerate(zip(got["metrics"], ref["metrics"])):
            tol = 1e-3 if bf16 and st else 1e-5
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=tol,
                                       err_msg=f"{run} step {st}")
        np.testing.assert_allclose(got["metrics"][0]["grad_norm"],
                                   ref["metrics"][0]["grad_norm"],
                                   rtol=1e-2 if bf16 else 1e-3)
    m = _global(ranks, run, "m", "first", "mslices", shapes)
    p = _global(ranks, run, "params", "first", "pslices", shapes)
    for i, (gm, rm, gp, rp, p0) in enumerate(zip(
            m, ref["first"]["m"], p, ref["first"]["params"],
            T.leaves(s["params"]))):
        g, want = gm / np.float32(1 - B1), rm / np.float32(1 - B1)
        scale = max(np.abs(want).max(), 1e-30)
        dg = np.abs(g - want)
        if bf16:
            # one bf16 step at the leaf's largest grad (module doc)
            assert dg.max() <= 2.0 ** (np.floor(np.log2(scale)) - 7), (run, i)
            off = dg > 1e-3 * np.abs(want) + 1e-6 * scale
            assert off.mean() <= 1e-2, (run, i, off.mean())
        else:
            assert dg.max() <= 1e-5 * scale, (run, i)
        d = np.abs(gp - rp)
        lr = OPT["lr"]
        assert d.max() <= 2.5 * lr, (run, i, d.max())
        if bf16:
            assert (d > 0).mean() <= 2e-3, (run, i, (d > 0).mean())
        else:
            assert (d > 1e-3 * lr).mean() <= 1e-3, (run, i)


def _replication(specs_tree, cfg, shape, rules):
    m = AbstractMesh(shape, ("data", "model"))
    n = shape[0] * shape[1]
    total = 0
    for s, sp in zip(T.leaves(PT.model_specs(cfg)),
                     T.leaves(partition_specs(specs_tree, m, rules))):
        shards = int(np.prod([m.shape[a] for e in sp
                              for a in spec_axes(e)] or [1]))
        total += int(np.prod(s.shape)) * (n // shards)
    return total


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_each_rank_holds_its_shards(setup, worlds, shape):
    """Elements held summed over the ranks = every leaf's count times its
    spec's replication, for the params and for each moment; the dtypes
    are the policy's; mamba2's moments are a quarter of its params."""
    for name, _, _, _, _, _, _ in RUNS:
        s = setup[name]
        rules = DEFAULT_RULES.replace(**s["overrides"])
        specs = PT.model_specs(s["cfg"])
        held = [r[name]["held"] for r in worlds[shape]]
        assert sum(h["params"] for h in held) == _replication(
            specs, s["cfg"], shape, rules), name
        for key in ("m", "v"):
            assert sum(h[key] for h in held) == _replication(
                opt_spec_tree(specs), s["cfg"], shape, rules), (name, key)
        want = {str(getattr(torch, s["policy"]["param_dtype"])),
                str(getattr(torch, s["policy"]["opt_dtype"])), "torch.int32"}
        assert set(worlds[shape][0][name]["dtypes"]) == want, name
    if shape == (4, 1):
        for r in worlds[shape]:
            h = r["ssm"]["held"]
            assert 4 * h["m"] == 4 * h["v"] == h["params"], h


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_replicas_stay_bit_identical(setup, worlds, shape):
    """After the last step (three for the saved run, one for the others)
    every shard that several ranks hold is the same bits on each of them
    (params, m and v)."""
    for name, _, _, _, _, _, _ in RUNS:
        shapes = _shapes(setup[name]["cfg"])
        for key, sl in (("params", "pslices"), ("m", "mslices"),
                        ("v", "mslices")):
            _global(worlds[shape], name, key, "last", sl, shapes)


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_restore_resharded_onto_another_mesh(setup, worlds, shape):
    """The snapshot saved from `shape` restored onto RESTORE[shape]: every
    rank's shards are the saved leaves' slices bit for bit."""
    shapes = _shapes(setup[SAVED]["cfg"])
    ranks = worlds[shape]
    saved = {key: _global(ranks, SAVED, key, "last", sl, shapes)
             for key, sl in (("params", "pslices"), ("m", "mslices"))}
    for r in ranks:
        got = r[SAVED]["restored"][RESTORE[shape]]
        assert got["count"] == SAVED_STEPS
        for key, sl in (("params", "pslices"), ("m", "mslices")):
            for i, (x, s) in enumerate(zip(got[key], got[sl])):
                np.testing.assert_array_equal(x, saved[key][i][tuple(s)],
                                              err_msg=f"{key} leaf {i}")


def test_restored_step_equals_one_process(launched, worlds):
    """The (2, 2) snapshot restored onto a (1, 1) world and stepped once
    equals one process's step from `restore_tensors`, bit for bit."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import AdamWConfig
    futures, run, ckpt = launched
    got = futures["continue"].result()
    state = Checkpointer(ckpt).restore_tensors()
    torch.set_num_threads(1)
    state, m = make_train_step(run["cfg"], AdamWConfig(**run["opt"]),
                               microbatches=run["K"])(
        state, {k: torch.from_numpy(v) for k, v in run["batch"].items()})
    for k, v in m.items():
        assert got["metrics"][k] == float(v), k
    for a, b in zip(got["state"], T.leaves(state)):
        np.testing.assert_array_equal(a, W._np(b))
