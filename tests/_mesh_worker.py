"""What each rank of a test world runs (`tests/test_torch_mesh.py`).

`launch.mesh.spawn` starts these in fresh processes (start method
``spawn``), which import this module by name: it imports torch and the
port only, so a rank never pays for JAX.  Each returns host values
(lists, numpy arrays) for the test process to hold against the JAX
package's single-device results.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.faults import FaultModel


class JaxMasks(FaultModel):
    """Hands the port the word masks JAX drew, in corruption order (a copy
    a rank does not hold pops its masks through `skip`)."""

    def __init__(self, masks):
        self.masks = list(masks)

    def word_mask(self, generator, words, dt=1.0):
        m = self.masks.pop(0)
        assert m.shape == tuple(words.shape)
        return torch.from_numpy(m.view(np.int32).copy())


def flip_parity(parity):
    """Flip bit 3 of every fifth parity word, in place (a numpy array or
    a tensor); returns it."""
    parity.reshape(-1)[::5] ^= 8
    return parity


def _host(stats):
    return {k: np.asarray(v) for k, v in stats.items()}


def sharded_ops(mesh, words, mask):
    """scrub_sharded (diagonal and Hsiao, with clean and with flipped
    parity rows) and inject_scrub_sharded on this world, beside each
    single launch on the same inputs."""
    from repro_torch.kernels.diag_parity import encode_parity, scrub
    from repro_torch.kernels.diag_parity import scrub_sharded
    from repro_torch.kernels.hsiao_secded import encode_hsiao
    from repro_torch.kernels.hsiao_secded import scrub as scrub_h
    from repro_torch.kernels.hsiao_secded import \
        scrub_sharded as scrub_sharded_h
    from repro_torch.kernels.inject_scrub import (inject_scrub,
                                                  inject_scrub_sharded)
    buf = torch.from_numpy(words.view(np.int32).copy())
    m = torch.from_numpy(mask.view(np.int32).copy())
    out = {}
    parity = encode_parity(buf)
    hparity = encode_hsiao(buf)
    for name, fn, par in (("diag", scrub, parity),
                          ("hsiao", scrub_h, hparity)):
        sharded = scrub_sharded if name == "diag" else scrub_sharded_h
        # the words' flips alone, then with parity rows flipped in every
        # rank's range (the parity's corrections join across ranks too)
        for tag, p in ((name, par), (name + "-parity",
                                     flip_parity(par.clone()))):
            one = fn((buf ^ m).clone(), p.clone())
            many = sharded((buf ^ m).clone(), p.clone(), mesh=mesh)
            out[tag] = [np.asarray(t) for t in one], \
                [np.asarray(t) for t in many]
    one = inject_scrub(buf.clone(), parity.clone(), m)
    many = inject_scrub_sharded(buf.clone(), parity.clone(), m, mesh=mesh)
    out["inject"] = [np.asarray(t) for t in one], \
        [np.asarray(t) for t in many]
    return out


def engine_grid(mesh, cfg, params_np, tokens, runs):
    """The port's engine on `mesh` for each (name, scheme, kwargs, masks):
    tokens, fetched telemetry, the exec mesh's axes, the copies held, and
    the elements of every leaf this rank holds; plus the host syncs of
    generate + fetch on the last run (the transfer guard)."""
    from repro_torch.launch.engine import GenerationEngine, fetch_telemetry
    from repro_torch.launch.placement import local_elements
    from repro_torch.models.params import from_numpy
    from repro_torch.obs import count_host_transfers
    batch = {"tokens": torch.from_numpy(tokens)}
    out = {}
    for name, scheme, kw, masks in runs:
        eng = GenerationEngine(cfg, scheme, device="cpu", mesh=mesh, **kw)
        store, prep = eng.prepare(from_numpy(params_np),
                                  fault=JaxMasks(masks))
        # the unmeshed store placed on the mesh afterwards: the same shard
        alone = GenerationEngine(cfg, scheme, device="cpu", **kw)
        placed = eng.shard_store(alone.prepare(from_numpy(params_np),
                                               fault=JaxMasks(masks))[0])
        with count_host_transfers() as ledger:
            toks, tel = eng.generate(store, batch)
            stats = fetch_telemetry({**prep, **tel})
        out[name] = {"tokens": np.asarray(toks), "stats": _host(stats),
                     "exec_axes": eng.exec_mesh.axis_names,
                     "exec_shape": eng.exec_mesh.shape,
                     "held": store.held,
                     "elements": local_elements(store),
                     "placed": torch.equal(placed.words, store.words),
                     "syncs": ledger.syncs}
    return out


def batcher_join(mesh, cfg, params_np, prompts, spec_kw, runs):
    """A request joining a live batch and the same request alone, through
    the batcher on `mesh`, per (scheme name, weight masks for the two
    prepares)."""
    from repro_torch.launch.batching import (BatchSpec, ContinuousBatcher,
                                             Request)
    from repro_torch.models.params import from_numpy
    from repro_torch.reliability import parse_scheme
    spec = BatchSpec(**spec_kw)
    out = {}
    for name, masks in runs:
        scheme = parse_scheme(name)
        b = ContinuousBatcher(cfg, scheme, spec, device="cpu", mesh=mesh)
        b.prepare(from_numpy(params_np), fault=JaxMasks(masks))
        reqs = [Request(0, prompts[8], 6, arrival_s=0.0),
                Request(1, prompts[4], 2, arrival_s=0.0),
                Request(9, prompts[8], 5, arrival_s=0.1)]
        res = {r.rid: r for r in b.run(reqs)}
        a = ContinuousBatcher(cfg, scheme, spec, device="cpu", mesh=mesh)
        a.prepare(from_numpy(params_np), fault=JaxMasks(masks))
        alone = a.run([Request(9, prompts[8], 5)])[0]
        out[name] = {"joined": (res[9].tokens, res[9].vote_disagreements),
                     "alone": (alone.tokens, alone.vote_disagreements),
                     "all": {k: v.tokens for k, v in res.items()}}
    return out


def world(device, shape, tasks):
    """One rank of a (data, model) world: the mesh, a registry psum and
    the TMR serving mesh's shape, then each task."""
    from repro_torch.launch.mesh import (fold_copy_axis, make_test_mesh,
                                         make_tmr_serving_mesh)
    from repro_torch.obs import DEFAULT_REGISTRY
    mesh = make_test_mesh(*shape, device=device)
    summed = DEFAULT_REGISTRY.psum(
        {"ecc_corrected": torch.tensor(mesh.rank + 1, dtype=torch.int32),
         "tmr_step_disagreements": torch.full((2,), mesh.rank)},
        mesh, mesh.axis_names)
    out = {"rank": mesh.rank, "coords": mesh.coords,
           "psum": {k: v.tolist() for k, v in summed.items()}}
    if shape[0] % 3 == 0:
        tmr = make_tmr_serving_mesh(3, shape[0] // 3, shape[1],
                                    device=device)
        out["tmr_mesh"] = (tmr.axis_names, tmr.shape,
                           fold_copy_axis(mesh).shape, tmr.coords)
    for name, fn, args in tasks:
        out[name] = fn(mesh, *args)
    return out


def _np(t):
    """A tensor's host copy (bf16 as float32: exact)."""
    t = t.detach().to("cpu", copy=True)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def train_runs(mesh, runs):
    """The sharded training step (`make_train_step(param_pspecs=...)`) on
    `mesh` for each run: dict(name, cfg, overrides, policy, K, params
    (numpy tree), batch (numpy dict), opt (AdamWConfig kwargs), steps,
    [save: a directory, the state saved after the last step; restore: mesh
    shapes to restore that snapshot onto]).  Returns per run the metrics
    of every step, this rank's params and `m` shards after the first step,
    its params, `m` and `v` shards after the last, its slices under both
    specs, the elements it holds, and each restore's shards and slices."""
    from repro_torch.checkpoint import Checkpointer, restore_resharded
    from repro_torch.core import tree as T
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.shards import plan_for, state_shardings
    from repro_torch.launch.specs import train_state
    from repro_torch.models.params import from_numpy
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import AdamWConfig
    from repro_torch.pshard import DEFAULT_RULES, use_mesh_and_rules
    out = {}
    for run in runs:
        t0 = time.perf_counter()
        cfg, policy = run["cfg"], run["policy"]
        rules = DEFAULT_RULES.replace(**run["overrides"])
        plan = plan_for(cfg, mesh, rules)
        batch = {k: torch.from_numpy(v) for k, v in run["batch"].items()}
        with use_mesh_and_rules(mesh, rules):
            state = train_state(from_numpy(run["params"]), cfg, mesh, rules,
                                policy)
            step = make_train_step(
                cfg, AdamWConfig(**run["opt"]), microbatches=run["K"],
                param_pspecs=plan.pspecs,
                grad_dtype=getattr(torch, policy["grad_dtype"]))
            metrics, first = [], None
            for s in range(run["steps"]):
                state, m = step(state, batch)
                metrics.append({k: float(v) for k, v in m.items()})
                if s == 0:
                    first = {k: [_np(x) for x in T.leaves(t)] for k, t in
                             (("params", state["params"]),
                              ("m", state["opt"]["m"]))}
        res = {"metrics": metrics, "first": first,
               "last": {k: [_np(x) for x in T.leaves(t)] for k, t in
                        (("params", state["params"]),
                         ("m", state["opt"]["m"]),
                         ("v", state["opt"]["v"]))},
               "count": int(state["opt"]["count"]),
               "pslices": [lp.pslice for lp in plan.leaves],
               "mslices": [lp.mslice for lp in plan.leaves],
               "held": {k: sum(x.numel() for x in T.leaves(t)) for k, t in
                        (("params", state["params"]),
                         ("m", state["opt"]["m"]),
                         ("v", state["opt"]["v"]))},
               "dtypes": sorted({str(x.dtype) for x in T.leaves(state)})}
        if run.get("save"):
            ck = Checkpointer(run["save"], async_save=False)
            ck.save(run["steps"], state, shardings=state_shardings(plan),
                    mesh=mesh)
            res["restored"] = {}
            for shape in run.get("restore", ()):
                other = make_test_mesh(*shape, device=mesh.device)
                oplan = plan_for(cfg, other, rules)
                got = restore_resharded(ck, state_shardings(oplan),
                                        mesh=other)
                res["restored"][shape] = {
                    "params": [_np(x) for x in T.leaves(got["params"])],
                    "m": [_np(x) for x in T.leaves(got["opt"]["m"])],
                    "count": int(got["opt"]["count"]),
                    "pslices": [lp.pslice for lp in oplan.leaves],
                    "mslices": [lp.mslice for lp in oplan.leaves]}
        res["seconds"] = time.perf_counter() - t0
        out[run["name"]] = res
    return out


def train_meshes(mesh, runs_by_shape):
    """`train_runs` on each (data, model) shape in turn, over the ranks of
    `mesh`'s world (its own shape first, the others as further meshes of
    the same ranks); returns {shape: its results}."""
    from repro_torch.launch.mesh import make_test_mesh
    out = {}
    for shape, runs in runs_by_shape.items():
        m = mesh if shape == tuple(mesh.sizes) else \
            make_test_mesh(*shape, device=mesh.device)
        out[shape] = train_runs(m, runs)
    return out
