"""What each rank of a test world runs (`tests/test_torch_mesh.py`).

`launch.mesh.spawn` starts these in fresh processes (start method
``spawn``), which import this module by name: it imports torch and the
port only, so a rank never pays for JAX.  Each returns host values
(lists, numpy arrays) for the test process to hold against the JAX
package's single-device results.
"""
from __future__ import annotations

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
