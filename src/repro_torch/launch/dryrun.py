"""Multi-pod dry run (port of `repro.launch.dryrun`): for every (arch x
shape x mesh) cell, one rank's step run on ``meta`` tensors proves what
the rank holds and extracts the roofline terms.  Nothing is allocated for
the full configs, no process group is made, and no card is needed: the
device is ``meta`` by design, not as a fallback.

    python -m repro_torch.launch.dryrun --both-meshes --out cells.jsonl
    python -m repro_torch.launch.dryrun --engine-cell

The reference lowers each cell with XLA and reads `memory_analysis`,
`cost_analysis` and the collectives of the partitioned HLO.  Here the
cell's step runs as the port runs it on one rank of a
`launch.mesh.RecordingMesh` of the production shape (a dimension is split
only where it divides, so every rank's shards have rank 0's shapes):

* **inputs** -- `specs.abstract_inputs` (the reference's per-device
  shapes), laid out as the port holds them: a training rank gets the
  whole batch and splits its rows itself; a serving rank holds its params
  in one arena (`placement.empty_store`) read through the gather
  (`placement.gathered`: every dimension `placement.local_dims` keeps --
  heads, KV heads, ff, vocab on model, a MoE layer's experts -- stays
  this rank's slice and is computed where it lives, the rest is gathered
  whole), and its own rows of the batch and of the cache: its KV heads
  where the heads split (`attention.head_split`), every position (GSPMD
  also splits kv_seq);
* **memory** -- `MemoryTally`, a dispatch mode, tallies the live ``meta``
  storages, each rounded up to the CUDA caching allocator's 512 B:
  ``arg_bytes`` the inputs' storages, ``out_bytes`` the outputs', of which
  ``alias_bytes`` are inputs updated in place, ``temp_bytes`` the highest
  tally above both, ``peak_bytes`` = arg + out + temp - alias, the highest
  tally;
* **FLOPs** -- `torch.utils.flop_counter.FlopCounterMode`; and
  ``bytes_accessed``, every op's input and output bytes summed (unfused);
* **collectives** -- the recording mesh's log through
  `hlo_stats.collective_stats`: per-op bytes, counts, mean groups and the
  ring model's link traffic.  Exchanges are recorded as a card a rank
  issues them (all-gathers; the serving gather is an int32 all-reduce).

Ops with a registry entry run their plain versions (``impl: "torch"``,
asked for by name): ``meta`` has no kernels.  There is no compile time;
``lower_s`` is the meta run's seconds.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..configs import get_config, get_train_policy, list_archs
from ..core import tree as T
from ..models.config import ModelConfig
from ..pshard import ShardingRules, use_mesh_and_rules
from .hlo_stats import collective_stats
from .mesh import RecordingMesh
from .specs import (SHAPES, ShapeSpec, _mem_len, arch_rules, cell_inputs,
                    microbatches, skip_reason)

__all__ = ["MemoryTally", "measure", "storage_bytes", "lower", "lower_cell",
           "run_cell", "engine_cell", "engine_store", "run_engine_cell",
           "production_mesh", "IMPL", "ALLOC_ROUND"]

#: the registry implementation every op runs on ``meta``
IMPL = "torch"
#: the CUDA caching allocator rounds every block up to this many bytes
ALLOC_ROUND = 512


def production_mesh(multi_pod: bool = False, rank: int = 0) -> RecordingMesh:
    """The reference's production shapes as a recording mesh: 16x16
    ("data", "model"), or 2x16x16 with a leading "pod" axis."""
    if multi_pod:
        return RecordingMesh((2, 16, 16), ("pod", "data", "model"), rank)
    return RecordingMesh((16, 16), ("data", "model"), rank)


def _rounded(n: int) -> int:
    return -(-int(n) // ALLOC_ROUND) * ALLOC_ROUND


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _storages(tree) -> Dict[int, int]:
    """{storage id: bytes rounded to `ALLOC_ROUND`} of `tree`'s tensors."""
    out = {}
    for x in _tensors(tree):
        st = x.untyped_storage()
        out[id(st)] = _rounded(st.nbytes())
    return out


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages under `tree`'s tensors, each
    rounded to `ALLOC_ROUND`: `measure`'s ``arg_bytes`` of a real rank's
    inputs, on any device."""
    return sum(_storages(tree).values())


class MemoryTally(TorchDispatchMode):
    """Tallies the live ``meta`` storages while active (module doc): a
    storage counts, rounded to `ALLOC_ROUND`, from the op that made it (or
    `hold`) until it is freed.  ``peak`` is the highest tally, ``accessed``
    every op's input and output bytes."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.accessed = 0
        self._held: Dict[int, weakref.finalize] = {}

    def hold(self, tree) -> int:
        """Count `tree`'s storages as live; returns their bytes."""
        before = self.live
        for x in _tensors(tree):
            self._track(x)
        return self.live - before

    def _track(self, x: torch.Tensor) -> None:
        if x.device.type != "meta":
            return
        st = x.untyped_storage()
        k = id(st)
        if k in self._held:
            return
        n = _rounded(st.nbytes())
        self.live += n
        self.peak = max(self.peak, self.live)
        self._held[k] = weakref.finalize(st, self._free, k, n)

    def _free(self, k: int, n: int) -> None:
        self.live -= n
        self._held.pop(k, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _flat(out)
        for x in _flat(args) + _flat(kwargs or {}) + outs:
            if x.device.type == "meta":
                self.accessed += _nbytes(x)
        for x in outs:
            self._track(x)
        return out


def _flat(x) -> list:
    """The tensors of an op's arguments or results (tensors, and lists,
    tuples and dicts of them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        out = []
        for y in x:
            if isinstance(y, torch.Tensor):
                out.append(y)
            elif isinstance(y, (list, tuple, dict)):
                out += _flat(y)
        return out
    if isinstance(x, dict):
        return _flat(list(x.values()))
    return []


def measure(thunk: Callable[[], Any], args: Any,
            log: Optional[list] = None) -> Dict[str, Any]:
    """Run `thunk` (one rank's step on ``meta`` tensors; `args` the inputs
    it reads, held by the caller) under `MemoryTally` and
    `FlopCounterMode`: the reference's memory, cost and collective keys
    (module doc).  `log`: the recording mesh's, whose new entries are the
    step's collectives."""
    from torch.utils.flop_counter import FlopCounterMode
    tally = MemoryTally()
    arg_bytes = tally.hold(args)
    args_held = _storages(args)
    n0 = len(log) if log is not None else 0
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with flops, tally:
        out = thunk()
    seconds = time.perf_counter() - t0
    outs = _storages([x for x in _tensors(out) if x.device.type == "meta"])
    out_bytes = sum(outs.values())
    alias_bytes = sum(n for k, n in outs.items() if k in args_held)
    temp_bytes = tally.peak - arg_bytes - (out_bytes - alias_bytes)
    stats = collective_stats(log[n0:] if log is not None else ())
    del out
    return {
        "impl": IMPL,
        "lower_s": round(seconds, 2),
        "arg_bytes": arg_bytes,
        "out_bytes": out_bytes,
        "temp_bytes": temp_bytes,
        "alias_bytes": alias_bytes,
        "peak_bytes": arg_bytes + out_bytes + temp_bytes - alias_bytes,
        "flops": float(flops.get_total_flops()),
        "bytes_accessed": float(tally.accessed),
        "collectives": {
            "per_op_bytes": stats.per_op_bytes,
            "per_op_count": stats.per_op_count,
            "per_op_group": stats.per_op_group,
            "link_traffic_bytes": stats.link_traffic_bytes(),
        },
    }


def _whole(tree: Any, shards: Any, mesh, rules) -> Any:
    """``meta`` tensors of the whole leaves of a Spec `tree` whose shards
    on `mesh` are `shards` (dtypes kept)."""
    from ..models.params import partition_specs
    from .shards import global_shape
    if mesh is None:
        return shards
    return T.map_tree(
        lambda s, x, spec: torch.empty(global_shape(x.shape, spec, mesh),
                                       dtype=x.dtype, device="meta"),
        tree, shards, partition_specs(tree, mesh, rules))


def _serving_params(cfg: ModelConfig, params: Any, mesh, rules):
    """(what a serving rank reads, its words): its shards of `params`
    (``meta``) in one arena, read as they are without a mesh, else through
    the gather of a store (`placement.gathered`: experts kept local)."""
    from ..core import arena
    from ..models.params import layout, partition_specs
    from ..models.transformer import model_specs
    from . import placement as PL
    specs = model_specs(cfg)
    gspec = layout(specs, cfg.cdtype)
    if mesh is None:
        words = torch.empty(gspec.n_words, dtype=torch.int32, device="meta")
        view, spec = arena.unpack(words, gspec), gspec
    else:
        store = PL.empty_store(gspec, T.leaves(partition_specs(
            specs, mesh, rules)), mesh, None, device="meta",
            keep=PL.local_dims(cfg, mesh, rules))
        words, view, spec = store.words, PL.gathered(store), store.spec
    got = [tuple(x.shape) for x in T.leaves(arena.unpack(words, spec))]
    want = [tuple(x.shape) for x in T.leaves(params)]
    if got != want:
        raise ValueError(f"the serving store's shards {got[:3]} are not the "
                         f"abstract inputs' {want[:3]}")
    return view, words


def lower(cfg: ModelConfig, shape: ShapeSpec, mesh=None,
          rules: Optional[ShardingRules] = None,
          policy: Optional[dict] = None, K: Optional[int] = None,
          opt_cfg=None) -> Tuple[Callable[[], Any], Any, Dict[str, Any]]:
    """(thunk, args, inputs): one rank's step of a `shape` cell of `cfg`
    on `mesh` (a `RecordingMesh`; None: one process) over ``meta`` inputs
    laid out as the port holds them (module doc).  Train: the sharded
    `make_train_step(param_pspecs, grad_dtype)` (one process's without a
    mesh), K the policy's clamped by `specs.microbatches` unless given;
    prefill and decode: `make_prefill_step` / `make_decode_step` on this
    rank's rows."""
    from ..data.synthetic import make_batch_specs
    from ..models.attention import head_split
    from ..models.params import abstractify, partition_specs
    from ..models.steps import (make_decode_step, make_prefill_step,
                                make_train_step)
    from ..models.transformer import cache_specs, model_specs
    from ..optim import AdamWConfig
    from .placement import row_split
    inp = cell_inputs(cfg, shape, mesh, rules, policy)
    rules = inp["rules"]
    mem_len = _mem_len(cfg, shape)
    if shape.kind == "train":
        policy = inp["policy"]
        if K is None:
            K = microbatches(policy["microbatches"], shape.batch, mesh)
        inp["K"] = K
        pspecs = partition_specs(model_specs(cfg), mesh, rules) \
            if mesh is not None else None
        step = make_train_step(cfg, opt_cfg or AdamWConfig(), microbatches=K,
                               param_pspecs=pspecs,
                               grad_dtype=getattr(torch, policy["grad_dtype"]))
        state = inp["state"]
        # every rank reads the whole batch and takes its rows of a slice
        batch = _whole(make_batch_specs(cfg, shape.batch, shape.seq,
                                        mem_len=mem_len),
                       inp["batch"], mesh, rules)

        def thunk():
            with use_mesh_and_rules(mesh, rules):
                return step(state, batch)
        return thunk, (state, batch), inp

    view, words = _serving_params(cfg, inp["params"], mesh, rules)
    pieces = 1
    rows = shape.batch
    if mesh is not None:
        sl, _, pieces = row_split(shape.batch, mesh, rules)
        rows = sl.stop - sl.start
    if shape.kind == "prefill":
        step = make_prefill_step(cfg)
        batch = abstractify(make_batch_specs(cfg, rows, shape.seq,
                                             mem_len=mem_len), None,
                            cfg.cdtype)

        def thunk():
            with torch.no_grad(), use_mesh_and_rules(mesh, rules,
                                                     batch_shards=pieces):
                return step(view, batch)
        return thunk, (words, batch), inp
    step = make_decode_step(cfg, logits=False)
    heads = cfg.n_kv
    if mesh is not None:
        with use_mesh_and_rules(mesh, rules):
            heads //= head_split(cfg)
    cache = abstractify(cache_specs(cfg, rows, shape.seq, mem_len=mem_len,
                                    heads=heads), None, cfg.cdtype)
    token = torch.empty((rows, 1), dtype=torch.int32, device="meta")

    def thunk():
        with torch.no_grad(), use_mesh_and_rules(mesh, rules,
                                                 batch_shards=pieces):
            return step(view, token, cache)
    return thunk, (words, token, cache), inp


def lower_cell(arch: str, shape_name: str, mesh,
               rules_extra: Optional[dict] = None):
    """(thunk, args, inputs) of the (arch, shape) cell on `mesh` (the
    reference's `lower_cell`): its serving rules for prefill and decode,
    its train policy."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    reason = skip_reason(cfg, shape)
    if reason:
        raise ValueError(f"{arch} x {shape_name} skipped: {reason}")
    rules = arch_rules(arch, rules_extra, serve=shape.kind != "train")
    policy = get_train_policy(arch) if shape.kind == "train" else None
    return lower(cfg, shape, mesh, rules, policy)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rules_extra: Optional[dict] = None) -> Dict[str, Any]:
    """One cell's record (the reference's keys; `measure`) on rank 0 of
    the production mesh."""
    mesh = production_mesh(multi_pod)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    reason = skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "skipped": reason}
    thunk, args, inp = lower_cell(arch, shape_name, mesh, rules_extra)
    res = measure(thunk, args, mesh.log)
    out = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
           "devices": mesh.size, "kind": shape.kind, "seq": shape.seq,
           "batch": shape.batch}
    if "K" in inp:
        out["microbatches"] = inp["K"]
    out.update(res)
    return out


def engine_cell(cfg: ModelConfig, scheme_spec: str, mesh, *, batch: int,
                prompt_len: int, gen: int,
                rules: Optional[ShardingRules] = None) -> Dict[str, Any]:
    """One rank's `GenerationEngine.generate` on `mesh` (a
    `RecordingMesh`; the parallel disciplines fold a ("data", "model")
    mesh's copy axis as the engine does) under `rules` over a ``meta``
    store of this rank's copy-stacked shards (`optim.copy_stack_pspec`;
    `placement.local_dims` kept local) and the whole batch of token ids;
    `measure`'s keys."""
    from ..reliability import parse_scheme
    from .engine import GenerationEngine
    engine = GenerationEngine(cfg, parse_scheme(scheme_spec, impl=IMPL),
                              gen=gen, mesh=mesh, rules=rules)
    store = engine_store(engine)
    tokens = torch.empty((batch, prompt_len), dtype=torch.int32,
                         device="meta")
    res = measure(lambda: engine.generate(store, {"tokens": tokens}),
                  (store.words, tokens), mesh.log)
    emesh = engine.exec_mesh
    return {"mesh": dict(emesh.shape), "devices": emesh.size, **res}


def engine_store(engine):
    """The ``meta`` store a rank of `engine`'s exec mesh holds: its slices
    of the copies it holds (`launch.placement`)."""
    from ..models.params import layout
    from ..models.transformer import model_specs
    from .placement import empty_store
    mesh = engine.exec_mesh
    specs, held = engine._placement(mesh)
    return empty_store(layout(model_specs(engine.cfg),
                              engine.cfg.param_dtype), specs, mesh, held,
                       device="meta", keep=engine.keep(mesh))


def run_engine_cell(arch: str, scheme_spec: str = "tmr-parallel",
                    batch: int = 20, prompt_len: int = 64,
                    gen: int = 8) -> Dict[str, Any]:
    """The sharded generation engine on the dedicated TMR serving mesh
    (copy=3 x data=5 x model=16, 240 cards; DESIGN.md §14): rank 0's
    generate over its copy-stacked store shard (the reference's
    `run_engine_cell`)."""
    mesh = RecordingMesh((3, 5, 16), ("copy", "data", "model"))
    res = engine_cell(get_config(arch), scheme_spec, mesh, batch=batch,
                      prompt_len=prompt_len, gen=gen)
    return {"arch": arch, "cell": "engine", "scheme": scheme_spec,
            "batch": batch, "prompt_len": prompt_len, "gen": gen, **res}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="run single-pod AND multi-pod")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    ap.add_argument("--rules", default=None,
                    help='JSON sharding-rule overrides, e.g. \'{"kv_seq": []}\'')
    ap.add_argument("--engine-cell", action="store_true",
                    help="run the sharded generation engine on the copy x "
                         "data x model TMR serving mesh instead of the "
                         "train/prefill/decode cells")
    ap.add_argument("--scheme", default="tmr-parallel",
                    help="protection scheme for --engine-cell")
    ap.add_argument("--jobs", type=int, default=1,
                    help="run the cells in this many processes (each cell "
                         "is one process's meta run; lines print as cells "
                         "finish)")
    args = ap.parse_args(argv)

    if args.engine_cell:
        arch = "phi3-mini-3.8b" if args.arch == "all" else args.arch
        tag = f"{arch} x engine[{args.scheme}] x 3x5x16"
        try:
            res = run_engine_cell(arch, args.scheme)
        except Exception as e:
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
            sys.exit(1)
        gb = res["peak_bytes"] / 2**30
        print(f"[ OK ] {tag}: peak {gb:.2f} GiB/dev, "
              f"collectives {res['collectives']['per_op_count']}, "
              f"meta run {res['lower_s']}s", flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(res) + "\n")
        sys.exit(0)

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    rules_extra = json.loads(args.rules) if args.rules else None

    cells = [(arch, shape, mp, rules_extra) for arch in archs
             for shape in shapes for mp in meshes]
    ok = True
    for res in _cells(cells, args.jobs):
        tag = (f"{res['arch']} x {res['shape']} x "
               f"{'2x16x16' if res['multi_pod'] else '16x16'}")
        if "error" in res:  # a failing cell is a bug in the port
            ok = False
            print(f"[FAIL] {tag}: {res['error']}", flush=True)
        elif "skipped" in res:
            print(f"[SKIP] {tag}: {res['skipped']}", flush=True)
        else:
            gb = res["peak_bytes"] / 2**30
            print(f"[ OK ] {tag}: peak {gb:.2f} GiB/dev, "
                  f"{res['flops']/1e12:.2f} TF/dev, "
                  f"meta run {res['lower_s']}s", flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(res) + "\n")
    sys.exit(0 if ok else 1)


def _cell(arch, shape, mp, rules_extra) -> Dict[str, Any]:
    try:
        return run_cell(arch, shape, mp, rules_extra)
    except Exception as e:
        return {"arch": arch, "shape": shape, "multi_pod": mp,
                "error": f"{type(e).__name__}: {e}"}


def _cells(cells, jobs: int):
    """Each cell's record, in order with one job, else as they finish
    (the training cells, the longest, start first)."""
    if jobs <= 1:
        for c in cells:
            yield _cell(*c)
        return
    import concurrent.futures as cf
    import multiprocessing as mp
    order = {"train": 0, "prefill": 1, "decode": 2}
    cells = sorted(cells, key=lambda c: order[SHAPES[c[1]].kind])
    with cf.ProcessPoolExecutor(jobs, mp_context=mp.get_context("spawn")
                                ) as pool:
        for f in cf.as_completed([pool.submit(_cell, *c) for c in cells]):
            yield f.result()


if __name__ == "__main__":
    main()
