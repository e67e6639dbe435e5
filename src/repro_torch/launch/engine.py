"""Generation engine: prefill + greedy decode under a protection scheme
(port of `repro.launch.engine.GenerationEngine`).

* **store** -- `prepare` builds the serving store from clean parameters.
  One exposure of the fault model hits every held data copy, then the
  scheme's storage-side protection runs: ECC scrubs the corrupted copy,
  `Compose` scrubs all three copies in ONE fused launch against the clean
  arena's parity, TMR keeps the three copies.  Copies live in one
  contiguous (3, n_words) arena whose per-leaf (3, *shape) views are the
  store; corrupt and scrub work in place on it (the reference's pack ->
  corrupt -> pack -> scrub -> unpack chain holds two to three extra copies,
  which would not fit one card at phi3-mini width).
* **generation** -- the reference's `lax.scan` over decode steps is a
  Python loop here.  'parallel'/'semi' TMR loop over the three copies
  inside each step and vote the token ids (and, with `vote_cache`, every
  leaf of the decode caches) every `vote_every` steps on the reference's
  schedule ``(step + 1) % vote_every == 0``; 'serial' runs three
  single-copy generations and votes the sequences part by part
  (elementwise, so the final-sequence vote).  What is held against the
  reference is tokens and counters, not the launch shape.
* **chunked generation** -- `generate_chunked` runs the decode steps in
  chunks of the reference's `_chunk_sizes` schedule and marks a
  `LatencyTimeline` after each chunk lands (a `torch.cuda.synchronize()`
  and a clock read, no data transfer): the first mark is TTFT, the rest
  feed the TPOT samples.  The global step offset is threaded through the
  chunks, so the vote schedule, the tokens and the counters are the
  unchunked run's.
* **telemetry** -- scrub counts, per-step and final TMR disagreements and
  `tokens_emitted` stay on the device; `fetch_telemetry` moves them to the
  host in one transfer after timing.  With `cost_spec` (a
  `costmodel.DeviceSpec`) the telemetry also carries the `mmpu_*` gauges of
  `mmpu_projection`, an mMPU event stream compiled on the host once per
  batch size.
* **mesh** -- constructed with ``mesh=`` (a `launch.mesh.Mesh`; this
  process is one of its ranks), `prepare` places the store by the
  logical-axis rules, each rank holding only its slice of every leaf, and
  runs every arena scrub on the rank's block range with summed counters
  (`launch.placement`).  The batch is split over the batch axes.  Every
  axis the rules put on a mesh axis that no batch axis shares (heads,
  KV heads, ff, vocab on model), and a MoE layer's experts, are computed
  where they live (`placement.local_dims`; column- and row-parallel
  products summed in rank order, the KV cache a rank's own heads, the
  greedy token from every rank's vocab columns); the rest of each leaf
  is gathered whole when a layer reads it (FSDP).  The parallel and semi
  disciplines fold the copy axis onto data-replica groups when ``data %
  3 == 0`` (`launch.mesh.fold_copy_axis`): each copy
  group runs its own copy's forward, and the per-step token ids (and, with
  `vote_cache`, the caches) are gathered over the copy axis into the
  `tmr_vote` kernel.  Tokens and counters equal the unmeshed engine's
  under the same generator.

    engine = GenerationEngine(cfg, scheme, gen=32, device="cuda")
    store, prep = engine.prepare(params, generator=g, fault=model)
    tokens, telem = engine.generate(store, batch)
    stats = fetch_telemetry({**prep, **telem})
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from ..core import arena
from ..core import tree as T
from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.params import partition_specs
from ..models.steps import make_decode_step, make_prefill_step
from ..models.transformer import model_specs
from ..obs import NULL_TRACER, LatencyTimeline, Tracer, fetch_telemetry
from ..optim.sharding_rules import copy_stack_pspec
from ..pshard import DEFAULT_RULES, ShardingRules, use_mesh_and_rules
from ..reliability.scheme import ArenaEcc, Compose, Scheme, Tmr, Unprotected
from . import placement as PL
from .mesh import fold_copy_axis

__all__ = ["GenerationEngine", "fetch_telemetry", "make_eval_hook"]


def _copy(stacked: Any, i: int) -> Any:
    return T.map_tree(lambda x: x[i], stacked)


def _disagreements(t3) -> torch.Tensor:
    """Token positions where the three copies do not all agree (int32)."""
    a, b, c = t3
    return ((a != b) | (a != c) | (b != c)).sum(dtype=torch.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _unmarked(n: int) -> None:
    """The unchunked run's mark: nothing, so no sync on the timed path."""


class GenerationEngine:
    """Batched greedy generation under a protection scheme.

    cfg        : model config, any family (every leaf of the params tree
                 is carried through the store, the copies and the vote
                 alike).
    scheme     : `Unprotected` (None), `DiagParityEcc`, `Tmr`, `Compose`.
    gen        : tokens to generate (prompt excluded).
    cache_len  : decode-cache length (default prompt_len + gen).
    vote_every : parallel/semi TMR or Compose: vote the per-copy token ids
                 every k decode steps (0 = vote only the final sequences).
    vote_cache : also vote every leaf of the decode caches at those vote
                 points (K/V, recurrent states, conv tails, positions).
    execution  : 'scan' (the in-loop vote schedule) or 'loop' (three
                 sequential generations, one final vote -- the reference).
    device     : where it runs; CUDA unless 'cpu' is asked for.
    cost_spec  : optional `costmodel.DeviceSpec`: telemetry gains the
                 `mmpu_*` gauges of `mmpu_projection` (None adds nothing).
    mesh       : optional `launch.mesh.Mesh` of which this process is a
                 rank: shard the store and the batch over it (module doc);
                 the engine runs on the mesh's device.
    rules      : `pshard.ShardingRules` for the logical axes on `mesh`.
    fold       : fold the copy axis of parallel/semi TMR onto data-replica
                 groups when the mesh allows (the batcher, which keeps
                 every copy on every rank, turns it off).
    in_place   : on a mesh, compute every axis the rules keep local where
                 it lives (`placement.local_dims`); False computes only
                 the experts there and gathers the rest whole (the
                 batcher alone, whose paged pool holds whole heads,
                 until its pool splits by head: ROADMAP A8).
    """

    def __init__(self, cfg: ModelConfig, scheme: Optional[Scheme] = None, *,
                 gen: int, cache_len: Optional[int] = None,
                 vote_every: int = 0, vote_cache: bool = False,
                 execution: str = "scan", device=None, cost_spec=None,
                 mesh=None, rules: Optional[ShardingRules] = None,
                 fold: bool = True, in_place: bool = True):
        if execution not in ("scan", "loop"):
            raise ValueError(f"execution must be 'scan' or 'loop', "
                             f"got {execution!r}")
        if mesh is not None:
            if device is not None and torch.device(device).type \
                    != mesh.device.type:
                raise ValueError(f"the mesh runs on {mesh.device}, the "
                                 f"engine was asked for {device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rules = rules if rules is not None else DEFAULT_RULES
        self.fold = bool(fold)
        self.in_place = bool(in_place)
        self.cfg = cfg
        self.scheme = scheme if scheme is not None else Unprotected()
        if vote_every or vote_cache:
            if not isinstance(self.scheme, (Tmr, Compose)):
                raise ValueError("vote_every/vote_cache require a TMR or "
                                 "Compose scheme (no copy axis to vote over)")
            if execution == "loop":
                raise ValueError("in-loop voting requires execution='scan' "
                                 "(the loop reference votes final sequences "
                                 "only)")
            if vote_cache and not vote_every:
                raise ValueError("vote_cache needs vote_every > 0")
            if self._discipline() == "serial":
                raise ValueError("in-loop voting needs concurrently executing "
                                 "copies; the serial discipline re-runs them "
                                 "sequentially (use tmr-parallel/tmr-semi, "
                                 "or vote_every=0)")
        self.gen = int(gen)
        self.cache_len = cache_len
        self.vote_every = int(vote_every)
        self.vote_cache = bool(vote_cache)
        self.execution = execution
        self.cost_spec = cost_spec
        self._mmpu_cache: Dict[int, Any] = {}

    # -- scheme plumbing ----------------------------------------------------

    @property
    def copy_axis(self) -> bool:
        """Does the store carry a leading 3-copy axis?"""
        return isinstance(self.scheme, (Tmr, Compose))

    def _tmr(self) -> Optional[Tmr]:
        if isinstance(self.scheme, Tmr):
            return self.scheme
        if isinstance(self.scheme, Compose):
            return self.scheme.tmr
        return None

    def _discipline(self) -> Optional[str]:
        tmr = self._tmr()
        return tmr.discipline if tmr is not None else None

    # -- mesh plumbing (DESIGN.md §14) ------------------------------------------

    @property
    def exec_mesh(self):
        """The mesh the generation runs on: the parallel and semi
        disciplines fold the copy axis onto data-replica groups when the
        data axis can host the three copies; the serial discipline (one
        copy in flight) and the single-copy schemes keep the constructor
        mesh."""
        if self.mesh is None:
            return None
        if self.fold and self.copy_axis and self._discipline() != "serial":
            folded = fold_copy_axis(self.mesh)
            if folded is not None:
                return folded
        return self.mesh

    def keep(self, mesh):
        """Per leaf, the dimensions a rank of `mesh` computes where they
        live (`placement.local_dims`, or the experts' alone)."""
        if self.in_place:
            return PL.local_dims(self.cfg, mesh, self.rules)
        return PL.expert_dims(model_specs(self.cfg))

    def _placement(self, mesh):
        """(per-copy spec of every leaf in flatten order, the copies this
        rank holds or None) on `mesh`."""
        specs = T.leaves(partition_specs(model_specs(self.cfg), mesh,
                                         self.rules))
        if not self.copy_axis:
            return specs, None
        lead = copy_stack_pspec(specs[0], mesh, rules=self.rules)[0]
        if lead is None:
            return specs, (0, 1, 2)
        return specs, (mesh.coords["copy"],)

    def shard_store(self, store: Any) -> Any:
        """Place an unmeshed store (a params tree; (3, *shape) leaves for
        the copy-axis schemes) on the exec mesh: this rank's slices of the
        copies it holds.  A no-op without a mesh."""
        if self.mesh is None:
            return store
        mesh = self.exec_mesh
        words, spec = arena.words_of(store, copies=3 if self.copy_axis
                                     else 0)
        specs, held = self._placement(mesh)
        return PL.place_store(words, spec, specs, mesh, held,
                              self.keep(mesh))

    def _prepare_mesh(self, params, generator, fault, dt, donate):
        """`prepare` on the exec mesh by the plan of `launch.placement`
        (`params` a clean-arena source there, or a params tree)."""
        scheme, mesh = self.scheme, self.exec_mesh
        if isinstance(params, (PL.KeyedParams, PL.WholeArena)):
            source, spec = params, getattr(params, "spec", None)
        else:
            words, spec = arena.words_of(params)
            source = PL.WholeArena(words)
        specs, held = self._placement(mesh)
        if spec is None or [s.shape for s in T.leaves(model_specs(
                self.cfg))] != [l.shape for l in spec.leaves]:
            raise ValueError("params do not match the config's specs")
        ecc = scheme if isinstance(scheme, ArenaEcc) else \
            scheme.ecc if isinstance(scheme, Compose) else None
        axes = mesh.axis_names if held is None or len(held) > 1 else \
            tuple(a for a in mesh.axis_names if a != "copy")
        with use_mesh_and_rules(mesh, self.rules):
            store, counts = PL.build_store(
                source, spec, specs, mesh,
                copies=3 if self.copy_axis else 1, held=held, fault=fault,
                generator=generator, dt=dt, ecc=ecc, scrub_axes=axes,
                donate=donate, keep=self.keep(mesh))
        if counts is None:
            return store, {}
        return store, {"ecc_corrected": counts[0],
                       "ecc_parity_fixed": counts[1],
                       "ecc_uncorrectable": counts[2]}

    def _params(self, store, copy: Optional[int] = None):
        """What the model reads for `copy` (None: the single copy)."""
        if isinstance(store, PL.ShardedStore):
            return PL.gathered(store, copy)
        return store if copy is None else _copy(store, copy)

    def _held(self, store) -> Tuple[int, ...]:
        if isinstance(store, PL.ShardedStore) and store.held is not None:
            return store.held
        return (0, 1, 2)

    # -- mMPU cost projection -------------------------------------------------

    def mmpu_projection(self, batch_size: int):
        """(event stream, MmpuCost) for one full generation at this batch
        size, or None without a cost_spec.  Compiled on the host from the
        config's shapes (nothing allocated) and cached per batch size; the
        fold runs on the engine's device.  `serve --mmpu-events` dumps the
        stream."""
        if self.cost_spec is None:
            return None
        key = int(batch_size)
        if key not in self._mmpu_cache:
            from .. import costmodel
            profile = costmodel.StepProfile.from_model_config(
                self.cfg, batch=key)
            stream = costmodel.scale_stream(
                costmodel.lower_step(self.scheme, profile, self.cost_spec),
                self.gen)
            cost = costmodel.fold(stream, self.cost_spec,
                                  tokens=key * self.gen, device=self.device)
            self._mmpu_cache[key] = (stream, cost)
        return self._mmpu_cache[key]

    def prepare(self, params: Any, generator: Optional[torch.Generator] = None,
                fault=None, dt: float = 1.0, donate: bool = False
                ) -> Tuple[Any, Dict[str, Any]]:
        """Build the serving store from clean `params` (left unchanged
        unless `donate`).

        Applies one exposure interval of `fault` to every held data copy
        (copies in order 0, 1, 2, leaves in flatten order, all drawn from
        `generator`; for a `core.prng` key, copy i under ``fold_in(key,
        100 + i)``, the reference's convention), then the scheme's
        storage-side protection.  Returns
        (store, prep telemetry): the store is a parameter tree of views
        into its arena -- (3, *shape) leaves for TMR and Compose.  On a
        mesh it is this rank's `launch.placement.ShardedStore`, built from
        its block range (`params` may then be a `placement.KeyedParams`,
        whose ranges are drawn alone, so no rank holds the whole arena),
        and `donate` lets a rank that holds one copy build it in the
        params' own arena (which it then no longer is)."""
        scheme = self.scheme
        if isinstance(params, PL.KeyedParams):
            if self.mesh is None:
                raise ValueError("a KeyedParams source builds a store on a "
                                 "mesh; one process materializes it whole")
            if params.device != self.device:
                raise ValueError(f"the source draws on {params.device}, the "
                                 f"engine runs on {self.device}")
            return self._prepare_mesh(params, generator, fault, dt, donate)
        words, spec = arena.words_of(params)
        if words.device != self.device:
            raise ValueError(f"params are on {words.device}, the engine runs "
                             f"on {self.device}")
        if self.mesh is not None:
            return self._prepare_mesh(params, generator, fault, dt, donate)

        def corrupt(w: torch.Tensor, i: int = 0) -> None:
            if fault is not None:
                fault.corrupt(arena.unpack(w, spec),
                              PL.copy_source(generator, i), dt)

        def copies() -> torch.Tensor:
            w3 = torch.empty((3, spec.n_words), dtype=torch.int32,
                             device=words.device)
            for i in range(3):
                w3[i].copy_(words)
                corrupt(w3[i], i)
            return w3

        def ecc_telem(counts):
            return {"ecc_corrected": counts[0],
                    "ecc_parity_fixed": counts[1],
                    "ecc_uncorrectable": counts[2]}

        if isinstance(scheme, Unprotected):
            if fault is None:
                return params, {}
            store = words.clone()
            corrupt(store)
            return arena.unpack(store, spec), {}
        if isinstance(scheme, ArenaEcc):
            parity = scheme.encode_arena(words)
            # a corrupted copy is scrubbed in place; without faults the
            # clean arena itself is the store (its scrub finds nothing)
            store = words.clone() if fault is not None else words
            corrupt(store)
            _, _, counts = scheme.scrub_arena(store, parity)
            return arena.unpack(store, spec), ecc_telem(counts)
        if isinstance(scheme, Tmr):
            return arena.unpack(copies(), spec), {}
        if isinstance(scheme, Compose):
            # one clean-arena encode serves all three copies: the fused
            # scrub reads parity row b mod n_blocks for stacked block b
            parity = scheme.ecc.encode_arena(words)
            store = copies()
            _, _, counts = scheme.ecc.scrub_copies(store, parity,
                                                   keep_parity=False)
            return arena.unpack(store, spec), ecc_telem(counts)
        raise ValueError(f"unhandled scheme {scheme!r}")

    # -- generation ---------------------------------------------------------

    def _steps(self, prompt_len: int):
        cache_len = self.cache_len or (prompt_len + self.gen)
        return (make_prefill_step(self.cfg, cache_len=cache_len),
                make_decode_step(self.cfg, logits=False))

    def _batch(self, batch: Dict[str, torch.Tensor]):
        return {k: v.to(self.device) for k, v in batch.items()}

    def _decode_steps(self, params, tok, cache, n: int, decode):
        """n decode steps of one copy: (last token, cache, [n tokens])."""
        toks = []
        for _ in range(n):
            tok, _, cache = decode(params, tok, cache)
            toks.append(tok)
        return tok, cache, toks

    def _sizes(self, chunk: Optional[int]) -> List[int]:
        """Decode steps per launch: all `gen - 1` at once without a chunk,
        else the reference's `_chunk_sizes(chunk)` schedule."""
        if chunk is None:
            return [self.gen - 1] if self.gen > 1 else []
        return list(self._chunk_sizes(chunk))

    def _single(self, params, batch, prefill, decode, sizes, mark=_unmarked,
                tracer: Tracer = NULL_TRACER,
                spans=("prefill", "decode_chunk"), land=None):
        """One copy: the prefill, then one launch of `n` decode steps per
        entry of `sizes`, each in its `spans` trace span.  After launch i
        (0 is the prefill) `land(i, part)` runs, then `mark(n)`.  Returns
        the token parts [(B, 1), (B, n1), ...]."""
        with tracer.trace(spans[0], tokens=1):
            tok, _, cache = prefill(params, batch)
            parts = [tok]
            if land is not None:
                land(0, tok)
            mark(1)
        for i, n in enumerate(sizes, start=1):
            with tracer.trace(spans[1], tokens=n):
                tok, cache, toks = self._decode_steps(params, tok, cache, n,
                                                      decode)
                parts.append(torch.cat(toks, dim=1))
                if land is not None:
                    land(i, parts[-1])
                mark(n)
        return parts

    def _across(self, store):
        """The three copies' values from this rank's: identity when every
        copy is held here, else a gather over the folded copy axis."""
        held = self._held(store)
        if len(held) == 3:
            return lambda vals: vals
        c, mesh = held[0], store.mesh
        return lambda vals: PL.exchange_copies(vals[c], c, mesh)

    def _prefill3(self, store, batch, prefill):
        tok3, cache3 = [None] * 3, [None] * 3
        for i in self._held(store):
            tok3[i], _, cache3[i] = prefill(self._params(store, i), batch)
        return self._across(store)(tok3), cache3

    def _tmr_steps(self, store, tok3, cache3, offset: int, n: int, decode):
        """parallel/semi TMR: n decode steps of the three copies advancing
        together from global step `offset`, voted on the reference's
        schedule ``(step + 1) % vote_every == 0``.  Returns (tok3, cache3,
        [per-step tok3], [per-step disagreements])."""
        vote = self._tmr()._vote()
        held, across = self._held(store), self._across(store)
        steps, dis = [], []
        for step in range(offset, offset + n):
            new = [None] * 3
            for i in held:
                new[i], _, cache3[i] = decode(self._params(store, i),
                                              tok3[i], cache3[i])
            tok3 = across(new)
            dis.append(_disagreements(tok3))
            if self.vote_every and (step + 1) % self.vote_every == 0:
                tok3 = [vote(*tok3)] * 3
                if self.vote_cache:
                    # every leaf of the cache tree (K/V, the SSM and RG-LRU
                    # states and conv tails, the position), as the
                    # reference's tree map
                    if len(held) == 3:
                        for a, b, c in zip(*(T.leaves(cc) for cc in cache3)):
                            vote(a, b, c, out=a)   # in place into copy 0,
                            b.copy_(a)             # then to the others
                            c.copy_(a)
                    else:
                        # a folded copy group holds one copy's cache: the
                        # other two arrive over the copy axis
                        for x in T.leaves(cache3[held[0]]):
                            vote(*across([x if i == held[0] else None
                                          for i in range(3)]), out=x)
            steps.append(list(tok3))
        return tok3, cache3, steps, dis

    def _concurrent(self, store, batch, prefill, decode, sizes,
                    mark=_unmarked, tracer: Tracer = NULL_TRACER):
        """parallel/semi TMR: the three copies advance together, one decode
        step each per iteration, launch by launch of `sizes` with the
        global step offset threaded, so the votes land on the reference's
        schedule whatever the launches."""
        with tracer.trace("tmr_prefill", tokens=1):
            tok3, cache3 = self._prefill3(store, batch, prefill)
            mark(1)
        first3, steps, dis, off = list(tok3), [], [], 0
        for n in sizes:
            with tracer.trace("tmr_decode_chunk", tokens=n, offset=off):
                tok3, cache3, s, d = self._tmr_steps(store, tok3, cache3,
                                                     off, n, decode)
                mark(n)
            steps += s
            dis += d
            off += n
        seq3 = [torch.cat([first3[i]] + [s[i] for s in steps], dim=1)
                for i in range(3)]
        return self._tmr()._vote()(*seq3), {
            "tmr_step_disagreements": torch.stack(
                [_disagreements(first3)] + dis),
            "tmr_final_disagreements": _disagreements(seq3)}

    def _serial(self, store, batch, prefill, decode, sizes, mark=_unmarked,
                tracer: Tracer = NULL_TRACER):
        """serial TMR: copies 0 and 1 run to the end one after another
        (unmarked), then each of copy 2's launches completes a voted part
        (the vote is elementwise, so part-wise voting equals the
        final-sequence vote)."""
        vote = self._tmr()._vote()
        per_copy = []
        for i in range(2):
            with tracer.trace(f"serial_copy{i}", copy=i):
                per_copy.append(self._single(self._params(store, i), batch,
                                             prefill, decode, sizes))
        voted: List[torch.Tensor] = []
        parts2 = self._single(
            self._params(store, 2), batch, prefill, decode, sizes, mark,
            tracer,
            spans=("serial_copy2_prefill", "serial_decode_chunk"),
            land=lambda i, part: voted.append(
                vote(per_copy[0][i], per_copy[1][i], part)))
        seq3 = [torch.cat(p, dim=1) for p in (*per_copy, parts2)]
        return torch.cat(voted, dim=1), {
            "tmr_final_disagreements": _disagreements(seq3)}

    def _finish(self, tokens, telem):
        # host constants become device scalars by a fill, not a blocking
        # copy from the host
        dev = tokens.device
        out = dict(telem)
        out["tokens_emitted"] = torch.full((), tokens.numel(),
                                           dtype=torch.int32, device=dev)
        proj = self.mmpu_projection(tokens.shape[0])
        if proj is not None:
            _, cost = proj
            out["mmpu_cycles_per_token"] = torch.full(
                (), cost.cycles_per_token, dtype=torch.float32, device=dev)
            out["mmpu_energy_pj_per_token"] = torch.full(
                (), cost.energy_pj_per_token, dtype=torch.float32,
                device=dev)
            out["mmpu_events"] = torch.full((), cost.n_events,
                                            dtype=torch.int32, device=dev)
        return tokens, out

    def generate(self, store: Any, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Generate `gen` tokens: (tokens (B, gen) int32, telemetry)."""
        if self.execution == "loop":
            return self.generate_loop(store, batch)
        return self.generate_scan(store, batch)

    def generate_scan(self, store, batch):
        """The reference's scan path as a Python loop: one pass for single
        stores, copies advancing together for parallel/semi, three
        sequential single-copy generations for serial."""
        return self._generate(store, batch,
                              concurrent=self._discipline() != "serial")

    def generate_loop(self, store, batch):
        """Interpreted reference: per-token decode; TMR as three sequential
        full generations, voted as the serial discipline votes."""
        return self._generate(store, batch, concurrent=False)

    def _generate(self, store, batch, concurrent: bool, chunk=None,
                  mark=_unmarked, tracer: Tracer = NULL_TRACER):
        """The one body of every discipline: all decode steps in one
        launch each without a chunk (and no sync), else chunk by chunk
        with `mark(n)` after each launch lands."""
        batch, rows = self._split(self._batch(batch), store)
        prefill, decode = self._steps(batch["tokens"].shape[1])
        sizes = self._sizes(chunk)
        with torch.no_grad(), self._ambient(store, rows):
            if not self.copy_axis:
                parts = self._single(self._params(store), batch, prefill,
                                     decode, sizes, mark, tracer)
                tokens, telem = torch.cat(parts, dim=1), {}
            else:
                body = self._concurrent if concurrent else self._serial
                tokens, telem = body(store, batch, prefill, decode, sizes,
                                     mark, tracer)
            return self._finish(*self._join(store, rows, tokens, telem))

    # -- the batch on a mesh ------------------------------------------------

    def _split(self, batch, store):
        """(this rank's rows of `batch`, the split) -- the split is None
        off the mesh or when the batch does not divide the batch axes."""
        if not isinstance(store, PL.ShardedStore):
            return batch, None
        n = batch["tokens"].shape[0]
        sl, axes, pieces = PL.row_split(n, store.mesh, self.rules)
        if pieces <= 1:
            return batch, None
        return {k: v[sl] for k, v in batch.items()}, (n, sl, axes, pieces)

    def _ambient(self, store, rows):
        if not isinstance(store, PL.ShardedStore):
            return contextlib.nullcontext()
        return use_mesh_and_rules(store.mesh, self.rules,
                                  batch_shards=rows[3] if rows else 1)

    def _join(self, store, rows, tokens, telem):
        """The whole batch's tokens and counters from this rank's rows:
        tokens gathered and disagreement counts summed over the batch
        axes (exact integer all-reduces)."""
        if rows is None:
            return tokens, telem
        n, sl, axes, _ = rows
        mesh = store.mesh
        tokens = PL.gather_rows(tokens, n, sl, axes, mesh)
        return tokens, {k: mesh.all_reduce(v.clone(), axes)
                        for k, v in telem.items()}

    # -- chunked generation ---------------------------------------------------

    def _chunk_sizes(self, chunk: int) -> Iterator[int]:
        """Chunk-size schedule for `gen - 1` decode steps (the
        reference's): full `chunk` launches, then the tail in descending
        powers of two."""
        rem = self.gen - 1
        while rem >= chunk:
            yield chunk
            rem -= chunk
        if rem > 0:
            p = 1 << (rem.bit_length() - 1)
            while rem > 0:
                if rem >= p:
                    yield p
                    rem -= p
                p >>= 1

    def generate_chunked(self, store, batch, *, chunk: int,
                         timeline: Optional[LatencyTimeline] = None,
                         tracer: Tracer = NULL_TRACER
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                    LatencyTimeline]:
        """Latency-observable generation: the decode steps in chunks of
        `_chunk_sizes(chunk)`, a `LatencyTimeline` mark after each chunk
        lands.  Tokens and telemetry equal `generate_scan`'s under every
        scheme and `vote_every`.  Each mark is a `torch.cuda.synchronize()`
        and a clock read, not a device->host data transfer; telemetry
        stays on the device.

        The first mark is TTFT (prefill -> first token); each later mark
        times one chunk.  The serial discipline runs copies 0 and 1 to the
        end first, so its marks start at the third copy's prefill, when
        voted tokens first exist.

        Returns (tokens, telemetry, timeline)."""
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if self.execution == "loop":
            raise ValueError("chunked generation requires execution='scan' "
                             "(the loop reference is already per-token)")
        timeline = timeline if timeline is not None else LatencyTimeline()

        def landed(n: int) -> None:
            _sync(self.device)
            timeline.mark(n)

        timeline.begin()
        tokens, telem = self._generate(
            store, batch, concurrent=self._discipline() != "serial",
            chunk=chunk, mark=landed, tracer=tracer)
        return tokens, telem, timeline

    def ttft(self, store, batch) -> torch.Tensor:
        """First generated token(s) only -- the prefill, voted across the
        copies under TMR.  Time this (after a warmup) for time to first
        token."""
        batch, rows = self._split(self._batch(batch), store)
        prefill, _ = self._steps(batch["tokens"].shape[1])
        with torch.no_grad(), self._ambient(store, rows):
            if not self.copy_axis:
                tok = prefill(self._params(store), batch)[0]
            else:
                toks = [None] * 3
                for i in self._held(store):
                    toks[i] = prefill(self._params(store, i), batch)[0]
                tok = self._tmr()._vote()(*self._across(store)(toks))
            return self._join(store, rows, tok, {})[0]


def make_eval_hook(engine: GenerationEngine, batch: Dict[str, torch.Tensor]):
    """A `TrainLoop` eval hook: greedy generation from the current params.

    The loop's scheme has already scrubbed (and voted) the store before the
    hook fires, so the hook runs the engine's single-copy path on the plain
    params, whatever the engine's scheme; its tokens stay on the device
    (the loop keeps them in `eval_history`; fetch after training)."""
    def eval_fn(params: Any, step: int) -> Dict[str, Any]:
        b = engine._batch(batch)
        prefill, decode = engine._steps(b["tokens"].shape[1])
        with torch.no_grad():
            parts = engine._single(params, b, prefill, decode,
                                   engine._sizes(None))
        return {"step": step, "tokens": torch.cat(parts, dim=1)}

    return eval_fn
