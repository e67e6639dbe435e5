"""Continuous-batching reliable serving (port of `repro.launch.batching`).

* **paged KV pool** (`PagedKVPool`) -- the KV state of every in-flight
  request lives in fixed-size pages of one int32 word arena: the k plane
  then the v plane, each (copies x pages) page-major, and `k` / `v` are
  compute-dtype views of it.  Every page spans whole 32-word ECC blocks,
  so one parity table covers all copies and both planes, `scrub()` is one
  fused scrub of the whole pool and `inject_scrub()` one fused
  corrupt+repair (kernels/inject_scrub under diagonal parity).  Pages are
  rewritten by every decode tick, so parity follows a write-back
  discipline: tick and admission re-encode the rows of the pages they
  touched, and a later scrub never "corrects" fresh data toward stale
  parity.  Page 0 is scratch: empty slots and unreserved page-table
  entries point at it, so masked rows read and write real storage that no
  active request depends on.

* **chunk-boundary scheduler** (`ContinuousBatcher`) -- requests join and
  leave the batch only between decode chunks.  Admission prefills at the
  bucket length, scatters the prefilled KV into the reserved pages and
  writes the first token; each tick gathers every slot's page table into
  a (L, slots, S_cap, KV, hd) cache view, runs `chunk` decode steps with
  per-slot positions, scatters the pages back and appends the new tokens
  to a per-slot output ring.  With write-back (``ecc-wb``, ``hsiao-wb``)
  the tick first repairs every page it is about to read, in place, parity
  rows included (`_correct_pages`).  TMR copies run one after another
  inside each tick under every discipline: the voted bits are the same,
  and what is held against the reference is tokens and counters, not the
  launch shape.

* **host syncs** -- a tick makes no device->host transfer except ONE
  batched copy of finished rows on ticks where requests complete
  (completion itself is host-side arithmetic over known generation
  lengths).  Scrub and read-path counters accumulate on the device
  through `obs.MetricsRegistry`; TMR final votes of finished requests are
  2-of-3 majorities computed on the host from the fetched per-copy rows.
  ``torch.cuda.synchronize`` stands where the reference blocks until
  ready, so TTFT and TPOT time the same thing.  The one documented
  exception: with an adaptive scrub controller (`adaptive=`,
  `runtime.AdaptiveScrub`) each pool scrub's counters are fetched, one
  small copy a scrub, for the controller to set the next interval.

* **mesh** -- with ``mesh=`` (a `launch.mesh.Mesh`; this process is one
  of its ranks) the engine's `prepare` places the weight store by the
  logical-axis rules, each rank holding its slice of every leaf, and the
  decode reads each leaf gathered whole when a layer runs.  The scheduler,
  the pool and the slots are the same on every rank (every rank runs the
  same ticks on the same slots), so the copy axis stays unfolded here and
  the pool's scrubs and counters need no reduction.

Bit-exactness: every decode op is batch-row-local (masked attention reads
only the row's own pages; page indirection copies values), so a request
admitted into a live batch produces exactly the tokens and vote
disagreements it produces served alone through the scheduler.

    spec = BatchSpec(slots=4, page_tokens=16, chunk=8,
                     prompt_buckets=(256,), gen_cap=32)
    b = ContinuousBatcher(cfg, scheme, spec, device="cuda")
    prep = b.prepare(params, generator=g, fault=fault)
    results = b.run(poisson_trace(8, rate_rps=2.0, spec=spec,
                                  vocab=cfg.vocab), realtime=True)
    stats = fetch_telemetry({**prep, **b.telemetry()})
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import arena
from ..core.bitops import as_u64, popcount32
from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.steps import make_decode_step, make_prefill_step
from ..obs import DEFAULT_REGISTRY, LatencyTimeline, MetricsRegistry
from ..pshard import use_mesh_and_rules
from ..reliability.scheme import ArenaEcc, Compose, Scheme
from .engine import GenerationEngine, _sync

__all__ = ["BatchSpec", "Request", "RequestResult", "PagedKVPool",
           "ContinuousBatcher", "poisson_trace", "sequential_slot_steps"]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """Static shape of the serving configuration.

    slots          : batch rows of a tick (the max in-flight requests).
    page_tokens    : tokens per KV page.
    chunk          : decode steps per scheduler tick (the join/leave
                     granularity).
    prompt_buckets : admissible prompt lengths.
    gen_cap        : max tokens a request may ask for.
    n_pages        : pool pages (default: full occupancy, slots views of
                     the whole cache window).
    """

    slots: int = 4
    page_tokens: int = 16
    chunk: int = 8
    prompt_buckets: Tuple[int, ...] = (16,)
    gen_cap: int = 32
    n_pages: Optional[int] = None

    def __post_init__(self):
        if self.slots < 1 or self.chunk < 1 or self.gen_cap < 1:
            raise ValueError(f"slots/chunk/gen_cap must be >= 1: {self}")
        if self.page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1: {self}")
        if not self.prompt_buckets:
            raise ValueError("need at least one prompt bucket")

    @property
    def max_prompt(self) -> int:
        return max(self.prompt_buckets)

    @property
    def cache_tokens(self) -> int:
        """S_cap: the per-slot cache window every gathered view exposes,
        with `chunk` slack so the final tick's overgenerated writes land
        inside the window instead of onto live history."""
        raw = self.max_prompt + self.gen_cap + self.chunk
        return _ceil_div(raw, self.page_tokens) * self.page_tokens

    @property
    def max_pages(self) -> int:
        """Page-table width: pages per slot covering the full window."""
        return self.cache_tokens // self.page_tokens

    @property
    def pool_pages(self) -> int:
        return self.n_pages if self.n_pages is not None \
            else self.slots * self.max_pages

    @property
    def out_cap(self) -> int:
        """Output-ring width: gen_cap plus chunk slack."""
        return self.gen_cap + self.chunk

    def pages_for(self, prompt_len: int, gen: int) -> int:
        """Pages reserved at admission -- the whole request up front."""
        return _ceil_div(prompt_len + gen, self.page_tokens)


@dataclasses.dataclass
class Request:
    """One serving request.  `prompt` length must be a spec bucket."""
    rid: int
    prompt: np.ndarray
    gen: int
    arrival_s: float = 0.0


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: np.ndarray          # (gen,) int32 -- voted for TMR schemes
    ttft_s: float               # submit -> first token (queue wait included)
    tpot_samples: List[float]   # per-token seconds from the chunk marks
    vote_disagreements: int     # positions where the 3 copies differed
    timeline: LatencyTimeline


@dataclasses.dataclass
class _Active:
    req: Request
    pages: np.ndarray
    emitted: int
    timeline: LatencyTimeline


class PagedKVPool:
    """Page-granular KV storage for one `BatchSpec`, ECC-protectable.

    `k`, `v`: (pool_pages + 1, L, page_tokens, KV, hd) views in the model
    compute dtype -- page 0 is scratch -- with a leading 3-copy axis when
    `copies` (TMR and Compose keep one cache state per weight copy).  Both
    are views of one int32 word arena `words`, laid out as the reference
    packs ``{"k": k, "v": v}``; with `ecc` it carries one parity table,
    and `scrub()` / `inject_scrub()` are each one fused launch over it,
    counters on the device.  The pool lives on CUDA unless `device` says
    otherwise (`device.resolve_device`).
    """

    def __init__(self, cfg: ModelConfig, spec: BatchSpec, *, copies: bool,
                 ecc: Optional[ArenaEcc] = None, device=None):
        self.cfg, self.spec, self.ecc, self.copies = cfg, spec, ecc, copies
        device = resolve_device(device)
        L, KV, hd = cfg.n_layers, cfg.n_kv, cfg.head_dim
        self.page_shape = (L, spec.page_tokens, KV, hd)
        self.page_words = arena.words_for(self.page_shape, cfg.cdtype)
        if ecc is not None and self.page_words % arena.BLOCK:
            raise ValueError(
                f"ECC-protected pool needs pages spanning whole "
                f"{arena.BLOCK}-word blocks; page {self.page_shape} "
                f"{cfg.cdtype} = {self.page_words} words -- raise "
                f"page_tokens")
        shape = (spec.pool_pages + 1,) + self.page_shape
        if copies:
            shape = (3,) + shape
        like = torch.empty(shape, dtype=cfg.cdtype, device="meta")
        self.arena_spec = arena.arena_spec({"k": like, "v": like})
        self.words = torch.zeros(self.arena_spec.n_words, dtype=torch.int32,
                                 device=device)
        kv = arena.unpack(self.words, self.arena_spec)
        self.k, self.v = kv["k"], kv["v"]
        self.parity = ecc.encode_arena(self.words) if ecc is not None \
            else None
        self._free: List[int] = list(range(1, spec.pool_pages + 1))

    # -- host-side page allocator -------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[np.ndarray]:
        """Reserve n pages (LIFO -- freshly freed pages are reused first);
        None when short."""
        if n > len(self._free):
            return None
        return np.asarray([self._free.pop() for _ in range(n)], np.int32)

    def free(self, pages: np.ndarray) -> None:
        for p in reversed(list(map(int, pages))):
            if p <= 0 or p > self.spec.pool_pages:
                raise ValueError(f"bad page id {p}")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
            self._free.append(p)

    # -- page rows of the word arena ------------------------------------------

    def page_rows(self, pages: torch.Tensor) -> torch.Tensor:
        """Rows of the (planes x copies x pages, page_words) word matrix
        holding `pages` of every copy, k plane then v plane, copy-major:
        the order the reference packs ``{"k": k[:, pages], "v": ...}``."""
        npg = self.spec.pool_pages + 1
        C = 3 if self.copies else 1
        base = torch.arange(2 * C, device=pages.device) * npg
        return (base[:, None] + pages[None, :].long()).reshape(-1)

    def page_matrix(self) -> torch.Tensor:
        """The word arena as (planes x copies x pages, page_words)."""
        return self.words.view(-1, self.page_words)

    # -- fused reliability ops over the pool arena ----------------------------

    def _need_ecc(self) -> None:
        if self.ecc is None:
            raise ValueError("pool has no ECC (scheme carries no parity)")

    def scrub(self) -> torch.Tensor:
        """One fused scrub of the whole pool against its parity table, in
        place; returns the on-device (3,) counts (corrected, parity_fixed,
        uncorrectable).  Call between ticks."""
        self._need_ecc()
        _, self.parity, counts = self.ecc.scrub_arena(self.words, self.parity)
        return counts

    def inject_scrub(self, generator: Optional[torch.Generator], fault,
                     dt: float = 1.0) -> torch.Tensor:
        """One fused corrupt+repair over the pool arena: the fault model's
        dense XOR word mask, then the code's fused path (diagonal parity:
        the `inject_scrub` kernel).  Returns on-device (4,) counts
        (injected, corrected, parity_fixed, uncorrectable)."""
        self._need_ecc()
        mask = fault.word_mask(generator, self.words, dt).to(self.words.device)
        _, self.parity, counts = self.ecc.inject_scrub_arena(
            self.words, self.parity, mask)
        return counts

    def corrupt(self, generator: Optional[torch.Generator], fault,
                dt: float = 1.0) -> torch.Tensor:
        """Corrupt-only exposure: XOR one fault-model interval into the
        pool WITHOUT repairing it; parity stays as it was (it still
        describes the pre-fault bits, which a later scrub or write-back
        read repairs against).  Returns the on-device injected-flip
        count."""
        mask = fault.word_mask(generator, self.words, dt).to(self.words.device)
        self.words ^= mask
        return popcount32(as_u64(mask)).sum(dtype=torch.int32)

    def corrupt_page(self, page: int, *, bit: int = 7, word: int = 0,
                     copy: int = 0) -> None:
        """Test hook: flip one stored bit of one page's k plane through the
        word arena (exactly what a scrub must repair)."""
        pw = self.page_words
        idx = (copy * (self.spec.pool_pages + 1) + page) * pw + word \
            if self.copies else page * pw + word
        flip = (1 << bit) - (1 << 32 if bit == 31 else 0)
        self.words[idx] ^= flip


class ContinuousBatcher:
    """Chunk-boundary scheduler over the paged pool (module doc)."""

    def __init__(self, cfg: ModelConfig, scheme: Optional[Scheme] = None,
                 spec: BatchSpec = BatchSpec(), *, scrub_every: int = 0,
                 adaptive=None,
                 forced_scrub_ticks: Optional[Sequence[int]] = None,
                 registry: MetricsRegistry = DEFAULT_REGISTRY, device=None,
                 mesh=None, rules=None):
        if cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"continuous batching supports dense/moe decode caches; "
                f"{cfg.family!r} caches are not paged yet")
        self.cfg, self.spec = cfg, spec
        # the engine supplies prepare() (the same fault draws and scrubs as
        # whole-batch serving), the device, the mesh placement and the
        # scheme plumbing; every rank holds every copy (no fold)
        self.engine = GenerationEngine(cfg, scheme, gen=spec.gen_cap,
                                       cache_len=spec.cache_tokens,
                                       device=device, mesh=mesh, rules=rules,
                                       fold=False, in_place=False)
        self.device = self.engine.device
        self.scheme = self.engine.scheme
        self._copy = self.engine.copy_axis
        self.ecc = self.scheme if isinstance(self.scheme, ArenaEcc) \
            else self.scheme.ecc if isinstance(self.scheme, Compose) else None
        self.pool = PagedKVPool(cfg, spec, copies=self._copy, ecc=self.ecc,
                                device=self.device)
        S, dev = spec.slots, self.device
        lead = (3,) if self._copy else ()
        self._tok = torch.zeros(lead + (S, 1), dtype=torch.int32, device=dev)
        self._out = torch.zeros(lead + (S, spec.out_cap), dtype=torch.int32,
                                device=dev)
        self._pos = torch.zeros((S,), dtype=torch.int32, device=dev)
        self.table = np.zeros((S, spec.max_pages), np.int32)
        self._slots: List[Optional[_Active]] = [None] * S
        self.queue: Deque[Tuple[Request, LatencyTimeline]] = deque()
        self.results: Dict[int, RequestResult] = {}
        self.store = None
        self._params: List[Any] = []
        self.ticks = 0
        self.decode_slot_steps = 0
        self.scrub_every = int(scrub_every)
        #: optional runtime.AdaptiveScrub: pay-as-you-fault scrub cadence.
        #: Overrides scrub_every; each pool scrub's counts are fetched and
        #: fed back (`record`) -- the one documented exception to the
        #: no-transfer tick, and scrubs get rarer as the store quiets down
        self.adaptive = adaptive
        #: replay hook: scrub at exactly these tick indices (overrides
        #: both cadences) -- replays a recorded adaptive schedule
        self._forced_scrub = (None if forced_scrub_ticks is None
                              else frozenset(int(t)
                                             for t in forced_scrub_ticks))
        #: tick indices at which the pool was scrubbed
        self.scrub_ticks: List[int] = []
        #: host callback fired at the top of every tick, before the launch
        #: (fault-injection hook: e.g.
        #: ``b.on_tick = lambda b: b.pool.corrupt(g, fault)``)
        self.on_tick = None
        self._registry = registry
        self._wb = self.ecc is not None and self.ecc.write_back
        self._telem = registry.zeros(
            ["ecc_corrected", "ecc_parity_fixed", "ecc_uncorrectable",
             "ecc_read_corrected", "ecc_read_parity_fixed",
             "ecc_read_uncorrectable"], device=dev)
        self._tokens_emitted = 0
        self._vote_disagreements = 0
        self._prep: Dict[str, Any] = {}
        self._decode = make_decode_step(cfg)
        self._prefill = make_prefill_step(cfg, cache_len=spec.cache_tokens)

    # -- pool <-> dense cache views ---------------------------------------------

    def _gather(self, plane: torch.Tensor, table: torch.Tensor):
        """(pool_pages+1, L, P, KV, hd)[table (S, MP)] -> (L, S, S_cap, KV,
        hd): every slot's page-table view as a dense cache (a copy)."""
        S, MP = table.shape
        g = plane[table].permute(2, 0, 1, 3, 4, 5)       # (L, S, MP, P, ...)
        return g.reshape(g.shape[0], S, MP * self.spec.page_tokens,
                         *g.shape[4:])

    def _scatter(self, plane: torch.Tensor, table: torch.Tensor,
                 cache: torch.Tensor) -> None:
        """Inverse of `_gather`, in place.  Scratch page 0 appears once per
        unreserved table entry and its duplicate writes race, but nothing
        reads page 0 unmasked and its parity is re-encoded from the final
        bytes, so the winner is immaterial."""
        S, MP = table.shape
        L, P = cache.shape[0], self.spec.page_tokens
        c = cache.reshape(L, S, MP, P, *cache.shape[3:])
        plane[table] = c.permute(1, 2, 0, 3, 4, 5).to(plane.dtype)

    # -- write-back parity and write-back-on-read -------------------------------

    def _refresh_parity(self, pages: torch.Tensor) -> None:
        """Re-encode the parity rows of `pages` (every copy, both planes)
        from the pool's current bytes.  The code is block-local and every
        page spans whole blocks, so the rows equal a full re-encode's, and
        untouched pages' rows are already fresh from the launch that last
        wrote them.  Duplicate ids (scratch page 0, once per slot) write
        identical rows."""
        if self.ecc is None:
            return
        pool = self.pool
        rows = pool.page_rows(pages)
        fresh = self.ecc.encode_arena(pool.page_matrix()[rows].reshape(-1))
        pwb = pool.page_words // arena.BLOCK
        pool.parity.view(-1, pwb, pool.parity.shape[1])[rows] = \
            fresh.view(-1, pwb, fresh.shape[1])

    def _correct_pages(self, pages: torch.Tensor) -> torch.Tensor:
        """Write-back-on-read: repair exactly the pages this tick is about
        to read, persisting the corrected bits and their healed parity
        rows, so hot pages never carry a fault into the decode.  Duplicate
        ids (scratch page 0, once per unreserved table entry) correct
        identical bits to identical values; a fault on page 0 counts once
        per duplicate in the returned (3,) counts, as in the reference
        (scratch never holds live data, so the over-count is cosmetic)."""
        pool = self.pool
        rows = pool.page_rows(pages)
        pwb = pool.page_words // arena.BLOCK
        ptab = pool.parity.view(-1, pwb, pool.parity.shape[1])
        buf = pool.page_matrix()[rows].reshape(-1)
        prow = ptab[rows].reshape(-1, pool.parity.shape[1])
        _, prow, counts = self.ecc.scrub_arena(buf, prow)
        pool.page_matrix()[rows] = buf.view(len(rows), pool.page_words)
        ptab[rows] = prow.view(len(rows), pwb, -1)
        return counts

    def _touched(self, table: torch.Tensor, pos: torch.Tensor):
        """Page ids a chunk starting at `pos` writes: each slot's
        consecutive table entries from pos // P on (clipped --
        overgeneration past the reservation resolves to scratch page 0, as
        do empty slots' all-zero rows and stale positions)."""
        P, MP, chunk = (self.spec.page_tokens, self.spec.max_pages,
                        self.spec.chunk)
        span = (chunk + P - 2) // P + 1   # max pages a chunk's writes span
        first = pos.long() // P
        idx = (first[:, None] + torch.arange(span, device=pos.device)
               ).clamp(0, MP - 1)
        return torch.gather(table, 1, idx).reshape(-1)

    # -- one launch each: admission and tick -------------------------------------

    def _chunk(self, params, tok, k, v, pos, table):
        """`chunk` decode steps of one copy over its pool planes; returns
        (last token, tokens (S, chunk))."""
        cache = {"pos": pos, "k": self._gather(k, table),
                 "v": self._gather(v, table)}
        toks = []
        for _ in range(self.spec.chunk):
            tok, _, cache = self._decode(params, tok, cache)
            toks.append(tok)
        self._scatter(k, table, cache["k"])
        self._scatter(v, table, cache["v"])
        return tok, torch.cat(toks, dim=1)

    def _place(self, plane: torch.Tensor, table_row: torch.Tensor,
               cache_kv: torch.Tensor) -> None:
        # (L, 1, S_cap, KV, hd) -> (MP, L, P, KV, hd) at table_row
        L, MP, P = cache_kv.shape[0], self.spec.max_pages, \
            self.spec.page_tokens
        c = cache_kv[:, 0].reshape(L, MP, P, *cache_kv.shape[3:])
        plane[table_row.long()] = c.permute(1, 0, 2, 3, 4).to(plane.dtype)

    def _copies(self):
        """(copy index, params, k plane, v plane) per weight copy."""
        pool = self.pool
        if self._copy:
            return [(i, self._params[i], pool.k[i], pool.v[i])
                    for i in range(3)]
        return [(None, self._params[0], pool.k, pool.v)]

    def _ambient(self):
        """The mesh and rules the decode runs under (every rank holds every
        slot: the batch is not split)."""
        if self.engine.mesh is None:
            return contextlib.nullcontext()
        return use_mesh_and_rules(self.engine.mesh, self.engine.rules)

    def _admit_launch(self, tokens, table_row, slot: int, plen: int):
        with torch.no_grad(), self._ambient():
            for i, params, k, v in self._copies():
                t0, _, cache = self._prefill(params, {"tokens": tokens})
                self._place(k, table_row, cache["k"])
                self._place(v, table_row, cache["v"])
                tok = self._tok if i is None else self._tok[i]
                out = self._out if i is None else self._out[i]
                tok[slot, 0] = t0[0, 0]
                out[slot, 0] = t0[0, 0]
            self._pos[slot] = plen
            # placement rewrote the slot's whole table row (scratch
            # included for unreserved entries): refresh exactly those pages
            self._refresh_parity(table_row)

    def _tick_launch(self, table, off) -> torch.Tensor:
        spec = self.spec
        with torch.no_grad(), self._ambient():
            if self._wb:
                # correct-on-read: the tick reads every table page through
                # the gather, so repair all of them first
                rcounts = self._correct_pages(table.reshape(-1))
            else:
                rcounts = None
            pos = self._pos
            idx = off.long()[:, None] + torch.arange(spec.chunk,
                                                     device=off.device)
            for i, params, k, v in self._copies():
                tok = self._tok if i is None else self._tok[i]
                out = self._out if i is None else self._out[i]
                last, toks = self._chunk(params, tok, k, v, pos, table)
                tok.copy_(last)
                out.scatter_(1, idx, toks)
            self._refresh_parity(self._touched(table, pos))
            self._pos = pos + spec.chunk
        return rcounts

    # -- scheduler ----------------------------------------------------------------

    def prepare(self, params: Any, generator: Optional[torch.Generator] = None,
                fault=None, dt: float = 1.0) -> Dict[str, Any]:
        """Build the protected serving store (`GenerationEngine.prepare`:
        the same fault draws and scrubs as whole-batch serving) and attach
        it."""
        self.store, prep = self.engine.prepare(params, generator=generator,
                                               fault=fault, dt=dt)
        # views the decode reads (gathered leaf by leaf on a mesh)
        self._params = [self.engine._params(self.store, i)
                        for i in range(3)] if self._copy \
            else [self.engine._params(self.store)]
        self._prep = dict(prep)
        return prep

    @property
    def active(self) -> int:
        return sum(a is not None for a in self._slots)

    def submit(self, req: Request) -> None:
        plen = len(req.prompt)
        if plen not in self.spec.prompt_buckets:
            raise ValueError(f"prompt length {plen} not in buckets "
                             f"{self.spec.prompt_buckets}")
        if not 1 <= req.gen <= self.spec.gen_cap:
            raise ValueError(f"gen={req.gen} outside 1..{self.spec.gen_cap}")
        tl = LatencyTimeline()
        tl.begin()                      # TTFT clock includes queue wait
        self.queue.append((req, tl))

    def admit(self) -> int:
        """Admit queued requests (FIFO, no overtaking) while a slot and a
        full upfront page reservation are available.  Returns the number
        admitted."""
        if self.store is None:
            raise RuntimeError("call prepare() before serving")
        n = 0
        while self.queue:
            req, tl = self.queue[0]
            slot = next((i for i, a in enumerate(self._slots) if a is None),
                        None)
            if slot is None:
                break
            pages = self.pool.alloc(self.spec.pages_for(len(req.prompt),
                                                        req.gen))
            if pages is None:
                break
            self.queue.popleft()
            self._admit_one(req, tl, slot, pages)
            n += 1
        return n

    def _admit_one(self, req, tl, slot, pages):
        row = np.zeros(self.spec.max_pages, np.int32)
        row[:len(pages)] = pages
        self.table[slot] = row
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int32)[None, :],
                                 device=self.device)
        self._admit_launch(tokens, torch.as_tensor(row, device=self.device),
                           slot, len(req.prompt))
        _sync(self.device)                   # sync point, no data transfer
        tl.mark(1)                           # <- TTFT
        self._slots[slot] = _Active(req=req, pages=pages, emitted=1,
                                    timeline=tl)

    def tick(self) -> List[RequestResult]:
        """One scheduler tick: `chunk` decode steps for every slot, then
        host-side completion bookkeeping.  The ONLY device->host transfer
        is one batched copy of finished rows, and only on ticks where a
        request finishes."""
        spec = self.spec
        if self.on_tick is not None:
            self.on_tick(self)       # pre-launch hook (fault injection)
        active = [(i, a) for i, a in enumerate(self._slots) if a is not None]
        off = np.zeros(spec.slots, np.int32)
        for i, a in active:
            off[i] = a.emitted
        rcounts = self._tick_launch(
            torch.as_tensor(self.table, device=self.device).long(),
            torch.as_tensor(off, device=self.device))
        _sync(self.device)
        if self._wb:
            # read-path repairs land in their own counters (on device)
            self._telem = self._registry.accumulate(
                self._telem, {"ecc_read_corrected": rcounts[0],
                              "ecc_read_parity_fixed": rcounts[1],
                              "ecc_read_uncorrectable": rcounts[2]})
        self.ticks += 1
        self.decode_slot_steps += spec.chunk * spec.slots
        done: List[Tuple[int, _Active]] = []
        for i, a in active:
            fresh = min(spec.chunk, a.req.gen - a.emitted)
            if fresh > 0:
                a.timeline.mark(fresh)
            a.emitted = min(a.req.gen, a.emitted + spec.chunk)
            if a.emitted >= a.req.gen:
                done.append((i, a))
        finished: List[RequestResult] = []
        if done:
            # ONE batched transfer for every finished row this tick
            rows = torch.stack([self._out[..., i, :] for i, _ in done])
            rows = rows.cpu().numpy()
            for (i, a), row in zip(done, rows):
                finished.append(self._finish(i, a, row))
        if self.ecc is not None and self._scrub_due():
            counts = self.pool.scrub()       # counters stay on device
            self.scrub_ticks.append(self.ticks)
            if self.adaptive is not None and self._forced_scrub is None:
                # the documented exception: one (3,)-int fetch a scrub
                c = counts.cpu().tolist()
                self.adaptive.record(self.ticks, c[0], c[2], c[1])
            self._telem = self._registry.accumulate(
                self._telem, {"ecc_corrected": counts[0],
                              "ecc_parity_fixed": counts[1],
                              "ecc_uncorrectable": counts[2]})
        return finished

    def _scrub_due(self) -> bool:
        """Which cadence owns this tick: a forced replay schedule beats the
        adaptive controller beats the fixed interval."""
        if self._forced_scrub is not None:
            return self.ticks in self._forced_scrub
        if self.adaptive is not None:
            return self.adaptive.due(self.ticks)
        return bool(self.scrub_every) and self.ticks % self.scrub_every == 0

    def _finish(self, slot, a, row) -> RequestResult:
        gen = a.req.gen
        if self._copy:
            t = row[:, :gen].astype(np.int32)
            # bitwise 2-of-3 majority, per bit as the tmr_vote kernel, on
            # the host from the single already-fetched transfer
            tokens = (t[0] & t[1]) | (t[0] & t[2]) | (t[1] & t[2])
            dis = int(np.sum(~((t[0] == t[1]) & (t[0] == t[2]))))
        else:
            tokens, dis = row[:gen].astype(np.int32), 0
        res = RequestResult(rid=a.req.rid, tokens=tokens,
                            ttft_s=a.timeline.ttft_s,
                            tpot_samples=list(a.timeline.tpot_samples()),
                            vote_disagreements=dis, timeline=a.timeline)
        self.results[a.req.rid] = res
        self._tokens_emitted += gen
        self._vote_disagreements += dis
        self.pool.free(a.pages)
        self.table[slot] = 0
        self._slots[slot] = None
        return res

    def drain(self) -> None:
        """Tick until every queued and in-flight request has finished."""
        while self.queue or self.active:
            self.admit()
            if self.active:
                self.tick()
            elif self.queue:
                req, _ = self.queue[0]
                raise RuntimeError(
                    f"request {req.rid} needs "
                    f"{self.spec.pages_for(len(req.prompt), req.gen)} pages "
                    f"but the idle pool has {self.pool.free_pages} of "
                    f"{self.spec.pool_pages} -- pool too small")

    def run(self, requests: Sequence[Request], *, realtime: bool = False
            ) -> List[RequestResult]:
        """Serve a trace to completion.  realtime=True paces submissions
        by `arrival_s` (open loop -- arrivals never wait for service);
        False submits in arrival order immediately (deterministic, for
        tests)."""
        order = sorted(requests, key=lambda r: r.arrival_s)
        t0 = time.perf_counter()
        i, n = 0, len(order)
        while i < n or self.queue or self.active:
            now = time.perf_counter() - t0
            while i < n and (not realtime or order[i].arrival_s <= now):
                self.submit(order[i])
                i += 1
            self.admit()
            if self.active:
                self.tick()
            elif self.queue:
                self.drain()        # raises: pool too small for the head
            elif realtime and i < n:
                time.sleep(max(0.0, min(0.005,
                                        order[i].arrival_s - now)))
        return [self.results[r.rid] for r in requests]

    def telemetry(self) -> Dict[str, Any]:
        """Schema-valid telemetry dict -- device counters plus host
        tallies; fetch once with `obs.fetch_telemetry` after timing stops.
        The prepare-time scrub counters are folded into the totals, so
        ``{**prep, **batcher.telemetry()}`` yields grand totals."""
        out: Dict[str, Any] = dict(self._telem)
        for k, v in self._prep.items():
            out[k] = out[k] + v if k in out else v
        out["tokens_emitted"] = np.int32(self._tokens_emitted)
        if self._copy:
            out["tmr_final_disagreements"] = \
                np.int32(self._vote_disagreements)
        return out


# -- load generation and the whole-batch baseline ------------------------------

def poisson_trace(n: int, *, rate_rps: float, spec: BatchSpec, vocab: int,
                  seed: int = 0,
                  gen_choices: Optional[Sequence[int]] = None,
                  gen_weights: Optional[Sequence[float]] = None
                  ) -> List[Request]:
    """Open-loop Poisson trace: exponential inter-arrivals at `rate_rps`,
    prompt lengths drawn from the spec's buckets, generation lengths from
    `gen_choices` (default: a skewed short/long mix over gen_cap).  The
    reference's numpy draws in the reference's order: the same seed gives
    the same trace in both packages."""
    rng = np.random.default_rng(seed)
    if gen_choices is None:
        gen_choices = [max(1, spec.gen_cap // 4), spec.gen_cap]
        gen_weights = [0.75, 0.25]
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, n))
    out = []
    for i in range(n):
        plen = int(rng.choice(np.asarray(spec.prompt_buckets)))
        gen = int(rng.choice(np.asarray(gen_choices), p=gen_weights))
        out.append(Request(rid=i,
                           prompt=rng.integers(0, vocab, (plen,),
                                               dtype=np.int32),
                           gen=gen, arrival_s=float(arrivals[i])))
    return out


def sequential_slot_steps(requests: Sequence[Request], slots: int) -> int:
    """Decode slot-steps whole-batch serving spends on a trace: requests
    grouped `slots` at a time in arrival order, every row of a group
    padded to the group's longest generation.  Compare with
    `ContinuousBatcher.decode_slot_steps`."""
    order = sorted(requests, key=lambda r: r.arrival_s)
    total = 0
    for g in range(0, len(order), slots):
        grp = order[g:g + slots]
        total += slots * max(r.gen for r in grp)
    return total
