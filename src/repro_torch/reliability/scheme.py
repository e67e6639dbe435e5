"""Composable protection schemes (port of `repro.reliability.scheme`).

    scheme = parse_scheme("ecc+tmr-serial")
    prot   = scheme.protect(params)           # Protected store
    prot   = scheme.corrupt_store(prot, fault, generator)
    prot, report = scheme.scrub(prot)         # verify/correct redundancy
    prot   = scheme.refresh(prot.payload, prot)   # after an optimizer step
    params = scheme.read(prot)                # decode/vote the payload

Every `Protected` owns an arena (`core.arena`): `protect` copies the
payload into a fresh one -- (n_words,) for the single-copy schemes,
(3, n_words) for the TMR copies -- and the payload and copies are views
of it.  Where the reference returns new stores, `corrupt_store` and
`scrub` update that arena in place and return the same `Protected`, so a
full-width store is never held twice.  `refresh` after a write to the
payload's own views re-encodes (or re-copies) that arena in place where
the reference protects a fresh copy.  Bits and counters match the
reference's on the same inputs.

With ``mesh=`` (a `launch.mesh.Mesh`, this process one of its ranks, the
arena whole on every rank) the arena scrubs run on one contiguous block
range per rank with the counts summed (`kernels.sharded`, DESIGN.md §14):
the same bits and counts.  `shardings` gives the DTensor placements of a
store's payload and redundancy on a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..core import arena, prng
from ..core import tree as T
from ..core.bitops import as_u64, popcount32
from ..core.reliability import ScrubReport
from ..core.tmr import TMR_COSTS
from . import backend

__all__ = ["CostReport", "Protected", "Scheme", "Unprotected", "ArenaEcc",
           "DiagParityEcc", "HsiaoSecDed", "Tmr", "Compose", "parse_scheme",
           "standard_grid", "register_scheme",
           "scheme_choices", "scheme_help", "TMR_COSTS"]


@dataclasses.dataclass(frozen=True)
class CostReport:
    """Protection overheads relative to the unprotected baseline."""
    storage_x: float = 1.0
    latency_x: float = 1.0
    area_x: float = 1.0
    throughput_x: float = 1.0

    def describe(self) -> str:
        return (f"storage={self.storage_x:.3f}x latency={self.latency_x:.2f}x "
                f"area={self.area_x:.0f}x throughput={self.throughput_x:.2f}x")




class Protected:
    """A protected payload: views into `words`, plus scheme redundancy."""

    def __init__(self, payload: Any, redundancy: Any, scheme: "Scheme",
                 words: torch.Tensor, spec: arena.ArenaSpec):
        self.payload = payload
        self.redundancy = redundancy
        self.scheme = scheme
        self.words = words      # (n_words,) or (3, n_words) int32 arena
        self.spec = spec

    def __repr__(self) -> str:
        return f"Protected(scheme={self.scheme.name})"


def _zero_report(device) -> ScrubReport:
    z = torch.zeros((), dtype=torch.int32, device=device)
    return ScrubReport(corrected=z, parity_fixed=z, uncorrectable=z)


def _vote_counts(a: Any, b: Any, c: Any) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """(corrected, uncorrectable) word counts of a 3-copy vote: words where
    a majority exists and some copy differs, and words where all three
    copies pairwise differ (the reference's convention)."""
    corrected = conflicts = None
    for x, y, z in zip(T.leaves(a), T.leaves(b), T.leaves(c)):
        xw, yw, zw = (arena.leaf_to_words(v) for v in (x, y, z))
        d01, d02, d12 = xw != yw, xw != zw, yw != zw
        conflict = d01 & d02 & d12
        n_corr = ((d01 | d02 | d12) & ~conflict).sum(dtype=torch.int32)
        n_conf = conflict.sum(dtype=torch.int32)
        corrected = n_corr if corrected is None else corrected + n_corr
        conflicts = n_conf if conflicts is None else conflicts + n_conf
    return corrected, conflicts


def _placements(pspecs: Any, mesh) -> Any:
    from ..pshard import to_placements
    return T.map_tree(lambda sp: to_placements(sp, mesh), pspecs)


def _copies(words: torch.Tensor, n: int = 3) -> torch.Tensor:
    """(n, n_words) arena holding n copies of `words`."""
    out = torch.empty((n,) + tuple(words.shape), dtype=words.dtype,
                      device=words.device)
    for i in range(n):
        out[i].copy_(words)
    return out


class Scheme:
    """Protection-scheme protocol.  Subclasses are frozen dataclasses."""

    @property
    def name(self) -> str:
        raise NotImplementedError

    def protect(self, payload: Any) -> Protected:
        raise NotImplementedError

    def refresh(self, payload: Any,
                prot: Optional[Protected] = None) -> Protected:
        """Re-protect after the payload was rewritten (an optimizer step).
        The bits are the reference's `protect(payload)`.  When `payload`
        is the views of `prot`'s own arena (the payload a training loop
        updates in place), the schemes that hold redundancy rebuild it
        over that arena in place; otherwise this is `protect`, a fresh
        copy."""
        return self.protect(payload)

    def _owns(self, payload: Any, prot: Optional[Protected]) -> bool:
        """Is `payload` laid out over copy 0 of `prot`'s arena?"""
        if prot is None:
            return False
        found = arena.backing(payload)
        row = prot.words if prot.words.ndim == 1 else prot.words[0]
        return (found is not None and found[0].data_ptr() == row.data_ptr()
                and found[1] == prot.spec)

    def scrub(self, prot: Protected,
              mesh=None) -> Tuple[Protected, ScrubReport]:
        """Verify/correct the redundancy.  With a mesh, arena-wide scrubs
        run one block range per rank with summed counters -- bit-exact
        against mesh=None."""
        raise NotImplementedError

    def vote_share(self, report: ScrubReport):
        """The copy-vote share of a scrub report: None for schemes that do
        not vote, else an int32 device counter (fetch it with the rest)."""
        return None

    def scrub_into(self, prot: Protected, metrics, mesh=None, registry=None
                   ) -> Tuple[Protected, dict]:
        """Scrub and fold the report into a metrics-registry accumulator
        dict (`obs.MetricsRegistry` names, device-side adds), so counters
        stay on the device between scrubs::

            metrics = DEFAULT_REGISTRY.zeros(["ecc_corrected", ...], dev)
            prot, metrics = scheme.scrub_into(prot, metrics)
            stats = fetch_telemetry(metrics)     # one transfer at the end
        """
        from ..obs import DEFAULT_REGISTRY
        registry = registry if registry is not None else DEFAULT_REGISTRY
        fixed, report = self.scrub(prot, mesh=mesh)
        updates = registry.from_report(report)
        vd = self.vote_share(report)
        if vd is not None:
            updates["tmr_final_disagreements"] = vd
        return fixed, registry.accumulate(metrics, updates)

    #: does the redundancy belong in a checkpoint?  True for compact parity
    #: tables; False when it is full copies (rebuilt on restore).
    checkpoint_redundancy: bool = False

    def adopt(self, payload: Any, redundancy: Any) -> Protected:
        """Rebuild a Protected from a stored payload and redundancy (a
        checkpoint restore, a scrub of a kept store) without re-encoding.
        The arena is the payload's own when its leaves are views laid out
        over one as `arena.pack` places them (so a scrub repairs them in
        place), else a packed copy."""
        words, spec = arena.words_of(payload)
        return Protected(arena.unpack(words, spec), redundancy, self, words,
                         spec)

    def read(self, prot: Protected) -> Any:
        return prot.payload

    def shardings(self, payload: Any, pspecs: Any, mesh,
                  rules=None) -> Protected:
        """DTensor placements shaped like ``protect(payload)`` on `mesh`:
        `pspecs` is the payload's `spec_for` tree (`models.params.
        partition_specs`).  Parity tables shard their arena-block axis
        across the whole mesh; TMR copies are placed like the payload they
        mirror.  The result's `words` and `spec` are None."""
        return Protected(_placements(pspecs, mesh),
                         self._redundancy_shardings(payload, pspecs, mesh,
                                                    rules),
                         self, None, None)

    def _redundancy_shardings(self, payload, pspecs, mesh, rules):
        return None

    def corrupt_store(self, prot: Protected, model, generator: torch.Generator,
                      dt: float = 1.0) -> Protected:
        """Inject storage faults into every held data copy (payload first,
        then TMR copies), in place; parity tables are left untouched.
        `generator` may be a `core.prng` key: the TMR copies then take
        ``split(key, 3)``, as the reference's do."""
        model.corrupt(prot.payload, generator, dt)
        return prot

    def overhead(self) -> CostReport:
        raise NotImplementedError

    def cost_events(self, base, profile, spec):
        """mMPU cost-model hookup (`costmodel.compile.lower_step`): extend
        or transform a redundancy-free step event stream with this
        scheme's redundancy traffic.  `base` is a sequence of
        `costmodel.MmpuEvent`; `profile` a `costmodel.StepProfile`;
        `spec` a `costmodel.DeviceSpec`.  `overhead()` is the closed form
        these streams agree with."""
        return tuple(base)


@dataclasses.dataclass(frozen=True)
class Unprotected(Scheme):
    """No redundancy -- the baseline every CostReport is relative to."""

    @property
    def name(self) -> str:
        return "unprotected"

    def protect(self, payload: Any) -> Protected:
        words, spec = arena.pack(payload)
        return Protected(arena.unpack(words, spec), None, self, words, spec)

    def scrub(self, prot: Protected,
              mesh=None) -> Tuple[Protected, ScrubReport]:
        return prot, _zero_report(prot.words.device)

    def overhead(self) -> CostReport:
        return CostReport()


class ArenaEcc(Scheme):
    """Shared machinery of packed-arena word codes; subclasses supply
    `n_parity_words`, `_encode` and `_scrub`.

    Subclasses are frozen dataclasses carrying at least ``impl`` (backend
    override) and ``write_back``: `read_corrected` works for every code,
    and a True flag tells the server's batcher to correct and persist the
    KV pages a tick is about to read before it reads them, instead of
    waiting for the periodic pool scrub."""

    code_name = "ecc"

    @property
    def name(self) -> str:
        return self.code_name + ("-wb" if self.write_back else "")

    @property
    def n_parity_words(self) -> int:
        """Redundancy words per 32-word block (the parity-table width)."""
        raise NotImplementedError

    def _encode(self, buf: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _scrub(self, buf: torch.Tensor, parity: torch.Tensor,
               out_parity: Optional[torch.Tensor] = None, mesh=None):
        raise NotImplementedError

    def _sharded(self, op, buf, parity, out_parity, mesh, **kw):
        """`op.scrub` on this rank's block range of `mesh` with summed
        counts (the backend's `scrub_sharded`), or `op.scrub` itself."""
        if mesh is None:
            return op.scrub(buf, parity, out_parity=out_parity, **kw)
        if out_parity is not None:
            raise ValueError("a sharded scrub corrects its parity in place")
        return op.scrub_sharded(buf, parity, mesh=mesh, **kw)

    def _ecc_events(self, profile, spec, copies: int = 1):
        """This code's mMPU redundancy traffic (costmodel hookup)."""
        raise NotImplementedError

    def cost_events(self, base, profile, spec):
        return tuple(base) + self._ecc_events(profile, spec)

    def protect(self, payload: Any) -> Protected:
        words, spec = arena.pack(payload)
        return Protected(arena.unpack(words, spec), self._encode(words), self,
                         words, spec)

    def refresh(self, payload: Any,
                prot: Optional[Protected] = None) -> Protected:
        """A fresh parity table of `prot`'s arena when `payload` is its
        views (one encode launch, no copy of the words), else `protect`."""
        if not self._owns(payload, prot):
            return self.protect(payload)
        return Protected(payload, self._encode(prot.words), self,
                         prot.words, prot.spec)

    checkpoint_redundancy = True

    def scrub(self, prot: Protected,
              mesh=None) -> Tuple[Protected, ScrubReport]:
        _, _, counts = self._scrub(prot.words, prot.redundancy, mesh=mesh)
        return prot, ScrubReport(corrected=counts[0], parity_fixed=counts[1],
                                 uncorrectable=counts[2])

    def read_corrected(self, prot: Protected, mesh=None):
        """Write-back-on-read at the scheme level: decode through a fused
        scrub, so the caller gets corrected bits and the corrected store
        persists (in place).  Returns (payload, prot, report)."""
        fixed, report = self.scrub(prot, mesh=mesh)
        return fixed.payload, fixed, report

    def encode_arena(self, buf: torch.Tensor) -> torch.Tensor:
        """Parity table of a packed int32 arena."""
        return self._encode(buf)

    def _redundancy_shardings(self, payload, pspecs, mesh, rules):
        from ..optim.sharding_rules import parity_pspec
        from ..pshard import to_placements
        n_blocks = arena.arena_spec(payload).n_blocks
        return to_placements(parity_pspec(n_blocks, self.n_parity_words,
                                          mesh, rules), mesh)

    def scrub_arena(self, buf: torch.Tensor, parity: torch.Tensor,
                    mesh=None):
        """Fused scrub of a packed arena, in place: (buf, parity, counts (3,)
        int32 corrected / parity_fixed / uncorrectable)."""
        return self._scrub(buf, parity, mesh=mesh)

    def inject_scrub_arena(self, buf: torch.Tensor, parity: torch.Tensor,
                           mask: torch.Tensor, mesh=None):
        """Fused corrupt+repair of a packed arena, in place: XOR the fault
        mask in, then the code's scrub.  Returns (buf, parity, counts (4,)
        int32 injected / corrected / parity_fixed / uncorrectable).  Codes
        with a dedicated fused kernel override this (diagonal parity routes
        to kernels/inject_scrub); the default is right for every
        block-local word code."""
        injected = popcount32(as_u64(mask)).sum(dtype=torch.int32)
        buf ^= mask
        _, par, counts = self._scrub(buf, parity, mesh=mesh)
        return buf, par, torch.cat([injected[None], counts])

    def scrub_copies(self, words: torch.Tensor, parity: torch.Tensor,
                     keep_parity: bool = True, mesh=None):
        """Scrub C same-layout copies, a contiguous (C, n_words) arena, in
        ONE launch and in place (the reference concatenates the copies).

        parity: (C, n_blocks, F) per-copy tables, corrected in place; or
        one shared (n_blocks, F) table of the clean arena, which every copy
        reads (block b of the stacked buffer reads row b mod n_blocks) --
        then the per-copy corrected tables are written to a new
        (C, n_blocks, F) tensor, or dropped when `keep_parity` is False.
        Returns (words, per-copy parity or None, counts (3,) int32 summed
        over the copies).  With a mesh, the stacked block axis is cut into
        one range per rank (a shared table is first repeated per copy, so
        every range has its own rows)."""
        C = words.shape[0]
        flat = words.view(-1)
        if parity.ndim == 2 and mesh is not None:
            parity = parity.repeat(C, 1).view(C, *parity.shape)
        if parity.ndim == 3:
            _, par, counts = self._scrub(flat, parity.view(
                -1, parity.shape[-1]), mesh=mesh)
            return words, par.view(parity.shape), counts
        out = None
        if keep_parity:
            out = torch.empty((C * parity.shape[0], parity.shape[1]),
                              dtype=parity.dtype, device=parity.device)
        _, par, counts = self._scrub(flat, parity, out)
        return words, (par.view(C, *parity.shape) if keep_parity else None), \
            counts


@dataclasses.dataclass(frozen=True)
class DiagParityEcc(ArenaEcc):
    """Diagonal-parity word ECC over the packed arena (paper §IV): corrects
    one flipped bit per 32-word block at 3 parity words of storage.  With
    `write_back` (``ecc-wb``) the server's batcher repairs the KV pages a
    tick reads before the decode sees them (`ContinuousBatcher`)."""

    slopes: Tuple[int, ...] = (1, 2, -1)
    impl: Optional[str] = None
    write_back: bool = False

    code_name = "ecc"

    @property
    def n_parity_words(self) -> int:
        return len(self.slopes)

    def _op(self):
        return backend.dispatch("diag_parity", self.impl)

    def _encode(self, buf):
        return self._op().encode(buf, slopes=self.slopes)

    def _scrub(self, buf, parity, out_parity=None, mesh=None):
        return self._sharded(self._op(), buf, parity, out_parity, mesh,
                             slopes=self.slopes)

    def inject_scrub_arena(self, buf, parity, mask, mesh=None):
        # diagonal parity has a dedicated fused corrupt+repair kernel
        op = backend.dispatch("inject_scrub", self.impl)
        if mesh is not None:
            return op.sharded(buf, parity, mask, mesh=mesh,
                              slopes=self.slopes)
        return op(buf, parity, mask, slopes=self.slopes)

    def overhead(self) -> CostReport:
        return CostReport(storage_x=1.0 + len(self.slopes) / arena.BLOCK,
                          latency_x=1.26)

    def _ecc_events(self, profile, spec, copies: int = 1):
        from ..costmodel.compile import ecc_events
        return ecc_events(profile, spec, self.slopes, copies=copies)


@dataclasses.dataclass(frozen=True)
class HsiaoSecDed(ArenaEcc):
    """(39,32) Hsiao SEC-DED word code over the packed arena
    (kernels/hsiao_secded): 7 odd-weight-column check bits per 32-bit word,
    packed as 7 parity words per block.  Every word decodes on its own --
    one flip in each of a block's 32 words is still corrected -- and double
    errors are detected (counted uncorrectable, left as they are) instead
    of miscorrected.  Storage 1 + 7/32.  `write_back` (``hsiao-wb``) acts in
    the server's batcher as for `DiagParityEcc`."""

    impl: Optional[str] = None
    write_back: bool = False

    code_name = "hsiao"

    @property
    def n_parity_words(self) -> int:
        from ..kernels.hsiao_secded.code import N_CHECKS
        return N_CHECKS

    def _op(self):
        return backend.dispatch("hsiao_secded", self.impl)

    def _encode(self, buf):
        return self._op().encode(buf)

    def _scrub(self, buf, parity, out_parity=None, mesh=None):
        return self._sharded(self._op(), buf, parity, out_parity, mesh)

    def overhead(self) -> CostReport:
        return CostReport(storage_x=1.0 + 7.0 / arena.BLOCK, latency_x=1.42)

    def _ecc_events(self, profile, spec, copies: int = 1):
        from ..costmodel.compile import secded_events
        return secded_events(profile, spec, copies=copies)


@dataclasses.dataclass(frozen=True)
class Tmr(Scheme):
    """Triple modular redundancy with per-bit voting (paper §V), in the
    serial, parallel or semi_parallel discipline (same voted bits)."""

    discipline: str = "serial"
    impl: Optional[str] = None

    def __post_init__(self):
        if self.discipline not in TMR_COSTS:
            raise ValueError(f"discipline must be one of {sorted(TMR_COSTS)}")

    @property
    def name(self) -> str:
        return f"tmr-{self.discipline.replace('_', '-')}"

    def _vote(self):
        return backend.dispatch("tmr_vote", self.impl)

    def protect(self, payload: Any) -> Protected:
        words, spec = arena.pack(payload)
        words3 = _copies(words)
        return Protected(arena.unpack(words3[0], spec),
                         (arena.unpack(words3[1], spec),
                          arena.unpack(words3[2], spec)),
                         self, words3, spec)

    def refresh(self, payload: Any,
                prot: Optional[Protected] = None) -> Protected:
        """Copies 1 and 2 := copy 0 of `prot`'s arena, in place, when
        `payload` is copy 0's views; else `protect`."""
        if not self._owns(payload, prot):
            return self.protect(payload)
        prot.words[1:].copy_(prot.words[0].expand_as(prot.words[1:]))
        return prot

    def read(self, prot: Protected) -> Any:
        w = prot.words
        return arena.unpack(self._vote()(w[0], w[1], w[2]), prot.spec)

    def vote_share(self, report: ScrubReport):
        # every TMR repair and every conflict is a copy disagreement
        return report.corrected + report.uncorrectable

    def _redundancy_shardings(self, payload, pspecs, mesh, rules):
        ns = _placements(pspecs, mesh)
        return (ns, ns)

    def scrub(self, prot: Protected,
              mesh=None) -> Tuple[Protected, ScrubReport]:
        # voting is elementwise: no block ranges to cut (the reference
        # takes the mesh and has no sharded path either)
        c1, c2 = prot.redundancy
        corrected, conflicts = _vote_counts(prot.payload, c1, c2)
        w = prot.words
        w[:] = self._vote()(w[0], w[1], w[2])       # every copy := the vote
        report = ScrubReport(corrected=corrected,
                             parity_fixed=torch.zeros_like(corrected),
                             uncorrectable=conflicts)
        return prot, report

    def adopt(self, payload: Any, redundancy: Any) -> Protected:
        """The three copies (payload and the (c1, c2) redundancy) stacked
        into a fresh (3, n_words) arena."""
        return _adopt_copies(self, (payload,) + tuple(redundancy),
                             lambda views: (views[1], views[2]))

    def corrupt_store(self, prot, model, generator, dt: float = 1.0):
        c1, c2 = prot.redundancy
        for copy, g in zip((prot.payload, c1, c2),
                           prng.streams(generator, 3)):
            model.corrupt(copy, g, dt)
        return prot

    def wrap(self, serve_fn, sequential: bool = False):
        """TMR-voted serving: `serve_fn(params, *inputs) -> tree`, called as
        wrapped(p1, p2, p3, *inputs) with the three copies' parameters;
        every leaf of the three outputs is voted per bit through the
        ``tmr_vote`` backend.  The copies run one after another under every
        discipline, and `wrapped.cost` reports the discipline's accounting.
        `sequential` has no effect here: it is kept for the reference's
        signature, where it turns off the vmap of parallel and
        semi_parallel (the voted bits are the same either way)."""
        vote = self._vote()

        def wrapped(p1, p2, p3, *inputs):
            outs = [serve_fn(p, *inputs) for p in (p1, p2, p3)]
            return T.map_tree(vote, *outs)

        wrapped.cost = self.overhead()
        return wrapped

    def overhead(self) -> CostReport:
        c = TMR_COSTS[self.discipline]
        return CostReport(storage_x=3.0, latency_x=c.latency_x,
                          area_x=c.area_x, throughput_x=c.throughput_x)

    def cost_events(self, base, profile, spec):
        from ..costmodel.compile import tmr_transform, vote_events
        return tmr_transform(base, self.discipline) \
            + vote_events(profile, spec)


@dataclasses.dataclass(frozen=True)
class Compose(Scheme):
    """A per-copy arena word code under TMR voting (paper §VI): scrub every
    copy with the code in one fused launch, then vote per bit across the
    scrubbed copies.  The report sums the per-copy corrected/parity_fixed
    counts plus the voted word repairs; `uncorrectable` counts words still
    three-way-disagreeing after the per-copy scrub."""

    ecc: ArenaEcc = DiagParityEcc()
    tmr: Tmr = Tmr()

    @property
    def name(self) -> str:
        return f"{self.ecc.name}+{self.tmr.name}"

    def protect(self, payload: Any) -> Protected:
        words, spec = arena.pack(payload)
        parity3 = _copies(self.ecc._encode(words))
        words3 = _copies(words)
        # redundancy: ((copy 1, copy 2), (3, n_blocks, F) per-copy parity,
        # which unpacks like the reference's (p0, p1, p2) tuple)
        return Protected(arena.unpack(words3[0], spec),
                         ((arena.unpack(words3[1], spec),
                           arena.unpack(words3[2], spec)), parity3),
                         self, words3, spec)

    def refresh(self, payload: Any,
                prot: Optional[Protected] = None) -> Protected:
        """Copies 1 and 2 := copy 0 and every copy's parity := copy 0's
        encode (one launch), in place, when `payload` is copy 0's views of
        `prot`'s arena; else `protect`."""
        if not self._owns(payload, prot):
            return self.protect(payload)
        w = prot.words
        w[1:].copy_(w[0].expand_as(w[1:]))
        prot.redundancy[1][:] = self.ecc._encode(w[0])
        return prot

    def read(self, prot: Protected) -> Any:
        w = prot.words
        return arena.unpack(self.tmr._vote()(w[0], w[1], w[2]), prot.spec)

    def vote_share(self, report: ScrubReport):
        # only the post-ECC three-way conflicts are separable from the
        # merged report (repaired pairwise disagreements are folded into
        # `corrected` with the per-copy ECC counts)
        return report.uncorrectable

    def _redundancy_shardings(self, payload, pspecs, mesh, rules):
        ns = _placements(pspecs, mesh)
        per_copy = self.ecc._redundancy_shardings(payload, pspecs, mesh,
                                                  rules)
        # the (3, n_blocks, F) table: copies replicated, blocks as one
        # copy's table
        from torch.distributed.tensor import Shard
        shift = [Shard(p.dim + 1) if isinstance(p, Shard) else p
                 for p in per_copy]
        return ((ns, ns), shift)

    def scrub(self, prot: Protected,
              mesh=None) -> Tuple[Protected, ScrubReport]:
        w, parity3 = prot.words, prot.redundancy[1]
        _, _, counts = self.ecc.scrub_copies(w, parity3, mesh=mesh)
        d01, d02, d12 = w[0] != w[1], w[0] != w[2], w[1] != w[2]
        conflict = d01 & d02 & d12
        report = ScrubReport(
            corrected=counts[0]
            + ((d01 | d02 | d12) & ~conflict).sum(dtype=torch.int32),
            parity_fixed=counts[1],
            uncorrectable=conflict.sum(dtype=torch.int32))
        w[:] = self.tmr._vote()(w[0], w[1], w[2])   # every copy := the vote
        parity3[:] = self.ecc._encode(w[0])
        return prot, report

    def adopt(self, payload: Any, redundancy: Any) -> Protected:
        """The three copies stacked into a fresh (3, n_words) arena beside
        the per-copy parity: redundancy ((c1, c2), parity3), parity3 a
        (3, n_blocks, F) tensor or three (n_blocks, F) tables."""
        (c1, c2), parity = redundancy
        if not isinstance(parity, torch.Tensor):
            parity = torch.stack(list(parity))
        return _adopt_copies(self, (payload, c1, c2),
                             lambda views: ((views[1], views[2]), parity))

    def corrupt_store(self, prot, model, generator, dt: float = 1.0):
        (c1, c2), _ = prot.redundancy
        for copy, g in zip((prot.payload, c1, c2),
                           prng.streams(generator, 3)):
            model.corrupt(copy, g, dt)
        return prot

    def overhead(self) -> CostReport:
        e, t = self.ecc.overhead(), self.tmr.overhead()
        return CostReport(storage_x=e.storage_x * t.storage_x,
                          latency_x=e.latency_x * t.latency_x,
                          area_x=e.area_x * t.area_x,
                          throughput_x=e.throughput_x * t.throughput_x)

    def cost_events(self, base, profile, spec):
        # execution triplicates under the TMR discipline; each copy
        # carries its own parity table, so the word-code traffic covers
        # copies=3 blocks (scrub_copies fuses them in one pass)
        from ..costmodel.compile import tmr_transform, vote_events
        return (tmr_transform(base, self.tmr.discipline)
                + vote_events(profile, spec)
                + self.ecc._ecc_events(profile, spec, copies=3))


def _adopt_copies(scheme: Scheme, copies, redundancy) -> Protected:
    """A Protected over a fresh (3, n_words) arena holding the three given
    copies; `redundancy(views)` builds its redundancy from the three
    copies' views."""
    packed = [arena.words_of(c) for c in copies]
    spec = packed[0][1]
    words3 = torch.stack([w for w, _ in packed])
    views = [arena.unpack(words3[i], spec) for i in range(3)]
    return Protected(views[0], redundancy(views), scheme, words3, spec)


# --------------------------------------------------------------------------
# scheme registry + spec strings (serve --scheme)
# --------------------------------------------------------------------------

_SCHEME_FACTORIES: "dict[str, Tuple[Any, str]]" = {}
_SCHEME_ALIASES: "dict[str, str]" = {}


def register_scheme(token: str, factory, help: str = "",
                    aliases: Tuple[str, ...] = ()) -> None:
    """Register `factory(impl) -> Scheme` under spec token `token`."""
    _SCHEME_FACTORIES[token] = (factory, help)
    for a in aliases:
        _SCHEME_ALIASES[a] = token


def scheme_choices() -> Tuple[str, ...]:
    """Every registered spec token, plus the composition grammar (one
    arena code + one TMR discipline joined by '+')."""
    return tuple(_SCHEME_FACTORIES) + ("ecc+tmr", "hsiao+tmr")


def scheme_help() -> str:
    lines = [f"{tok}: {hlp}" for tok, (_, hlp) in _SCHEME_FACTORIES.items()]
    lines.append("<code>+tmr[-<discipline>]: per-copy arena code under "
                 "TMR voting (e.g. ecc+tmr-serial, hsiao+tmr)")
    return "; ".join(lines)


register_scheme("off", lambda impl: Unprotected(),
                "no redundancy (baseline)", aliases=("none", "unprotected"))
register_scheme("ecc", lambda impl: DiagParityEcc(impl=impl),
                "diagonal-parity word code, 1 correction per 32-word block,"
                " +3/32 storage")
register_scheme("ecc-wb", lambda impl: DiagParityEcc(impl=impl,
                                                     write_back=True),
                "diagonal parity with write-back-on-read serving")
register_scheme("hsiao", lambda impl: HsiaoSecDed(impl=impl),
                "(39,32) Hsiao SEC-DED, per-word correct + double-error "
                "detect, +7/32 storage")
register_scheme("hsiao-wb", lambda impl: HsiaoSecDed(impl=impl,
                                                     write_back=True),
                "Hsiao SEC-DED with write-back-on-read serving")

_TMR_ALIASES = {"serial": "serial", "parallel": "parallel",
                "semi": "semi_parallel", "semi-parallel": "semi_parallel",
                "semi_parallel": "semi_parallel"}

for _disc, _canon in (("serial", "serial"), ("parallel", "parallel"),
                      ("semi", "semi_parallel")):
    register_scheme(
        f"tmr-{_disc}",
        lambda impl, d=_canon: Tmr(discipline=d, impl=impl),
        f"triple modular redundancy, {_canon.replace('_', '-')} discipline")

def _parse_one(token: str, impl: Optional[str]) -> Scheme:
    token = token.strip().lower()
    token = _SCHEME_ALIASES.get(token, token)
    if token in _SCHEME_FACTORIES:
        return _SCHEME_FACTORIES[token][0](impl)
    if token == "tmr" or token.startswith("tmr-"):
        disc = _TMR_ALIASES.get(token[4:] or "serial")
        if disc is None:
            raise ValueError(f"unknown TMR discipline {token[4:]!r} "
                             f"(expected one of {sorted(_TMR_ALIASES)})")
        return Tmr(discipline=disc, impl=impl)
    raise ValueError(f"unknown scheme {token!r} "
                     f"(expected one of {scheme_choices()})")


def standard_grid(impl: Optional[str] = None,
                  include_hsiao: bool = False) -> Tuple[Scheme, ...]:
    """The canonical sweep grid (every scheme family, all TMR
    disciplines); `include_hsiao` adds the SEC-DED code, solo and composed
    with TMR."""
    grid = (Unprotected(), DiagParityEcc(impl=impl),
            Tmr("serial", impl=impl), Tmr("parallel", impl=impl),
            Tmr("semi_parallel", impl=impl),
            Compose(DiagParityEcc(impl=impl), Tmr("serial", impl=impl)))
    if include_hsiao:
        grid += (HsiaoSecDed(impl=impl),
                 Compose(HsiaoSecDed(impl=impl), Tmr("serial", impl=impl)))
    return grid


def parse_scheme(spec: str, impl: Optional[str] = None) -> Scheme:
    """Parse any registered token (``off | ecc | ecc-wb | hsiao | hsiao-wb
    | tmr-<discipline>``) or a composition ``<code>+tmr[-<discipline>]``
    (discipline serial | parallel | semi)."""
    parts = [_parse_one(t, impl) for t in spec.split("+")]
    if len(parts) == 1:
        return parts[0]
    if len(parts) == 2:
        eccs = [p for p in parts if isinstance(p, ArenaEcc)]
        tmrs = [p for p in parts if isinstance(p, Tmr)]
        if len(eccs) == 1 and len(tmrs) == 1:
            return Compose(ecc=eccs[0], tmr=tmrs[0])
    raise ValueError(f"cannot compose scheme spec {spec!r} "
                     "(expected <code>+tmr[-<discipline>])")
