"""Generation engine: prefill + greedy decode under a protection scheme
(port of `repro.launch.engine.GenerationEngine`, without chunking, mesh
and the mMPU cost model).

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
  inside each step and vote the token ids (and, with `vote_cache`, the KV
  caches) every `vote_every` steps on the reference's schedule
  ``(step + 1) % vote_every == 0``; 'serial' runs three single-copy
  generations and votes the sequences.  What is held against the reference
  is tokens and counters, not the launch shape.
* **telemetry** -- scrub counts, per-step and final TMR disagreements and
  `tokens_emitted` stay on the device; `fetch_telemetry` moves them to the
  host in one transfer after timing.

    engine = GenerationEngine(cfg, scheme, gen=32, device="cuda")
    store, prep = engine.prepare(params, generator=g, fault=model)
    tokens, telem = engine.generate(store, batch)
    stats = fetch_telemetry({**prep, **telem})
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..core import arena
from ..core import tree as T
from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.steps import make_decode_step, make_prefill_step
from ..obs import fetch_telemetry
from ..reliability.scheme import ArenaEcc, Compose, Scheme, Tmr, Unprotected

__all__ = ["GenerationEngine", "fetch_telemetry"]


def _copy(stacked: Any, i: int) -> Any:
    return T.map_tree(lambda x: x[i], stacked)


def _disagreements(t3) -> torch.Tensor:
    """Token positions where the three copies do not all agree (int32)."""
    a, b, c = t3
    return ((a != b) | (a != c) | (b != c)).sum(dtype=torch.int32)


class GenerationEngine:
    """Batched greedy generation under a protection scheme.

    cfg        : model config (dense family).
    scheme     : `Unprotected` (None), `DiagParityEcc`, `Tmr`, `Compose`.
    gen        : tokens to generate (prompt excluded).
    cache_len  : decode-cache length (default prompt_len + gen).
    vote_every : parallel/semi TMR or Compose: vote the per-copy token ids
                 every k decode steps (0 = vote only the final sequences).
    vote_cache : also vote the KV caches at those vote points.
    execution  : 'scan' (the in-loop vote schedule) or 'loop' (three
                 sequential generations, one final vote -- the reference).
    device     : where it runs; CUDA unless 'cpu' is asked for.
    """

    def __init__(self, cfg: ModelConfig, scheme: Optional[Scheme] = None, *,
                 gen: int, cache_len: Optional[int] = None,
                 vote_every: int = 0, vote_cache: bool = False,
                 execution: str = "scan", device=None):
        if execution not in ("scan", "loop"):
            raise ValueError(f"execution must be 'scan' or 'loop', "
                             f"got {execution!r}")
        self.device = resolve_device(device)
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

    def prepare(self, params: Any, generator: Optional[torch.Generator] = None,
                fault=None, dt: float = 1.0) -> Tuple[Any, Dict[str, Any]]:
        """Build the serving store from clean `params` (left unchanged).

        Applies one exposure interval of `fault` to every held data copy
        (copies in order 0, 1, 2, leaves in flatten order, all drawn from
        `generator`), then the scheme's storage-side protection.  Returns
        (store, prep telemetry): the store is a parameter tree of views
        into its arena -- (3, *shape) leaves for TMR and Compose."""
        scheme = self.scheme
        words, spec = arena.words_of(params)
        if words.device != self.device:
            raise ValueError(f"params are on {words.device}, the engine runs "
                             f"on {self.device}")

        def corrupt(w: torch.Tensor) -> None:
            if fault is not None:
                fault.corrupt(arena.unpack(w, spec), generator, dt)

        def copies() -> torch.Tensor:
            w3 = torch.empty((3, spec.n_words), dtype=torch.int32,
                             device=words.device)
            for i in range(3):
                w3[i].copy_(words)
                corrupt(w3[i])
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
                make_decode_step(self.cfg))

    def _batch(self, batch: Dict[str, torch.Tensor]):
        return {k: v.to(self.device) for k, v in batch.items()}

    def _single(self, params, batch, prefill, decode) -> torch.Tensor:
        tok, _, cache = prefill(params, batch)
        toks = [tok]
        for _ in range(self.gen - 1):
            tok, _, cache = decode(params, tok, cache)
            toks.append(tok)
        return torch.cat(toks, dim=1)

    def _concurrent(self, store, batch, prefill, decode):
        """parallel/semi TMR: the three copies advance together, one
        decode step each per iteration, voted on the reference's schedule."""
        vote = self._tmr()._vote()
        tok3, cache3 = [], []
        for i in range(3):
            tok, _, cache = prefill(_copy(store, i), batch)
            tok3.append(tok)
            cache3.append(cache)
        seq3 = [[t] for t in tok3]
        dis = [_disagreements(tok3)]
        for step in range(self.gen - 1):
            for i in range(3):
                tok3[i], _, cache3[i] = decode(_copy(store, i), tok3[i],
                                               cache3[i])
            dis.append(_disagreements(tok3))
            if self.vote_every and (step + 1) % self.vote_every == 0:
                tok3 = [vote(*tok3)] * 3
                if self.vote_cache:
                    for name in sorted(cache3[0]):
                        a, b, c = (cc[name] for cc in cache3)
                        vote(a, b, c, out=a)   # in place into copy 0,
                        b.copy_(a)             # then to the other copies
                        c.copy_(a)
            for i in range(3):
                seq3[i].append(tok3[i])
        seq3 = [torch.cat(s, dim=1) for s in seq3]
        return vote(*seq3), {
            "tmr_step_disagreements": torch.stack(dis),
            "tmr_final_disagreements": _disagreements(seq3)}

    def _finish(self, tokens, telem):
        out = dict(telem)
        out["tokens_emitted"] = torch.tensor(tokens.numel(), dtype=torch.int32,
                                             device=tokens.device)
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
        full generations with one final vote."""
        return self._generate(store, batch, concurrent=False)

    def _generate(self, store, batch, concurrent: bool):
        batch = self._batch(batch)
        prefill, decode = self._steps(batch["tokens"].shape[1])
        with torch.no_grad():
            if not self.copy_axis:
                return self._finish(self._single(store, batch, prefill,
                                                 decode), {})
            if concurrent:
                return self._finish(*self._concurrent(store, batch, prefill,
                                                      decode))
            outs = [self._single(_copy(store, i), batch, prefill, decode)
                    for i in range(3)]
            return self._finish(self._tmr()._vote()(*outs), {
                "tmr_final_disagreements": _disagreements(outs)})
