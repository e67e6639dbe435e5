"""Serving driver: batched generation under a protection scheme, and the
continuous-batching server (port of `repro.launch.serve`).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \\
      --batch 4 --prompt-len 256 --gen 32 --scheme ecc+tmr-parallel \\
      --vote-every 8 --vote-cache --inject-p-bit 1e-9

``--scheme`` takes ``off | ecc | ecc-wb | hsiao | hsiao-wb | tmr-serial |
tmr-parallel | tmr-semi | <code>+tmr[-<discipline>]``.  Parameters come
from random init on a seeded generator, directly into the packed arena on
the device; faults are drawn on the device from a generator seeded with
``seed + 100``.  ``--fault`` picks the fault model at rate
``--inject-p-bit``: ``bitflip`` (transient flips), ``stuckat`` (permanent
defects, half stuck at 0 and half at 1) or ``drift`` (retention drift).
Runs on CUDA by default; ``--device cpu`` runs the plain PyTorch versions
(use it with ``--smoke``).  Scrub and vote counters stay on the device
during the timed region and are fetched once afterwards.

``--chunk N`` generates in chunks of N decode steps with a latency mark
after each (TTFT and TPOT p50/p95/p99; the same tokens either way).
``--trace out.json`` writes the spans as Chrome-trace JSON and ``--metrics
out.jsonl`` a JSONL record of the run.  ``--mmpu-cost`` projects the run
onto the mMPU cost model (`costmodel`): cycles and energy per token for
the scheme, and the ``mmpu_*`` gauges in the telemetry; ``--mmpu-events
PATH`` dumps the event stream as JSONL; ``--mmpu-device`` picks the
`configs.mmpu_paper` device spec.

The vlm and encdec families also get their stub modality input (image
patch or frame embeddings, `make_inputs`).  Server mode (``--server``;
the dense and MoE families, whose caches are paged, as in the reference)
serves an open-loop Poisson trace through the continuous-batching
scheduler (`launch.batching`: paged ECC-protected KV pool, chunk-boundary
admission):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \\
      --server --rate 2 --requests 8 --slots 4 --prompt-len 256 --gen 32 \\
      --scheme hsiao-wb --scrub-every 4 --inject-p-bit 1e-9

Arrivals are paced in real time and never wait for service; per-request
TTFT (queue wait included) and TPOT come from `obs.LatencyTimeline`, and
the report gives p50/p95/p99 tails plus goodput (useful tokens / wall
time).  ``--gen`` becomes the per-request cap, ``--chunk`` the decode chunk
between scheduling points (default 8), ``--prompt-len`` the single
admission bucket, ``--page-tokens`` the KV page size and ``--scrub-every``
the pool-scrub cadence in ticks; ``--adaptive-scrub`` lets
`runtime.AdaptiveScrub` move that cadence from the corrections each pool
scrub finds (``--scrub-every`` seeds its first interval).  Under ``ecc-wb``
and ``hsiao-wb`` every tick first repairs the KV pages it reads
(write-back-on-read).

``--mesh DATAxMODEL`` serves on a mesh of ``data * model`` ranks, one
process each (`launch.mesh.spawn`: under torchrun the given world,
otherwise spawned processes meeting through a file store; ``nccl`` when
every rank has a card of its own, ``gloo`` otherwise -- on the CPU, or
several ranks on one card).  Every rank draws the same parameters and
faults; the store is placed by the logical-axis rules, the scrubs run on
block ranges with summed counters, and parallel/semi TMR fold their copy
axis onto data-replica groups when ``data % 3 == 0`` (DESIGN.md §14).
Tokens and counters equal the run without a mesh; rank 0 alone prints and
writes ``--trace`` and ``--metrics``:

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --mesh 2x2 --batch 2 --prompt-len 16 --gen 8 --scheme ecc \
      --inject-p-bit 1e-6
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..configs import get_config, list_archs
from ..core import prng
from ..device import resolve_device
from ..faults import (FaultModel, RetentionDrift, StuckAtFaults,
                      TransientBitFlips)
from ..models import params as P
from ..models import transformer as T
from ..models.config import ModelConfig
from ..obs import NULL_TRACER, Tracer, fetch_telemetry
from ..reliability import (ArenaEcc, Compose, Scheme, Tmr, Unprotected,
                           parse_scheme, scheme_choices, scheme_help)
from .batching import BatchSpec, ContinuousBatcher, Request, poisson_trace
from .engine import GenerationEngine, _sync
from .mesh import make_test_mesh, parse_mesh, spawn
from .placement import KeyedParams

__all__ = ["serve", "serve_server", "make_inputs", "make_fault",
           "FAULTS", "main"]

#: the fault kinds of ``--fault``
FAULTS = ("bitflip", "stuckat", "drift")


def _log(msg: str) -> None:
    print(msg, flush=True)


def _quiet(msg: str) -> None:
    """A mesh rank other than 0 prints nothing."""


def _mesh_desc(mesh) -> str:
    return "single" if mesh is None else mesh.describe()


def make_fault(kind: str, p_bit: float) -> Optional[FaultModel]:
    """The reference's ``--fault`` mapping at rate p_bit (None when p_bit
    is 0): stuck-at splits the rate evenly between stuck-at-0 and 1."""
    if kind not in FAULTS:
        raise ValueError(f"unknown fault {kind!r} (one of {FAULTS})")
    if not p_bit:
        return None
    return {"bitflip": lambda: TransientBitFlips(p_bit),
            "stuckat": lambda: StuckAtFaults(p_bit / 2, p_bit / 2),
            "drift": lambda: RetentionDrift(p_bit)}[kind]()


def _write_records(tracer: Tracer, record: Dict[str, Any], kind: str,
                   trace_path: Optional[str],
                   metrics_path: Optional[str]) -> None:
    tracer.metrics(record, kind=kind)
    if trace_path:
        tracer.write_chrome(trace_path)
        _log(f"[serve] chrome trace -> {trace_path} "
             f"(load in Perfetto / chrome://tracing)")
    if metrics_path:
        tracer.write_jsonl(metrics_path)
        _log(f"[serve] metrics jsonl -> {metrics_path}")


def make_inputs(cfg: ModelConfig, batch: int, prompt_len: int, seed,
                device, lazy: bool = False) -> Dict[str, Any]:
    """Random-init parameters (into an arena), prompt tokens and the stub
    modality inputs, drawn in that order from one generator seeded with
    `seed` on `device`: ``modality`` holds vis_emb (batch, vis_tokens,
    vis_dim) for the vlm family, enc_emb (batch, prompt_len, d_model) for
    encdec (standard normal, fp32), and nothing for the others.

    `seed` may be a `core.prng` key instead: each draw then takes that one
    key, unsplit, as the reference's serve driver does (`materialize`,
    `randint` for the prompts, `normal` for the modality inputs).  With
    `lazy` the params are then a `placement.KeyedParams`, never drawn
    whole: a mesh's ranks draw their block ranges of them alone."""
    device = resolve_device(device)
    if prng.is_key(seed):
        key = seed.to(device)
        params = KeyedParams(T.model_specs(cfg), key, cfg.param_dtype,
                             device) if lazy else \
            P.materialize(T.model_specs(cfg), key, cfg.param_dtype, device)
        modality = {}
        if cfg.family == "vlm":
            modality["vis_emb"] = prng.normal(
                key, (batch, cfg.vis_tokens, cfg.vis_dim))
        if cfg.family == "encdec":
            modality["enc_emb"] = prng.normal(
                key, (batch, prompt_len, cfg.d_model))
        return {"params": params, "modality": modality,
                "tokens": prng.randint(key, (batch, prompt_len), 0,
                                       cfg.vocab)}
    if lazy:
        raise ValueError("lazy params are drawn from a core.prng key")
    g = torch.Generator(device=device).manual_seed(seed)
    params = P.materialize(T.model_specs(cfg), g, cfg.param_dtype, device)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g,
                           device=device, dtype=torch.int64).to(torch.int32)
    modality = {}
    if cfg.family == "vlm":
        modality["vis_emb"] = torch.randn(
            (batch, cfg.vis_tokens, cfg.vis_dim), generator=g, device=device)
    if cfg.family == "encdec":
        modality["enc_emb"] = torch.randn(
            (batch, prompt_len, cfg.d_model), generator=g, device=device)
    return {"params": params, "tokens": tokens, "modality": modality}


def serve(cfg: ModelConfig, params: Any, tokens: torch.Tensor,
          scheme: Scheme, *, gen: int, vote_every: int = 0,
          vote_cache: bool = False, p_bit: float = 0.0,
          fault: str = "bitflip", seed: int = 0, engine: str = "scan",
          chunk: int = 0, cost_spec=None, mmpu_events: Optional[str] = None,
          trace_path: Optional[str] = None,
          metrics_path: Optional[str] = None, device=None,
          modality: Optional[Dict[str, torch.Tensor]] = None,
          mesh=None, rules=None, reference: Optional[torch.Tensor] = None,
          watch_prepare=None) -> Dict[str, Any]:
    """Prepare the scheme's store under `fault` at rate `p_bit`, run one
    untimed warmup generation and one timed one (chunked when `chunk`),
    fetch the telemetry once, and compare with a clean run.  Prints the
    reference's ``[serve]`` lines and returns the results: tokens, stats,
    agreement, tok/s, prepare seconds, the latency summary (chunked runs),
    the mMPU projection (with `cost_spec`), the store and the engine.
    `modality` holds the stub modality inputs beside the tokens (vis_emb,
    enc_emb; `make_inputs`).

    With `mesh` (this process is one of its ranks) the store is this
    rank's shard, built in the params' own arena where the rank holds one
    copy (`prepare(donate=True)`), so the clean run the agreement compares
    with goes first; rank 0 alone prints and writes the files.  `params`
    may then be a `placement.KeyedParams` (`make_inputs(lazy=True)`): no
    rank holds them whole, and the clean run is a store built the same
    way, without faults, served on the mesh.  `reference`: the clean
    run's tokens when they are at hand (no clean run is made);
    `watch_prepare`: a context manager entered around the store's build
    (a `placement.LargestAllocation`, say)."""
    device = resolve_device(device if mesh is None else mesh.device)
    lead = mesh is None or mesh.rank == 0
    emit = _log if lead else _quiet
    if not lead:
        trace_path = metrics_path = mmpu_events = None
    batch = {"tokens": tokens, **(modality or {})}
    tracer = Tracer(enabled=bool(trace_path or metrics_path))
    eng = GenerationEngine(cfg, scheme, gen=gen, vote_every=vote_every,
                           vote_cache=vote_cache, execution=engine,
                           device=device, cost_spec=cost_spec, mesh=mesh,
                           rules=rules)
    model = make_fault(fault, p_bit)
    ref = reference
    if ref is None and p_bit and isinstance(params, KeyedParams):
        # the clean run: a store of the same source without faults, on
        # the mesh, dropped before the protected store is built
        clean = GenerationEngine(cfg, gen=gen, execution=engine,
                                 device=device, mesh=mesh, rules=rules)
        ref = clean.generate(clean.prepare(params)[0], batch)[0]
        del clean
    elif ref is None and p_bit and mesh is not None:
        # every rank runs the clean reference on its own whole params
        # (no collective; the params are donated to the store below)
        ref = GenerationEngine(cfg, gen=gen, execution=engine,
                               device=device).generate(params, batch)[0]
    fault_gen = torch.Generator(device=device).manual_seed(seed + 100)
    t0 = time.perf_counter()
    with tracer.trace("prepare", scheme=scheme.name), \
            (watch_prepare or contextlib.nullcontext()):
        store, prep = eng.prepare(params, generator=fault_gen, fault=model,
                                  donate=mesh is not None)
        _sync(device)
    prepare_s = time.perf_counter() - t0

    def run(tr=NULL_TRACER):
        if chunk:
            return eng.generate_chunked(store, batch, chunk=chunk, tracer=tr)
        return eng.generate(store, batch) + (None,)

    with tracer.trace("warmup"):
        run()
        _sync(device)
    t0 = time.perf_counter()
    with tracer.trace("generate", scheme=scheme.name, gen=gen, chunk=chunk):
        out, telem, timeline = run(tracer)
        _sync(device)
    dt = time.perf_counter() - t0
    with tracer.trace("fetch_telemetry"):
        stats = fetch_telemetry({**prep, **telem})      # the single fetch

    if ref is None:
        clean = eng if isinstance(scheme, (Unprotected, ArenaEcc)) \
            else GenerationEngine(cfg, gen=gen, execution=engine,
                                  device=device)
        ref = clean.generate(params, batch)[0] if p_bit else out
    agree = float((out == ref).float().mean().item())
    tok_s = tokens.shape[0] * gen / dt
    desc = _mesh_desc(eng.exec_mesh)
    emit(f"[serve] {cfg.name} scheme={scheme.name} engine={engine} "
         f"mesh={desc} device={device.type} fault={fault} p_bit={p_bit:g}: "
         f"{tokens.shape[0]}x{gen} tokens in {dt:.3f}s ({tok_s:.1f} tok/s), "
         f"prepare {prepare_s:.2f}s, agreement with clean run: {agree:.3f}")
    parts = []
    if "ecc_corrected" in stats:
        parts.append(f"ecc corrected={int(stats['ecc_corrected'])} "
                     f"parity_fixed={int(stats['ecc_parity_fixed'])} "
                     f"uncorrectable={int(stats['ecc_uncorrectable'])}")
    if "tmr_final_disagreements" in stats:
        parts.append("vote disagreements: final="
                     f"{int(stats['tmr_final_disagreements'])}")
    if "tmr_step_disagreements" in stats:
        steps = stats["tmr_step_disagreements"]
        parts.append(f"per-step={int(steps.sum())} over {steps.size} steps")
    if parts:
        emit(f"[serve] reliability (fetched after timing): "
             f"{'; '.join(parts)}")
    emit(f"[serve] cost model ({scheme.name}): "
         f"{scheme.overhead().describe()}")
    proj = eng.mmpu_projection(tokens.shape[0])
    if proj is not None:
        stream, cost = proj
        emit(f"[serve] mMPU projection ({cost_spec.name}): "
             f"{cost.describe()}")
        if mmpu_events:
            from ..costmodel import dump_jsonl
            n = dump_jsonl(stream, mmpu_events)
            emit(f"[serve] mmpu event stream -> {mmpu_events} ({n} events)")
    lat = timeline.summary() if timeline is not None else None
    if lat is not None:
        emit(f"[serve] latency tails (chunk={chunk}): "
             f"ttft={lat['ttft_s'] * 1e3:.1f}ms "
             f"tpot p50={lat.get('tpot_p50', float('nan')) * 1e3:.2f}ms "
             f"p95={lat.get('tpot_p95', float('nan')) * 1e3:.2f}ms "
             f"p99={lat.get('tpot_p99', float('nan')) * 1e3:.2f}ms")
    if trace_path or metrics_path:
        record = {"kind": "serve", "arch": cfg.name, "scheme": scheme.name,
                  "engine": engine, "mesh": desc, "p_bit": p_bit,
                  "fault": fault, "batch": tokens.shape[0], "gen": gen,
                  "chunk": chunk, "tok_s": tok_s, "agreement": agree,
                  **{k: np.asarray(v).sum().item() for k, v in stats.items()}}
        if lat is not None:
            record.update({k: float(v) for k, v in lat.items()})
        _write_records(tracer, record, "serve", trace_path, metrics_path)
    sample = out[0, :16].cpu().tolist()
    emit(f"[serve] sample: {sample}")
    return {"tokens": out, "stats": stats, "agreement": agree,
            "tok_s": tok_s, "prepare_s": prepare_s, "latency": lat,
            "mmpu": proj, "store": store, "engine": eng}


def serve_server(cfg: ModelConfig, params: Any, scheme: Scheme, *,
                 spec: BatchSpec, requests: int, rate: float,
                 p_bit: float = 0.0, fault: str = "bitflip",
                 seed: int = 0, scrub_every: int = 0,
                 adaptive_scrub: bool = False,
                 forced_scrub_ticks: Optional[Sequence[int]] = None,
                 trace_path: Optional[str] = None,
                 metrics_path: Optional[str] = None,
                 on_tick: Optional[Callable] = None,
                 realtime: bool = True, device=None, mesh=None,
                 rules=None) -> Dict[str, Any]:
    """The reference's `_run_server`: prepare the scheme's store under
    `fault` at rate `p_bit`, run the warmup requests (first `slots` prompts
    of the trace, 2 tokens each), then serve the Poisson trace of
    `requests` at `rate` paced in real time, fetch the telemetry once and
    print the ``[serve]`` lines.  With `adaptive_scrub` (and a scheme with
    a code) a `runtime.AdaptiveScrub` sized for the pool owns the scrub
    cadence, seeded with interval `scrub_every` (32 when 0);
    `forced_scrub_ticks` replays a recorded schedule instead (the pool is
    scrubbed at exactly those ticks, whatever the cadence).
    `on_tick(batcher)` (a fault-injection hook) is installed after the
    warmup.  Returns the results, the fetched stats, the latency tails and
    the batcher.  With `mesh` (this process is one of its ranks) the
    weight store is sharded over it and rank 0 alone prints and writes the
    files."""
    device = resolve_device(device if mesh is None else mesh.device)
    lead = mesh is None or mesh.rank == 0
    emit = _log if lead else _quiet
    if not lead:
        trace_path = metrics_path = None
    tracer = Tracer(enabled=bool(trace_path or metrics_path))
    b = ContinuousBatcher(cfg, scheme, spec, scrub_every=scrub_every,
                          forced_scrub_ticks=forced_scrub_ticks,
                          device=device, mesh=mesh, rules=rules)
    if adaptive_scrub and b.ecc is not None:
        from ..runtime import AdaptiveScrub
        # the prior is sized for the pool the controller scrubs
        b.adaptive = AdaptiveScrub.from_prior(
            p_bit, b.pool.arena_spec.n_blocks,
            interval0=max(1, scrub_every or 32))
    fault_gen = torch.Generator(device=device).manual_seed(seed + 100)
    with tracer.trace("prepare", scheme=scheme.name):
        prep = b.prepare(params, generator=fault_gen,
                         fault=make_fault(fault, p_bit))
    trace = poisson_trace(requests, rate_rps=rate, spec=spec,
                          vocab=cfg.vocab, seed=seed)
    # run the admission and tick paths once before the open-loop clock
    # starts, so first-call costs do not show up as a queue spike
    warm = [Request(10**6 + i, t.prompt, min(2, t.gen))
            for i, t in enumerate(trace[:spec.slots])]
    with tracer.trace("warmup"):
        b.run(warm)
    b.on_tick = on_tick

    t0 = time.time()
    with tracer.trace("serve", requests=requests, rate=rate,
                      scheme=scheme.name):
        results = b.run(trace, realtime=realtime)
    dt = time.time() - t0
    with tracer.trace("fetch_telemetry"):
        stats = fetch_telemetry({**prep, **b.telemetry()})

    useful = sum(len(r.tokens) for r in results)
    goodput = useful / dt
    ttft = np.asarray([r.ttft_s for r in results])
    tpot = np.asarray([x for r in results for x in r.tpot_samples])

    def q(a, p):
        return float(np.percentile(a, p)) if a.size else float("nan")

    desc = _mesh_desc(b.engine.exec_mesh)
    emit(f"[serve] {cfg.name} server scheme={scheme.name} mesh={desc} "
         f"fault={fault} p_bit={p_bit:g}: {requests} reqs @ {rate:g} rps, "
         f"slots={spec.slots} chunk={spec.chunk}: {useful} tokens in "
         f"{dt:.1f}s (goodput {goodput:.1f} tok/s, {b.ticks} ticks, "
         f"{b.decode_slot_steps} slot-steps)")
    emit(f"[serve] ttft p50={q(ttft, 50) * 1e3:.1f}ms "
         f"p95={q(ttft, 95) * 1e3:.1f}ms p99={q(ttft, 99) * 1e3:.1f}ms; "
         f"tpot p50={q(tpot, 50) * 1e3:.2f}ms p95={q(tpot, 95) * 1e3:.2f}ms "
         f"p99={q(tpot, 99) * 1e3:.2f}ms")
    if stats:
        parts = []
        if "ecc_corrected" in stats:
            parts.append(f"ecc corrected={int(stats['ecc_corrected'])} "
                         f"uncorrectable={int(stats['ecc_uncorrectable'])}")
        if "tmr_final_disagreements" in stats:
            parts.append(f"vote disagreements="
                         f"{int(stats['tmr_final_disagreements'])}")
        emit(f"[serve] reliability (fetched after timing): "
             f"{'; '.join(parts) or 'n/a'}")
    if b.adaptive is not None:
        emit(f"[serve] adaptive scrub: {b.adaptive.summary()}")
    lat = {"ttft_p50_s": q(ttft, 50), "ttft_p95_s": q(ttft, 95),
           "ttft_p99_s": q(ttft, 99), "tpot_p50_s": q(tpot, 50),
           "tpot_p95_s": q(tpot, 95), "tpot_p99_s": q(tpot, 99)}
    if trace_path or metrics_path:
        record = {"kind": "server", "arch": cfg.name, "scheme": scheme.name,
                  "mesh": desc, "p_bit": p_bit, "fault": fault,
                  "rate_rps": rate,
                  "requests": requests, "slots": spec.slots,
                  "chunk": spec.chunk, "gen_cap": spec.gen_cap,
                  "goodput_tok_s": goodput, "ticks": b.ticks,
                  "decode_slot_steps": b.decode_slot_steps, **lat,
                  **{k: np.asarray(v).sum().item() for k, v in stats.items()}}
        _write_records(tracer, record, "server", trace_path, metrics_path)
    return {"results": results, "stats": stats, "goodput_tok_s": goodput,
            "seconds": dt, "latency": lat, "batcher": b}


def main(argv: Optional[list] = None):
    """The CLI; returns the run's summary (`_run`), or with ``--mesh`` the
    summaries of every rank in rank order."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="qwen2.5-14b", choices=list_archs(),
                    help="a ported arch (default: the reference's, "
                         "qwen2.5-14b)")
    ap.add_argument("--layers", type=int, default=0, metavar="N",
                    help="cut the model to N layers at full width (a depth "
                         "cut, for a config that does not fit the card; "
                         "0 keeps the config's depth)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny same-family config (CPU-sized)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--scheme", default="off",
                    metavar="|".join(scheme_choices()), help=scheme_help())
    ap.add_argument("--engine", default="scan", choices=["scan", "loop"],
                    help="scan: in-loop vote schedule (default); loop: three "
                         "sequential generations, one final vote")
    ap.add_argument("--vote-every", type=int, default=0,
                    help="TMR/Compose: vote token ids across copies every k "
                         "decode steps (0 = only at the end)")
    ap.add_argument("--vote-cache", action="store_true",
                    help="also vote the KV caches at the vote points")
    ap.add_argument("--inject-p-bit", type=float, default=0.0,
                    help="corrupt each weight bit of each copy w.p. p")
    ap.add_argument("--fault", default="bitflip", choices=list(FAULTS),
                    help="fault model of the per-copy corruption (rate = "
                         "--inject-p-bit; stuckat splits it evenly between "
                         "stuck-at-0 and stuck-at-1)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="serve on a DATAxMODEL mesh of ranks, one process "
                         "each (e.g. 2x2; DESIGN.md §14): the store sharded "
                         "by the logical-axis rules, scrubs on block ranges "
                         "with summed counters, TMR copies folded onto data "
                         "replica groups when data %% 3 == 0; gloo on the "
                         "CPU or with several ranks a card, else nccl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--server", action="store_true",
                    help="continuous-batching server mode: serve an "
                         "open-loop Poisson trace through the chunk-boundary "
                         "scheduler over the paged ECC-protected KV pool; "
                         "--gen is the per-request cap, --chunk the decode "
                         "chunk (default 8), --prompt-len the admission "
                         "bucket")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="server mode: Poisson arrival rate, requests/s")
    ap.add_argument("--requests", type=int, default=32,
                    help="server mode: number of requests in the trace")
    ap.add_argument("--slots", type=int, default=4,
                    help="server mode: batch slots (empty slots are masked)")
    ap.add_argument("--page-tokens", type=int, default=16,
                    help="server mode: tokens per KV pool page")
    ap.add_argument("--scrub-every", type=int, default=0, metavar="TICKS",
                    help="server mode: pool-scrub cadence in scheduler "
                         "ticks (0 = no periodic scrub)")
    ap.add_argument("--adaptive-scrub", action="store_true",
                    help="server mode: pay-as-you-fault pool-scrub cadence "
                         "(runtime.AdaptiveScrub moves the interval from "
                         "the corrections each scrub finds; --scrub-every "
                         "seeds the first interval; overrides the fixed "
                         "cadence)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="generate in chunks of N decode steps with a "
                         "latency mark after each (TTFT/TPOT tails; 0 = one "
                         "pass); server mode: decode steps per scheduler "
                         "tick (0 = the default 8)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write spans as Chrome-trace JSON")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write a JSONL telemetry record")
    ap.add_argument("--mmpu-cost", action="store_true",
                    help="project the run onto the mMPU cost model: "
                         "cycles/token and energy/token for the scheme, "
                         "mmpu_* gauges in the telemetry")
    ap.add_argument("--mmpu-events", default=None, metavar="PATH",
                    help="dump the mMPU event stream as JSONL (implies "
                         "--mmpu-cost)")
    ap.add_argument("--mmpu-device", default="paper",
                    help="device spec from configs.mmpu_paper "
                         "(default: paper)")
    args = ap.parse_args(argv)

    scheme = parse_scheme(args.scheme)
    if args.engine == "loop" and (args.vote_every or args.vote_cache):
        ap.error("--vote-every/--vote-cache only apply to --engine scan")
    if args.vote_every or args.vote_cache:
        tmr = scheme if isinstance(scheme, Tmr) \
            else scheme.tmr if isinstance(scheme, Compose) else None
        if tmr is None:
            ap.error(f"--vote-every/--vote-cache need a copy axis; scheme "
                     f"{scheme.name!r} has none")
        if tmr.discipline == "serial":
            ap.error("in-loop voting needs tmr-parallel/tmr-semi")
    if args.vote_cache and not args.vote_every:
        ap.error("--vote-cache needs --vote-every K")
    if args.chunk < 0:
        ap.error(f"--chunk must be >= 0, got {args.chunk}")
    if args.chunk and args.engine == "loop":
        ap.error("--chunk requires --engine scan (the loop reference is "
                 "already per-token)")
    if args.server:
        if args.engine == "loop":
            ap.error("--server runs the scheduler; --engine loop does not "
                     "apply")
        if args.vote_every or args.vote_cache:
            ap.error("--server votes each finished request's tokens from "
                     "the completion fetch; in-loop vote flags do not apply")
        if args.rate <= 0 or args.requests < 1 or args.slots < 1:
            ap.error("--server needs --rate > 0, --requests >= 1 and "
                     "--slots >= 1")
    mesh_shape = None
    if args.mesh:
        try:
            mesh_shape = parse_mesh(args.mesh)
        except ValueError as e:
            ap.error(str(e))
    device = resolve_device(args.device)
    if mesh_shape is None:
        return _run(args, device)
    data, model = mesh_shape
    return spawn(_mesh_rank, data * model, args=(args, data, model),
                 device=device)


def _mesh_rank(device, args, data: int, model: int) -> Dict[str, Any]:
    """One rank of ``--mesh``: the mesh over the world, then the run; the
    rank's summary (host values) goes back to the launcher."""
    return _run(args, device, make_test_mesh(data, model, device=device))


def _run(args, device, mesh=None) -> Dict[str, Any]:
    """One run of the CLI (on one rank of a mesh, or alone); returns its
    summary as host values: tokens, fetched stats, and agreement and
    tok/s (one-shot) or results and goodput (server), the kernel launches
    this process made in the run and its peak device memory."""
    from .. import kernels
    before = kernels.launch_counts()

    def launched():
        return {k: v - before.get(k, 0)
                for k, v in kernels.launch_counts().items()
                if v > before.get(k, 0)}

    scheme = parse_scheme(args.scheme)
    cost_spec = None
    if args.mmpu_cost or args.mmpu_events:
        from ..configs.mmpu_paper import get_device
        cost_spec = get_device(args.mmpu_device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    inputs = make_inputs(cfg, args.batch, args.prompt_len, args.seed, device)
    if args.server:
        spec = BatchSpec(slots=args.slots, page_tokens=args.page_tokens,
                         chunk=args.chunk or 8,
                         prompt_buckets=(args.prompt_len,), gen_cap=args.gen)
        res = serve_server(cfg, inputs["params"], scheme, spec=spec,
                           requests=args.requests, rate=args.rate,
                           p_bit=args.inject_p_bit, fault=args.fault,
                           seed=args.seed, scrub_every=args.scrub_every,
                           adaptive_scrub=args.adaptive_scrub,
                           trace_path=args.trace, metrics_path=args.metrics,
                           device=device, mesh=mesh)
        return {"results": [(r.rid, r.tokens.tolist(), r.vote_disagreements)
                            for r in res["results"]],
                "stats": {k: np.asarray(v).tolist()
                          for k, v in res["stats"].items()},
                "goodput_tok_s": res["goodput_tok_s"],
                "launches": launched(), "peak_bytes": _peak(device)}
    res = serve(cfg, inputs["params"], inputs["tokens"], scheme,
                gen=args.gen, vote_every=args.vote_every,
                vote_cache=args.vote_cache, p_bit=args.inject_p_bit,
                fault=args.fault, seed=args.seed, engine=args.engine,
                chunk=args.chunk, cost_spec=cost_spec,
                mmpu_events=args.mmpu_events, trace_path=args.trace,
                metrics_path=args.metrics, device=device,
                modality=inputs["modality"], mesh=mesh)
    return {"tokens": res["tokens"].cpu().tolist(),
            "stats": {k: np.asarray(v).tolist()
                      for k, v in res["stats"].items()},
            "agreement": res["agreement"], "tok_s": res["tok_s"],
            "launches": launched(), "peak_bytes": _peak(device)}


def _peak(device) -> int:
    """This process's peak device memory (`torch.cuda.max_memory_allocated`;
    0 off the card)."""
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


if __name__ == "__main__":
    main()
