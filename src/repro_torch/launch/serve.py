"""Serving driver: batched generation under a protection scheme (port of
the non-server mode of `repro.launch.serve`).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \\
      --batch 4 --prompt-len 256 --gen 32 --scheme ecc+tmr-parallel \\
      --vote-every 8 --vote-cache --inject-p-bit 1e-9

``--scheme`` takes ``off | ecc | ecc-wb | tmr-serial | tmr-parallel |
tmr-semi | ecc+tmr[-<discipline>]`` (``ecc-wb`` serves as ``ecc`` until
the server, where write-back acts, is ported).  Parameters come from
random init on a seeded generator, directly into the packed arena on the
device; faults are drawn on the device from a generator seeded with
``seed + 100``.  Runs on CUDA by default; ``--device cpu`` runs the plain
PyTorch versions (use it with ``--smoke``).  Scrub and vote counters stay
on the device during the timed generation and are fetched once
afterwards.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from ..configs import get_config, list_archs
from ..device import resolve_device
from ..faults import TransientBitFlips
from ..models import params as P
from ..models import transformer as T
from ..models.config import ModelConfig
from ..reliability import (ArenaEcc, Compose, Scheme, Tmr, Unprotected,
                           parse_scheme, scheme_choices, scheme_help)
from .engine import GenerationEngine, fetch_telemetry

__all__ = ["serve", "make_inputs", "main"]


def _log(msg: str) -> None:
    print(msg, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_inputs(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                device) -> Dict[str, Any]:
    """Random-init parameters (into an arena) and prompt tokens, drawn in
    that order from one generator seeded with `seed` on `device`."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    params = P.materialize(T.model_specs(cfg), g, cfg.param_dtype, device)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g,
                           device=device, dtype=torch.int64).to(torch.int32)
    return {"params": params, "tokens": tokens}


def serve(cfg: ModelConfig, params: Any, tokens: torch.Tensor,
          scheme: Scheme, *, gen: int, vote_every: int = 0,
          vote_cache: bool = False, p_bit: float = 0.0, seed: int = 0,
          engine: str = "scan", device=None) -> Dict[str, Any]:
    """Prepare the scheme's store, run one untimed warmup generation and
    one timed one, fetch the telemetry once, and compare with a clean run.
    Prints the reference's ``[serve]`` lines and returns the results, the
    store included."""
    device = resolve_device(device)
    batch = {"tokens": tokens}
    eng = GenerationEngine(cfg, scheme, gen=gen, vote_every=vote_every,
                           vote_cache=vote_cache, execution=engine,
                           device=device)
    fault = TransientBitFlips(p_bit) if p_bit else None
    fault_gen = torch.Generator(device=device).manual_seed(seed + 100)
    t0 = time.perf_counter()
    store, prep = eng.prepare(params, generator=fault_gen, fault=fault)
    _sync(device)
    prepare_s = time.perf_counter() - t0

    eng.generate(store, batch)          # warmup, untimed
    _sync(device)
    t0 = time.perf_counter()
    out, telem = eng.generate(store, batch)
    _sync(device)
    dt = time.perf_counter() - t0
    stats = fetch_telemetry({**prep, **telem})      # the single fetch

    clean = eng if isinstance(scheme, (Unprotected, ArenaEcc)) \
        else GenerationEngine(cfg, gen=gen, execution=engine, device=device)
    ref = clean.generate(params, batch)[0] if p_bit else out
    agree = float((out == ref).float().mean().item())
    tok_s = tokens.shape[0] * gen / dt
    _log(f"[serve] {cfg.name} scheme={scheme.name} engine={engine} "
        f"device={device.type} p_bit={p_bit:g}: {tokens.shape[0]}x{gen} "
        f"tokens in {dt:.3f}s ({tok_s:.1f} tok/s), prepare {prepare_s:.2f}s, "
        f"agreement with clean run: {agree:.3f}")
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
        _log(f"[serve] reliability (fetched after timing): "
            f"{'; '.join(parts)}")
    _log(f"[serve] cost model ({scheme.name}): "
        f"{scheme.overhead().describe()}")
    sample = out[0, :16].cpu().tolist()
    _log(f"[serve] sample: {sample}")
    return {"tokens": out, "stats": stats, "agreement": agree,
            "tok_s": tok_s, "store": store}


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="phi3-mini-3.8b", choices=list_archs())
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
                    help="flip each weight bit of each copy w.p. p")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
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

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    inputs = make_inputs(cfg, args.batch, args.prompt_len, args.seed, device)
    serve(cfg, inputs["params"], inputs["tokens"], scheme, gen=args.gen,
          vote_every=args.vote_every, vote_cache=args.vote_cache,
          p_bit=args.inject_p_bit, seed=args.seed, engine=args.engine,
          device=device)


if __name__ == "__main__":
    main()
