"""Training driver (port of `repro.launch.train`): composes the config,
the synthetic data, AdamW, checkpointing, the heartbeat monitor and the
reliability layer into a `TrainLoop`, on CUDA unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
      --steps 20 --ecc-scrub-every 5 --inject-p-bit 1e-6

Every arch of the registry trains; the default is the reference's,
mamba2-130m.  The vlm and encdec families get their stub modality input
(vis_emb (batch, vis_tokens, vis_dim), enc_emb (batch, seq, d_model),
standard normal) drawn anew each step from a generator seeded with
``derive_seed(seed, step)``, the counterpart of the reference's
``fold_in(key, step)``.  `build(..., key=prng.key(seed))` makes the
reference's draws instead: the params from that key, the modality inputs
under ``fold_in(key, step)`` and the loop's faults from its keys
(`LoopConfig.inject_keyed`).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..checkpoint import Checkpointer
from ..configs import get_config, list_archs
from ..core import prng
from ..core.seeds import derive_seed
from ..data.synthetic import SyntheticLM
from ..device import resolve_device
from ..models import params as P
from ..models import transformer as TR
from ..models.config import ModelConfig
from ..models.steps import init_train_state, make_train_step
from ..obs import NULL_TRACER, Tracer
from ..optim import AdamWConfig
from ..reliability import Unprotected, parse_scheme, scheme_choices
from ..runtime import LoopConfig, TrainLoop

__all__ = ["build", "main"]


def build(args, tracer: Tracer = NULL_TRACER,
          cfg: Optional[ModelConfig] = None,
          key: Optional[torch.Tensor] = None):
    """(cfg, loop, n_params) for parsed CLI args.  `cfg` replaces the
    `--arch` / `--smoke` config (e.g. one cut in depth); the compute dtype
    is still `--compute-dtype`.  A `core.prng` key draws as the reference's
    `build` does from ``PRNGKey(seed)`` (module doc)."""
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = cfg.smoke()
    cfg = cfg.replace(compute_dtype=args.compute_dtype)

    if key is not None:
        key = key.to(device)
    g = key if key is not None else \
        torch.Generator(device=device).manual_seed(args.seed)
    params = P.materialize(TR.model_specs(cfg), g, args.param_dtype, device)
    n_params = P.count_params(TR.model_specs(cfg))

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 5))
    train_step = make_train_step(cfg, opt_cfg,
                                 grad_compression=args.grad_compression,
                                 microbatches=args.microbatches)
    state = init_train_state(params, grad_compression=args.grad_compression)
    del params

    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       batch_per_rank=args.batch, seed=args.seed)

    def batch_at(step):
        b = {"tokens": torch.from_numpy(data.batch_at(step)).to(device)}
        shape = {"vlm": ("vis_emb", (args.batch, cfg.vis_tokens,
                                     cfg.vis_dim)),
                 "encdec": ("enc_emb", (args.batch, args.seq, cfg.d_model)),
                 }.get(cfg.family)
        if shape is not None and key is not None:
            b[shape[0]] = prng.normal(prng.fold_in(key, step), shape[1])
        elif shape is not None:
            g = torch.Generator(device=device).manual_seed(
                derive_seed(args.seed, step))
            b[shape[0]] = torch.randn(shape[1], generator=g, device=device)
        return b

    ckpt = Checkpointer(args.ckpt_dir, keep=2) if args.ckpt_dir else None
    loop_cfg = LoopConfig(total_steps=args.steps,
                          checkpoint_every=args.checkpoint_every,
                          scrub_every=args.ecc_scrub_every,
                          log_every=args.log_every,
                          inject_p_bit=args.inject_p_bit,
                          inject_keyed=key is not None,
                          scheme=parse_scheme(args.scheme))
    loop = TrainLoop(train_step, state, batch_at, loop_cfg, ckpt=ckpt,
                     tracer=tracer)
    if args.ecc_scrub_every and not isinstance(loop_cfg.scheme, Unprotected):
        loop.attach_scheme()
    return cfg, loop, n_params


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="mamba2-130m", choices=list_archs(),
                    help="any arch of the registry (default: the "
                         "reference's, mamba2-130m)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--param-dtype", default="float32")
    ap.add_argument("--compute-dtype", default="float32")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--ecc-scrub-every", type=int, default=0)
    ap.add_argument("--scheme", default="ecc",
                    help="protection scheme armed when --ecc-scrub-every > 0 "
                         "(parse_scheme grammar, e.g. "
                         + " | ".join(scheme_choices())
                         + " | ecc+tmr-semi)")
    ap.add_argument("--inject-p-bit", type=float, default=0.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write loop spans (train_step/scrub/checkpoint/"
                         "eval) as Chrome-trace JSON")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="append heartbeat/scrub records as JSONL")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv: Optional[list] = None) -> dict:
    args = parser().parse_args(argv)
    tracer = Tracer(enabled=bool(args.trace or args.metrics))
    cfg, loop, n_params = build(args, tracer=tracer)
    print(f"[train] {cfg.name} ({cfg.family}) params={n_params/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq} "
          f"device={resolve_device(args.device)}")
    if args.resume:
        loop.restore()
    t0 = time.time()
    summary = loop.run()
    dt = time.time() - t0
    tok_s = args.steps * args.batch * args.seq / dt
    print(f"[train] done: {summary} | {dt:.1f}s, {tok_s:,.0f} tok/s")
    if loop.scrub_reports:
        tot = sum(int(r.corrected) for _, r in loop.scrub_reports)
        print(f"[reliability] scrubs={len(loop.scrub_reports)} "
              f"corrected_bits={tot}")
    if args.trace:
        tracer.write_chrome(args.trace)
        print(f"[train] chrome trace -> {args.trace} "
              f"(load in Perfetto / chrome://tracing)")
    if args.metrics:
        tracer.metrics({"final_step": summary["final_step"],
                        "tok_s": tok_s, **summary["monitor"]},
                       kind="train_summary")
        tracer.write_jsonl(args.metrics)
        print(f"[train] metrics jsonl -> {args.metrics}")
    return summary


if __name__ == "__main__":
    main()
