"""Does training at the reference's init lower the loss in a few steps?

Trains phi3-mini's dense family at a chosen width and depth with
`launch.train`'s defaults (batch 8 x seq 256 of `SyntheticLM(seed=0)`, lr
3e-4, warmup max(steps // 20, 5), fp32 params and compute), from the init
of `models.params.materialize`: its fan-in rule divides a "scaled" leaf by
the square root of its first dimension, which for the stacked layer leaves
is the layer count, not the input width.  Prints each step's loss, the
mean of the last 4 against step 1's, and the step-1 grad norm.

`--package` picks the implementation, one per process: `repro` (the JAX
package) or `repro_torch` (the PyTorch port, on the CPU).  Each draws the
init from its own generator (the same distributions); the batches are the
same bit for bit.  `--init width` divides each stacked leaf by the square
root of its input width instead (the contrast).  `--save-init` writes the
params a run starts from (an npz of the leaves in flatten order) and
`--load-init` starts from such a file instead of drawing, so the two
packages can train from one init.  Runs on the CPU at a narrow width in a
few minutes, e.g.:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/fan_in_descent.py \\
        --package repro --d-model 256 --n-layers 32 --save-init /tmp/i.npz
    PYTHONPATH=src python tools/fan_in_descent.py \\
        --package repro_torch --d-model 256 --n-layers 32 --load-init /tmp/i.npz
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("repro", "repro_torch"),
                    required=True)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--n-layers", type=int, default=32)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=0,
                    help="default: phi3-mini's ratio, 8/3 of d-model")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init", choices=("reference", "width"),
                    default="reference")
    ap.add_argument("--save-init", metavar="NPZ")
    ap.add_argument("--load-init", metavar="NPZ")
    return ap


def _load_init(path):
    with np.load(path) as f:
        return [f[f"arr_{i}"] for i in range(len(f.files))]


def _width_scale(shape, stacked: bool) -> float:
    """Factor taking a stacked leaf from std 1/sqrt(n_layers) to
    1/sqrt(its input width)."""
    return math.sqrt(shape[0] / shape[1]) if stacked else 1.0


def run_repro(args, cfg_kw):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.data.synthetic import SyntheticLM
    from repro.models import params as P
    from repro.models import transformer as T
    from repro.models.steps import init_train_state, make_train_step
    from repro.optim import AdamWConfig

    cfg = get_config("phi3-mini-3.8b").replace(**cfg_kw)
    specs = T.model_specs(cfg)
    params = P.materialize(jax.random.PRNGKey(args.seed), specs)
    if args.init == "width":
        params = jax.tree.map(
            lambda x, s: x * _width_scale(s.shape, s.init == "scaled"
                                          and len(s.shape) > 2),
            params, specs, is_leaf=lambda s: isinstance(s, P.Spec))
    if args.load_init:
        params = jax.tree.unflatten(jax.tree.structure(params), [
            jnp.asarray(x) for x in _load_init(args.load_init)])
    if args.save_init:
        np.savez(args.save_init, *map(np.asarray, jax.tree.leaves(params)))
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 5))
    step = jax.jit(make_train_step(cfg, opt))
    state = init_train_state(params)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       batch_per_rank=args.batch, seed=args.seed)
    for i in range(args.steps):
        state, m = step(state, {"tokens": jnp.asarray(data.batch_at(i))})
        yield float(m["total"]), float(m["grad_norm"])


def run_repro_torch(args, cfg_kw):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.data import SyntheticLM
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T
    from repro_torch.models.steps import init_train_state, make_train_step
    from repro_torch.optim import AdamWConfig

    cfg = get_config("phi3-mini-3.8b").replace(**cfg_kw)
    specs = T.model_specs(cfg)
    params = P.materialize(specs, torch.Generator().manual_seed(args.seed))
    if args.init == "width":
        for x, s in zip(tree.leaves(params), tree.leaves(specs)):
            x.mul_(_width_scale(s.shape, s.init == "scaled"
                                and len(s.shape) > 2))
    if args.load_init:
        for x, a in zip(tree.leaves(params), _load_init(args.load_init)):
            x.copy_(torch.from_numpy(a))
    if args.save_init:
        np.savez(args.save_init, *(x.numpy() for x in tree.leaves(params)))
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 5))
    step = make_train_step(cfg, opt)
    state = init_train_state(params)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       batch_per_rank=args.batch, seed=args.seed)
    for i in range(args.steps):
        state, m = step(state, {"tokens": torch.from_numpy(data.batch_at(i))})
        yield float(m["total"]), float(m["grad_norm"])


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    cfg_kw = dict(d_model=args.d_model, n_layers=args.n_layers,
                  n_heads=args.n_heads, n_kv=args.n_heads,
                  d_ff=args.d_ff or args.d_model * 8 // 3,
                  compute_dtype="float32")
    run = run_repro if args.package == "repro" else run_repro_torch
    t0 = time.perf_counter()
    losses, norms = [], []
    for i, (loss, norm) in enumerate(run(args, cfg_kw)):
        losses.append(loss)
        norms.append(norm)
        print(f"step {i + 1:3d} loss {loss:.6f} grad norm {norm:.6g}",
              flush=True)
    last = float(np.mean(losses[-4:]))
    print(f"{args.package} {cfg_kw} init {args.init}: step 1 loss "
          f"{losses[0]:.6f}, mean of the last 4 {last:.6f} "
          f"({'below' if last < losses[0] else 'not below'} step 1's); "
          f"grad norm {norms[0]:.6g} at step 1, {norms[-1]:.6g} at step "
          f"{len(norms)}; {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
