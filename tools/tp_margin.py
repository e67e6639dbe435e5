"""How near phase 18 (a)'s logits gate comes to its bound from one key to
another, on one NVIDIA GPU: each world of CASES (an arch, its layers, a
mesh and the rules beyond the arch's, as `chip_smoke.P18A` has them) at
each seed, `off` only, fp32 compute, weights at `chip_smoke.TAME_STD`,
gloo ranks sharing the card, against one process serving each data
group's rows from the same key (`chip_smoke.p18_alone`).  Prints each
world's largest |meshed - one process| first-step logits beside the
gate's bound (`chip_smoke.P18_REL` of the largest |logit|) and their
ratio.

    python3 tools/tp_margin.py [--seeds 17 18 19 20] [--layers 3]

from the repo root.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402  (puts src/ on the path)

#: (arch, mesh, rules beyond the arch's)
CASES = (("phi3.5-moe-42b-a6.6b", (2, 2),
          {"expert": ("data",), "ff": ("model",), "model_dim": ()}),
         ("phi3-mini-3.8b", (2, 2), {}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[18, 19, 20])
    ap.add_argument("--layers", type=int, nargs="+", default=[3, 4],
                    help="each CASES arch's depth, in order")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("tp_margin: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import kernels
    from repro_torch.launch.specs import arch_rules
    card = C.setup_card(torch)
    C.log(f"kernels built in {kernels.build():.1f}s")
    dev = torch.device("cuda")
    for (arch, shape, extra), depth in zip(CASES, args.layers):
        cfg = C.p18_config(arch, depth, "float32")
        rules = arch_rules(arch, extra=extra)
        for seed in args.seeds:
            t0 = time.perf_counter()
            ranks, _ = C.p18_world(torch, dev, cfg, rules, ("off",), shape,
                                   C.P18A_GEN, False, True, tame=True,
                                   seed=seed)
            alone = C.p18_alone(torch, cfg, rules, ("off",), shape,
                                C.P18A_GEN, dev, seed=seed)["off"]
            tol = C.P18_REL * float(np.abs(alone["logits"]).max())
            errs = [float(np.abs(r["off"]["logits"] - alone["logits"]).max())
                    for r in ranks]
            same = all(np.array_equal(r["off"]["tokens"], alone["tokens"])
                       for r in ranks)
            C.log(f"tp_margin {arch} {depth} layers {shape[0]}x{shape[1]} "
                  f"seed {seed}: logits max abs err {max(errs):.4g} of a "
                  f"bound {tol:.4g} ({max(errs) / tol:.3f} of it), tokens "
                  f"equal one process's: {same}; "
                  f"{time.perf_counter() - t0:.1f} s ({card})")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
