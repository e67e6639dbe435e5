"""How often torch's float32 square root misses the correctly rounded one,
on the CPU and, when there is one, on the CUDA card:

    python3 tools/sqrt_rounding.py [--n 1048576] [--seed 0]

The exact float32 root of a float32 x is sqrt(x) in float64 rounded once
to float32 (a double holds more than twice float32's precision, so the two
roundings agree).  `repro_torch.core.prng.normal` takes its root that way,
on every device; this tool shows why.  Inputs are uniform in [0.1, 4.1)
and in [5, 17), the range of ``-log1p(-u*u)`` where the erfinv polynomial
takes its root.  Prints one line a device and range: the share of values
that differ and the largest gap in float32 ulp.
"""
from __future__ import annotations

import argparse
import subprocess

import torch


def miss(x: torch.Tensor):
    """(share of x whose float32 sqrt is not the exact root, max ulp)."""
    got = torch.sqrt(x).view(torch.int32).to(torch.int64)
    want = torch.sqrt(x.double()).float().view(torch.int32).to(torch.int64)
    gap = (got - want).abs()
    return float((gap > 0).double().mean()), int(gap.max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    g = torch.Generator().manual_seed(args.seed)
    ranges = ((0.1, 4.1), (5.0, 17.0))
    devices = ["cpu"]
    if torch.cuda.is_available():
        devices.append("cuda")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
    print(f"torch {torch.__version__}, {torch.get_num_threads()} threads")
    for lo, hi in ranges:
        x = torch.rand(args.n, generator=g) * (hi - lo) + lo
        for dev in devices:
            share, ulp = miss(x.to(dev))
            print(f"sqrt float32 on {dev}, x in [{lo}, {hi}), n {args.n}: "
                  f"{share:.4%} not correctly rounded, max {ulp} ulp")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
