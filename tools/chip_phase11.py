"""Run phase 11 of `chip_smoke.py` (the dense zoo and the MoE family) alone
on one NVIDIA GPU: the whole script's card setup and kernel build, then its
`run_zoo_path`, whose gates raise on a failure.  A quicker check than the
whole script (phases 1-11) after a change to phase 11's code:

    python3 tools/chip_phase11.py        # from the repo root
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402  (puts src/ on the path)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_phase11: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import kernels
    t0 = time.perf_counter()
    card = C.setup_card(torch)
    C.log(f"kernels built in {kernels.build():.1f}s")
    C.run_zoo_path(torch, card, torch.device("cuda"))
    C.log(f"phase 11 alone: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
