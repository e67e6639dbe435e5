"""Run one later phase of `chip_smoke.py` alone on one NVIDIA GPU: the
whole script's card setup and kernel build, then that phase's runner,
whose gates raise on a failure.  A quicker check than the whole script
after a change to one phase's code:

    python3 tools/chip_phase.py 10    # training (run_train_path)
    python3 tools/chip_phase.py 11    # the dense zoo and MoE (run_zoo_path)
    python3 tools/chip_phase.py 12    # the SSM, hybrid, VLM and enc-dec
                                      # families (run_family_path)
    python3 tools/chip_phase.py 13    # the serving mesh (run_mesh_path)
    python3 tools/chip_phase.py 13cd  # its one-shot meshes, server and
                                      # guard alone (run_mesh_one_shot)
    python3 tools/chip_phase.py 14    # the training step on a mesh
                                      # (run_train_mesh_path)
    python3 tools/chip_phase.py 14d   # its four-card 2x2 world over nccl
                                      # (run_train_mesh_four; needs four
                                      # cards on one host; phase 15 (e))
    python3 tools/chip_phase.py 15    # the dry run against the card's
                                      # steps (run_dryrun_path: phase 15
                                      # (a)-(b); (c) runs inside 14, (d)
                                      # inside 13)
    python3 tools/chip_phase.py 16    # the keyed draws against the CPU
                                      # and jax's digests (run_prng_path)
    python3 tools/chip_phase.py 17    # experts where they live, stores
                                      # from block ranges: phi3.5-moe on
                                      # 4x1 gloo ranks of one card
                                      # (run_expert_mesh_path)
    python3 tools/chip_phase.py 17b   # llama4-maverick at full width on
                                      # 4x1 over nccl (run_expert_mesh_four;
                                      # needs four cards on one host)
    python3 tools/chip_phase.py 18    # heads, ff and vocab where they
                                      # live: phi3-mini on 1x2 and 2x2,
                                      # phi3.5-moe on 2x2, gloo ranks of
                                      # one card (run_tensor_mesh_path)
    python3 tools/chip_phase.py 18b   # llama4-maverick at full width on
                                      # 2x2 and phi3-mini at full depth on
                                      # 1x4 over nccl (run_tensor_mesh_four;
                                      # needs four cards on one host)
    python3 tools/chip_phase.py 18b --arch llama4-maverick-400b-a17b
                                      # one of 18b's two worlds

from the repo root.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402  (puts src/ on the path)

#: phase -> its runner, each called as runner(torch, card, device)
PHASES = {"10": C.run_train_path, "11": C.run_zoo_path,
          "12": C.run_family_path, "13": C.run_mesh_path,
          "13cd": C.run_mesh_one_shot, "14": C.run_train_mesh_path,
          "14d": C.run_train_mesh_four, "15": C.run_dryrun_path,
          "16": C.run_prng_path, "17": C.run_expert_mesh_path,
          "17b": C.run_expert_mesh_four, "18": C.run_tensor_mesh_path,
          "18b": C.run_tensor_mesh_four}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phase", choices=sorted(PHASES))
    ap.add_argument("--arch", choices=[c[0] for c in C.P18B],
                    help="18b: run this arch's world alone")
    args = ap.parse_args(argv)
    if args.arch:
        C.P18B = tuple(c for c in C.P18B if c[0] == args.arch)
    import torch
    if not torch.cuda.is_available():
        print("chip_phase: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import kernels
    t0 = time.perf_counter()
    card = C.setup_card(torch)
    C.log(f"kernels built in {kernels.build():.1f}s")
    C.log(f"phase {args.phase} alone: launches "
          f"{PHASES[args.phase](torch, card, torch.device('cuda'))}")
    C.log(f"phase {args.phase} alone: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
