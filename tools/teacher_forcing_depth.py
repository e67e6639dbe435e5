"""How far two fp32 algorithms of recurrentgemma-2b drift apart with depth
at the reference's fan-in init, on one NVIDIA GPU: for a few (prompt
length, depth) pairs at full width, the teacher-forcing error (32 random
tokens fed back through `decode_step` from the prompt's prefill, against
`forward` over prompt + tokens) under the flash kernel and under the naive
attention, and how far the two attentions' `forward` hidden states lie
apart.  The weights are `chip_smoke`'s phase 12 draw (`make_inputs`, seed
0).  At 3 layers both sides agree to about 1e-3 of the largest logit; at
26 they differ by about half of it either way, inside the window as past
it, which is why phase 12 gates teacher forcing at weights of std 0.02:

    python3 tools/teacher_forcing_depth.py        # from the repo root
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402  (puts src/ on the path)

#: (prompt length, layers): past the 2048 window, inside it, and shallow
RUNS = ((3072, 3), (3072, 26), (2100, 26), (1500, 26))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("teacher_forcing_depth: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_inputs
    from repro_torch.models import transformer as T

    dev = torch.device("cuda")
    card = C.setup_card(torch)
    kernels.build()
    for S, depth in RUNS:
        base = get_config("recurrentgemma-2b").replace(
            n_layers=depth, compute_dtype="float32")
        inputs = make_inputs(base, 1, S, C.SEED, dev)
        batch = {"tokens": inputs["tokens"]}
        toks = torch.randint(0, base.vocab, (1, 32), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(1))
        hidden = {}
        for impl in ("pallas", "naive"):
            cfg = base.replace(attention_impl=impl)
            err, scale, same = C.teacher_forcing_error(
                torch, cfg, inputs["params"], batch, toks.to(torch.int32))
            with torch.no_grad():
                hidden[impl], _ = T.forward(inputs["params"], cfg, batch)
            C.log(f"S={S} layers={depth} {impl}: teacher forcing max abs "
                  f"err {err:.3g} of max |logit| {scale:.4g}, greedy ids "
                  f"equal at {same:.4f}")
        diff = (hidden["pallas"] - hidden["naive"]).abs().max().item()
        C.log(f"S={S} layers={depth}: flash vs naive forward hidden max abs "
              f"diff {diff:.3g} of {hidden['naive'].abs().max().item():.4g} "
              f"on {card}")
        del inputs, hidden
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
