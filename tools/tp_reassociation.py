"""How far a serving rank's tensor-parallel MLP and self-attention are
from the same layer on the whole params, on one NVIDIA GPU: phi3-mini's
`smoke()` and one layer at full width, each with the blocked and the
flash attention, in fp32 and bf16, two gloo ranks of one card on a 1x2
mesh (heads and ff split in two), the params drawn from PRNGKey(17) at
the config's init.  Prints, per rank and case, the largest |difference|
of the MLP's output, the attention's output and its k and v (this rank's
KV heads) beside the attention output's largest |value|.

    python3 tools/tp_reassociation.py

At the init's "scaled" rule (normal / sqrt of a stacked leaf's leading
dimension, the layer count) attention amplifies the other rounding of a
column slice's product, so the meshes' logits gates draw weights at std
0.02 (`chip_smoke.TAME_STD`).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

#: (config, overrides, attention implementation)
CASES = (("smoke", {}, "blocked"), ("smoke", {}, "pallas"),
         ("full", {"n_layers": 1}, "blocked"),
         ("full", {"n_layers": 1}, "pallas"))


def rank(dev, dtype):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.launch.engine import GenerationEngine
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.placement import KeyedParams, gathered
    from repro_torch.launch.specs import arch_rules
    from repro_torch.models import attention as A
    from repro_torch.models import nn as N
    from repro_torch.models.transformer import model_specs
    from repro_torch.pshard import use_mesh_and_rules
    mesh = make_test_mesh(1, 2, device=dev)
    rules = arch_rules("phi3-mini-3.8b")
    out = []
    for name, kw, impl in CASES:
        base = get_config("phi3-mini-3.8b")
        cfg = (base.smoke() if name == "smoke" else base).replace(
            compute_dtype=dtype, attention_impl=impl, **kw)
        src = KeyedParams(model_specs(cfg), prng.key(17, dev), "float32",
                          dev)
        whole = src.materialize()
        store, _ = GenerationEngine(cfg, gen=1, mesh=mesh,
                                    rules=rules).prepare(src)
        view = gathered(store)["layers"][0]
        g = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn((2, 64, cfg.d_model), generator=g,
                        device=dev).to(cfg.cdtype)
        k, n = mesh.coords["model"], cfg.n_kv // 2
        res = {}
        with torch.no_grad():
            mw = {q: v[0] for q, v in whole["layers"]["mlp"].items()}
            want = N.mlp_apply(mw, cfg, x)
            with use_mesh_and_rules(mesh, rules):
                got = N.mlp_apply(view["mlp"], cfg, x)
            res["mlp"] = (got.float() - want.float()).abs().max().item()
            aw = {q: v[0] for q, v in whole["layers"]["attn"].items()}
            want, (wk, wv) = A.self_attention(aw, cfg, x)
            with use_mesh_and_rules(mesh, rules):
                got, (gk, gv) = A.self_attention(view["attn"], cfg, x)
            res["attn"] = (got.float() - want.float()).abs().max().item()
            for q, a, b in (("k", gk, wk), ("v", gv, wv)):
                res[q] = (a.float() - b[:, :, k * n:(k + 1) * n].float()
                          ).abs().max().item()
            res["attn largest"] = want.float().abs().max().item()
        out.append((name, impl, res))
        del store, view, whole
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tp_reassociation: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.launch.mesh import spawn
    print(torch.cuda.get_device_name(0), flush=True)
    for dtype in ("float32", "bfloat16"):
        for k, r in enumerate(spawn(rank, 2, args=(dtype,), device="cuda")):
            for name, impl, res in r:
                print(f"rank {k} {name} {impl} {dtype}: " + ", ".join(
                    f"{q} {v:.3g}" for q, v in res.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
