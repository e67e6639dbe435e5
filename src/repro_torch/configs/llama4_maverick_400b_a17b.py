"""llama4-maverick-400b-a17b [moe] -- MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts
top-1 routing + a shared expert, MoE on every second layer (interleaved,
the Llama-4 design -- 24 x 128 x 126M expert params ~ 386B + dense ~ 400B
total, 17B active).  One MoE layer is 16.1e9 parameters (64.4 GB at
fp32): the full config needs the mesh or a bf16 store.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    d_ff=8192,
    vocab=202048,
    act="swiglu",
    moe_experts=128,
    moe_topk=1,
    moe_every=2,
    moe_dff=8192,
    moe_shared_expert=True,
    tie_embeddings=False,
)

# 400B params cannot hold fp32 Adam state: train with bf16 parameters,
# bf16 moments and a bf16 gradient accumulator.
TRAIN_POLICY = {"microbatches": 16, "param_dtype": "bfloat16",
                "opt_dtype": "bfloat16", "grad_dtype": "bfloat16"}

# Serving layout: stationary expert weights -- experts sharded over the
# data axis, the expert FFN over model, d_model replicated.
SERVE_RULES_OVERRIDES = {"model_dim": (), "expert": ("data",),
                         "ff": ("model",)}
