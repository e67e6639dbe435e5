"""phi3.5-moe-42b-a6.6b [moe] -- 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8, head_dim 128) d_ff=6400 vocab=32064,
MoE 16e top-2.  One layer is 1.300e9 parameters (5.20 GB at fp32).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=6400,
    vocab=32064,
    act="swiglu",
    moe_experts=16,
    moe_topk=2,
    moe_dff=6400,
    moe_shared_expert=False,
    tie_embeddings=False,
)
