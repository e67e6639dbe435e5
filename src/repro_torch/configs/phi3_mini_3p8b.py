"""phi3-mini-3.8b [dense] -- RoPE SwiGLU MHA [arXiv:2404.14219].

32L d_model=3072 32H (kv=32 == MHA, head_dim 96) d_ff=8192 vocab=32064
(padded to 32128).  3,821,472,768 parameters: 15.29 GB per fp32 copy.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv=32,
    d_ff=8192,
    vocab=32064,
    act="swiglu",
    tie_embeddings=False,
)

# 32 kv heads divide the model axis: prefer head-sharded decode caches.
RULES_OVERRIDES = {"kv_seq": (), "kv_heads": ("model",)}
