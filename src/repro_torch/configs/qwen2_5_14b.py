"""qwen2.5-14b [dense] -- GQA with QKV bias [hf:Qwen/Qwen2.5].

48L d_model=5120 40H (GQA kv=8, head_dim 128) d_ff=13824 vocab=152064.
14,770,033,664 parameters: 59.08 GB per fp32 copy.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    d_ff=13824,
    vocab=152064,
    act="swiglu",
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=False,
)
