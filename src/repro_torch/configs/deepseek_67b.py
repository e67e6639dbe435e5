"""deepseek-67b [dense] -- llama-arch [arXiv:2401.02954; hf].

95L d_model=8192 64H (GQA kv=8, head_dim 128) d_ff=22016 vocab=102400.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=22016,
    vocab=102400,
    act="swiglu",
    rope_theta=10000.0,
    tie_embeddings=False,
)
