"""recurrentgemma-2b [hybrid] -- RG-LRU + local attention, 1 attn : 2
recurrent [arXiv:2402.19427; hf].

26L d_model=2560 10H (MQA kv=1, head_dim 256) d_ff=7680 (GeGLU),
vocab=256000, lru_width=2560 (16 gate blocks of 160), local window 2048.
Pattern (R, R, A) tiled; remainder RR: 18 RG-LRU and 8 attention layers.
2,673,297,920 parameters: 10.69 GB per fp32 copy.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv=1,
    d_ff=7680,
    vocab=256000,
    act="geglu",
    layer_pattern=("R", "R", "A"),
    local_window=2048,
    lru_width=2560,
    conv_width=4,
    tie_embeddings=True,
)
