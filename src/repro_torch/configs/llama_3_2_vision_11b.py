"""llama-3.2-vision-11b [vlm] -- cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; one gated
cross-attention layer per 5 layers (8 blocks).  The vision tower is a
stub: `launch/serve` and `launch/train` draw the patch embeddings
(B, 1600, 4096).  9,775,157,264 parameters: 39.10 GB per fp32 copy.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=128256,
    act="swiglu",
    rope_theta=500000.0,
    cross_attn_every=5,
    vis_tokens=1600,
    vis_dim=4096,
    tie_embeddings=False,
)
