"""seamless-m4t-medium [audio] -- encoder-decoder, multimodal
[arXiv:2308.11596; hf].

12L encoder + 12L decoder, d_model=1024 16H (kv=16 == MHA, head_dim 64)
d_ff=4096, vocab=256206 (padded to 256256).  The audio frontend (fbank ->
conformer features) is a stub: `launch/serve` and `launch/train` draw the
frame embeddings (B, T_frames, 1024).  878,245,900 parameters: 3.51 GB
per fp32 copy.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,       # decoder layers
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_ff=4096,
    vocab=256206,
    act="gelu",
    audio_frontend=True,
    tie_embeddings=False,
)

# 16 kv heads divide the model axis: prefer head-sharded decode caches.
RULES_OVERRIDES = {"kv_seq": (), "kv_heads": ("model",)}
