"""mamba2-130m [ssm] -- SSD state-space duality [arXiv:2405.21060].

24L d_model=768 (attention-free) vocab=50280 (padded to 50304),
ssm_state=128, headdim 64, expand 2 (d_inner 1536, 24 SSD heads), SSD
chunk 256.  129,001,920 parameters: 0.52 GB per fp32 copy.  The
reference's default training arch.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=1,      # attention-free; SSD heads derived from d_inner/headdim
    n_kv=1,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_width=4,
    tie_embeddings=True,
)

# 130M params: every weight fits replicated.  The default TP/FSDP rules
# only reshard here (the fused in_proj width does not divide the model
# axis while the conv dim does), so: pure data parallelism, the moments
# sharded over data by ZeRO-1.
RULES_OVERRIDES = {"ff": (), "model_dim": ()}
