"""Model configuration (port of `repro.models.config`; same fields, so a
configuration carries across packages unchanged).  Every family of the
reference has a model in the port: dense, moe, ssm, hybrid, vlm and
encdec."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int

    act: str = "swiglu"         # swiglu | geglu | relu2 | gelu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = True

    # --- MoE ---
    moe_experts: int = 0
    moe_topk: int = 0
    moe_every: int = 1
    moe_dff: int = 0
    moe_shared_expert: bool = False
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4

    # --- hybrid (RecurrentGemma) ---
    layer_pattern: Tuple[str, ...] = ()
    local_window: int = 0
    lru_width: int = 0
    lru_blocks: int = 16

    # --- VLM ---
    cross_attn_every: int = 0
    vis_tokens: int = 0
    vis_dim: int = 0

    # --- encoder-decoder ---
    enc_layers: int = 0
    audio_frontend: bool = False

    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # --- attention blocking ---
    q_block: int = 512
    kv_block: int = 1024
    #: blocked | naive | pallas ("pallas" keeps the reference's name and
    #: runs the hand-written CUDA flash kernel on the card)
    attention_impl: str = "blocked"

    pad_vocab_to: int = 128

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // self.pad_vocab_to) * self.pad_vocab_to

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:         # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests (the reference's
        sizes)."""
        kw = dict(
            n_layers=min(self.n_layers, 4), d_model=128, n_heads=4,
            n_kv=min(max(self.n_kv * 4 // max(self.n_heads, 1), 1), 4),
            d_ff=256, vocab=512, q_block=16, kv_block=16)
        if self.family == "moe":
            kw.update(moe_experts=4, moe_topk=min(self.moe_topk, 2),
                      moe_dff=128)
        if self.family == "ssm":
            kw.update(ssm_state=16, ssm_headdim=32, ssm_chunk=16, d_model=64,
                      n_heads=1, n_kv=1, d_ff=0)
        if self.family == "hybrid":
            kw.update(layer_pattern=self.layer_pattern, local_window=32,
                      lru_width=128, n_layers=5, n_kv=1, ssm_chunk=16)
        if self.family == "vlm":
            kw.update(cross_attn_every=self.cross_attn_every, vis_tokens=16,
                      vis_dim=128,
                      n_layers=min(self.n_layers, self.cross_attn_every * 2))
        if self.family == "encdec":
            kw.update(enc_layers=2, n_layers=2)
        return self.replace(**kw)
