"""Model configuration (port of `repro.models.config`; same fields, so a
configuration carries across packages unchanged).  The dense and MoE
families have a model in the port so far."""
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
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests (the reference's
        sizes for the dense and MoE families)."""
        if self.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"the port has no {self.family!r} family yet")
        kw = dict(
            n_layers=min(self.n_layers, 4), d_model=128, n_heads=4,
            n_kv=min(max(self.n_kv * 4 // max(self.n_heads, 1), 1), 4),
            d_ff=256, vocab=512, q_block=16, kv_block=16)
        if self.family == "moe":
            kw.update(moe_experts=4, moe_topk=min(self.moe_topk, 2),
                      moe_dff=128)
        return self.replace(**kw)
