"""Optimizer of the port (port of `repro.optim`: AdamW and the int8
error-feedback compression; the ZeRO-1 sharding rules wait for the mesh)."""
from .adamw import (AdamWConfig, adamw_update, global_norm, init_opt_state,
                    warmup_cosine)
from .compression import compress_decompress, init_error_state

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "warmup_cosine",
           "global_norm", "compress_decompress", "init_error_state"]
