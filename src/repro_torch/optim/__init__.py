"""Optimizer of the port (port of `repro.optim`: AdamW and the int8
error-feedback compression, and the derived sharding rules: ZeRO-1 moment
specs and the parity / TMR-copy placement)."""
from .adamw import (AdamWConfig, adamw_update, global_norm, init_opt_state,
                    warmup_cosine)
from .compression import compress_decompress, init_error_state
from .sharding_rules import copy_stack_pspec, opt_spec_tree, parity_pspec

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "warmup_cosine",
           "global_norm", "compress_decompress", "init_error_state",
           "opt_spec_tree", "parity_pspec", "copy_stack_pspec"]
