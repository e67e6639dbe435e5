from .code import CHECK_MASKS, DATA_COLUMNS, N_CHECKS
from .ops import encode_hsiao, scrub, scrub_sharded
from .ref import encode_hsiao_ref, scrub_hsiao_ref

__all__ = ["CHECK_MASKS", "DATA_COLUMNS", "N_CHECKS", "encode_hsiao",
           "encode_hsiao_ref", "scrub", "scrub_hsiao_ref", "scrub_sharded"]
