from .ops import encode_parity, scrub, scrub_sharded
from .ref import encode_parity_ref, scrub_ref

__all__ = ["encode_parity", "encode_parity_ref", "scrub", "scrub_ref",
           "scrub_sharded"]
