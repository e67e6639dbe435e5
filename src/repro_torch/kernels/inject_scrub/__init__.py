from .ops import inject_scrub, inject_scrub_sharded
from .ref import inject_scrub_ref

__all__ = ["inject_scrub", "inject_scrub_ref", "inject_scrub_sharded"]
