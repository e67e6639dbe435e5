from .ops import inject_scrub
from .ref import inject_scrub_ref

__all__ = ["inject_scrub", "inject_scrub_ref"]
