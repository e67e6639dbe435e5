"""Plain version: the per-bit voter of core.tmr."""
from ...core.tmr import vote_array as vote_ref  # noqa: F401
