from .ops import vote
from .ref import vote_ref

__all__ = ["vote", "vote_ref"]
