"""Runtime controllers of the port (port of `repro.runtime`: the adaptive
scrub controller; the training loop and its monitor are not ported yet)."""
from .adaptive import AdaptiveScrub, AdaptiveScrubConfig

__all__ = ["AdaptiveScrub", "AdaptiveScrubConfig"]
