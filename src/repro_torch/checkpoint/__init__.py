"""Checkpointing of the port (port of `repro.checkpoint`: atomic, async,
windowed snapshots, and `restore_resharded`, the elastic restore onto any
mesh shape)."""
from .checkpointer import Checkpointer, restore_resharded

__all__ = ["Checkpointer", "restore_resharded"]
