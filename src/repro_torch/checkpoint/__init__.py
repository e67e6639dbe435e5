"""Checkpointing of the port (port of `repro.checkpoint`: atomic, async,
windowed snapshots; the elastic `restore_resharded` waits for the mesh)."""
from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
