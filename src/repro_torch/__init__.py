"""PyTorch/CUDA port of the memristive-PIM reliability system.

The JAX package `repro` is the reference; this package is its port to
PyTorch with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).  It
imports `torch` and numpy only.  Layout mirrors the reference:

  core/         arena packing, word-level diagonal-parity code, TMR voters
  faults/       fault models (in-place corruption with torch.Generator)
  reliability/  backend registry and the composable Scheme protocol
  kernels/      <name>/{kernel,ops,ref}.py, CUDA sources under csrc/
  models/       dense transformer (prefill + decode)
  configs/      architecture registry
  launch/       GenerationEngine and the serve driver

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
