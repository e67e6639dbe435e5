"""PyTorch/CUDA port of the memristive-PIM reliability system.

The JAX package `repro` is the reference; this package is its port to
PyTorch with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).  It
imports `torch` and numpy only.  Layout mirrors the reference:

  core/         arena packing, word-level diagonal-parity code, TMR voters
  faults/       fault models (in-place corruption with torch.Generator)
  reliability/  backend registry and the composable Scheme protocol
                (diagonal parity, Hsiao SEC-DED, TMR, their compositions)
  kernels/      <name>/{kernel,ops,ref}.py, CUDA sources under csrc/
  models/       dense transformer (prefill + decode, per-row positions)
  configs/      architecture registry
  obs/          metrics registry, latency tails, tracer
  launch/       GenerationEngine, the continuous-batching server over a
                paged ECC-protected KV pool, and the serve driver

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
