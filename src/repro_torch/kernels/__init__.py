"""Hand-written Hopper kernels of the port.

Each kernel package has
  kernel.py -- the ctypes binding of the CUDA launch function
               (sources under csrc/, built by _build.py for sm_90a);
  ops.py    -- the public wrapper: checks device, dtype, shape and
               contiguity, launches on the current stream, checks the
               launch error and counts the launch; a CPU tensor takes the
               plain version, a CUDA tensor launches the kernel or raises;
  ref.py    -- the plain PyTorch version of the same function.

Kernels (TPU kernel each replaces, in the JAX package):
  diag_parity     -- encode + fused scrub (kernels/diag_parity/kernel.py)
  inject_scrub    -- fault mask XOR + the same scrub in one pass
                     (kernels/inject_scrub/kernel.py)
  hsiao_secded    -- (39,32) SEC-DED encode + fused per-word scrub
                     (kernels/hsiao_secded/kernel.py)
  tmr_vote        -- per-bit 2-of-3 majority (kernels/tmr_vote/kernel.py)
  flash_attention -- online-softmax prefill attention
                     (kernels/flash_attention/kernel.py)
  netlist_exec    -- levelized Minority3 netlist over trial-packed words,
                     optional fault masks (kernels/netlist_exec/kernel.py)
  crossbar_nor    -- any Minority3 gate list in list order over
                     trial-packed words, run level by level
                     (kernels/crossbar_nor/kernel.py)
"""
from ._build import build, launch_counts, launch_shapes, reset_launch_counts

__all__ = ["build", "launch_counts", "launch_shapes", "reset_launch_counts"]
