// Fused fault injection + diagonal-parity scrub over a packed arena.
//
// Replaces the TPU kernel `inject_scrub_kernel` of
// src/repro/kernels/inject_scrub/kernel.py (:49, body
// `_inject_scrub_kernel`): XOR a fault mask into the words, then the
// diagonal-parity scrub, in one pass.  The scrub body is diag_scrub.cuh's,
// the one csrc/diag_parity.cu runs, with the mask folded in front of the
// XOR trees, so the corrupted words exist only in registers.  A word is
// written where the mask and the correction do not cancel; counts gain a
// first entry, `injected`, the popcount of the mask.
//
// Bound: device-memory bytes.  Every word and mask word is read once, the
// parity table once, and the mask's surviving flips written: for one copy
// of the full-width phi3-mini server pool (1.21e8 words) about 1.01 GB,
// 0.30 ms at 3.35 TB/s.
#include "diag_scrub.cuh"

extern "C" int inject_scrub(uint32_t* words, const uint32_t* mask,
                            long long n_blocks, const uint32_t* parity,
                            long long n_pblocks, uint32_t* parity_out,
                            int out_all, const int* slopes, int F, int ia,
                            int ib, int* counts, void* stream) {
  return diag::launch_scrub<true>(words, mask, n_blocks, parity, n_pblocks,
                                  parity_out, out_all, slopes, F, ia, ib,
                                  counts, stream);
}
