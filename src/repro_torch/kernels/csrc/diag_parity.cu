// Diagonal-parity encode and fused scrub over the packed weight arena.
//
// Replaces the TPU kernels `encode_parity_kernel` and `scrub_kernel` of
// src/repro/kernels/diag_parity/kernel.py (:48 and :130, bodies `_kernel`
// and `scrub_body`).  The code, the warp-per-block encode and the
// thread-per-block scrub body live in diag_scrub.cuh, which the fused
// inject+scrub (inject_scrub.cu) shares.  The scrub writes in place and
// only where a word changes (the flagged bit of word i0, or a healed
// parity word).
//
// Bound: both passes read every arena word once (scrub also the parity
// table) and write almost nothing, so they are bound by device-memory
// bytes: about 16.7 GB for one fp32 phi3-mini copy, 5 ms at 3.35 TB/s.
#include "diag_scrub.cuh"

using namespace diag;

namespace {

__global__ void __launch_bounds__(WARPS * 32)
    encode_kernel(const uint32_t* __restrict__ words, long long n_blocks,
                  uint32_t* __restrict__ parity, Slopes sl, int F) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * WARPS;
  for (long long base = warp * UNROLL; base < n_blocks;
       base += n_warps * UNROLL) {
    uint32_t w[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long b = base + u;
      w[u] = b < n_blocks ? words[b * BLOCK + lane] : 0u;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long b = base + u;
      if (b >= n_blocks) break;  // warp-uniform
#pragma unroll
      for (int f = 0; f < MAXF; ++f) {
        if (f < F) {
          const uint32_t acc = warp_xor_all(rotl_lane(w[u], sl.s[f], lane));
          if (lane == f) parity[b * F + f] = acc;
        }
      }
    }
  }
}

}  // namespace

extern "C" int diag_parity_encode(const uint32_t* words, long long n_blocks,
                                  uint32_t* parity, const int* slopes, int F,
                                  void* stream) {
  Slopes sl;
  if (!load_slopes(slopes, F, &sl)) return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  encode_kernel<<<grid_for(n_blocks), WARPS * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(words, n_blocks,
                                                       parity, sl, F);
  return (int)cudaGetLastError();
}

extern "C" int diag_parity_scrub(uint32_t* words, long long n_blocks,
                                 const uint32_t* parity, long long n_pblocks,
                                 uint32_t* parity_out, int out_all,
                                 const int* slopes, int F, int ia, int ib,
                                 int* counts, void* stream) {
  return launch_scrub<false>(words, nullptr, n_blocks, parity, n_pblocks,
                             parity_out, out_all, slopes, F, ia, ib, counts,
                             stream);
}
