// Diagonal-parity encode and fused scrub over the packed weight arena.
//
// Replaces the TPU kernels `encode_parity_kernel` and `scrub_kernel` of
// src/repro/kernels/diag_parity/kernel.py (:48 and :130, bodies `_kernel`
// and `scrub_body`).  Both walk staged 32-block tiles as a thread per block
// and build the parity words with one Horner body (`block_parity` in
// diag_scrub.cuh, which the fused inject+scrub of inject_scrub.cu shares);
// the encode is the scrub without the classification.  The scrub writes in
// place and only where a word changes (the flagged bit of word i0, or a
// healed parity word).
//
// Bound: both passes read every arena word once (scrub also the parity
// table) and write little (encode 3/32 of the words), so they are bound by
// device-memory bytes: about 16.7 GB for one fp32 phi3-mini copy, 5 ms at
// 3.35 TB/s.  The warp-per-block encode this replaces spent 15 shuffles
// and 6 modulos per word (F = 3) and ran at 3x its byte bound.  As built
// for sm_90a (python -m repro_torch.kernels.sass_report), the encode's
// main loop for F = 3, one block per thread per pass, is 432 instructions
// (13.5 a word): 100 SHF and 114 LOP3 (the F funnel shifts and XORs a
// word), 8 LDS.128, 3 STG.32, no SHFL; 36 registers, no spills.  The old
// loop (4 words a lane, all 8 families issued predicated) held 160 SHFL in
// 1096 instructions.
#include "diag_scrub.cuh"

using namespace diag;

namespace {

// parity: (n_blocks, F), row b written by the thread that owns block b.
template <int F>
__global__ void __launch_bounds__(WARPS * 32)
    encode_kernel(const uint32_t* __restrict__ words, long long n_blocks,
                  uint32_t* __restrict__ parity, Slopes sl) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31;
  walk_tiles<false, 0>(
      smem, words, nullptr, n_blocks, nullptr, 1,
      [&](long long b, const uint32_t* sw, const uint32_t*,
          const uint32_t(&)[1]) {
        uint32_t a[BLOCK], p[F];
        const int r = load_block(sw, lane, a);
        block_parity<F>(a, r, sl, p);
#pragma unroll
        for (int f = 0; f < F; ++f) parity[b * F + f] = p[f];
      });
}

}  // namespace

extern "C" int diag_parity_encode(const uint32_t* words, long long n_blocks,
                                  uint32_t* parity, const int* slopes, int F,
                                  void* stream) {
  Slopes sl;
  if (!load_slopes(slopes, F, &sl) || !aligned16(words))
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  return with_count<1, MAXF>(F, [&](auto f) {
    return launch(encode_kernel<decltype(f)::value>,
                  WARPS * STAGES * TILE_WORDS * 4, n_blocks,
                  static_cast<cudaStream_t>(stream), words, n_blocks, parity,
                  sl);
  });
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
