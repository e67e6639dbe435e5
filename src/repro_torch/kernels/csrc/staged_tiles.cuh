// The staged tile walk of the port's thread-per-block block-code kernels:
// the diagonal-parity encode and scrub (diag_scrub.cuh), the fused
// inject+scrub (inject_scrub.cu) and the Hsiao scrub (hsiao_secded.cu).
//
// A block is 32 consecutive 32-bit words.  Each warp walks tiles of 32
// consecutive blocks (4 KB): it stages its next tile into shared memory with
// coalesced 16-byte cp.async (a ring of STAGES tiles per warp, STAGES - 1 in
// flight) while its threads reduce the current one, thread t owning block t
// of the tile.  A thread reads its block out of shared memory with eight
// 16-byte loads, the chunk order rotated by t, so a quarter warp's 8 lanes
// hit 8 distinct 16-byte bank groups.  The block's NP table words (parity or
// check rows, row b mod n_pblocks, so stacked copies of one arena share one
// table) come in as register loads one tile ahead.  Word offsets are 64-bit:
// one phi3-mini arena copy is 3.8e9 words, three stacked copies 1.1e10.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace tiles {

constexpr int BLOCK = 32;                   // words per block == lanes per warp
constexpr int TILE_WORDS = BLOCK * BLOCK;   // a warp's tile: 32 blocks
constexpr int STAGES = 2;                   // a warp's ring of tiles
constexpr int WARPS = 4;                    // warps per CTA

// rotl32(w, r mod 32) for any int r (the funnel shift uses r & 31)
__device__ __forceinline__ uint32_t rotl(uint32_t w, int r) {
  return __funnelshift_l(w, w, r);
}

// rotr32(w, r mod 32) for any int r
__device__ __forceinline__ uint32_t rotr(uint32_t w, int r) {
  return __funnelshift_r(w, w, r);
}

// Copy n_words (a multiple of 4) from device memory into shared memory,
// 16 bytes per cp.async, neighbouring lanes on neighbouring addresses
// (src 16-byte aligned).
__device__ __forceinline__ void stage_words(uint32_t* dst,
                                            const uint32_t* src, int n_words,
                                            int lane) {
  for (int c = lane * 4; c < n_words; c += BLOCK * 4) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src + c)
                 : "memory");
  }
}

// Stage tile t (32 blocks, or the tail) of the words, and with kInject of
// the mask, into one stage of a warp's ring, and commit it as one cp.async
// group (an empty group past the end keeps the group count per pass).
template <bool kInject>
__device__ __forceinline__ void stage_tile(uint32_t* dst, const uint32_t* words,
                                           const uint32_t* mask, long long t,
                                           long long n_blocks, int lane) {
  const long long b0 = t * BLOCK;
  if (b0 < n_blocks) {
    const long long left = n_blocks - b0;
    const int nw = (int)(left < BLOCK ? left : BLOCK) * BLOCK;
    stage_words(dst, words + b0 * BLOCK, nw, lane);
    if constexpr (kInject)
      stage_words(dst + TILE_WORDS, mask + b0 * BLOCK, nw, lane);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The 32 words of this lane's staged block into registers: a[i] =
// w_((i + r) mod 32) with r = 4 * lane mod 32, which is returned.
__device__ __forceinline__ int load_block(const uint32_t* sw, int lane,
                                          uint32_t (&a)[BLOCK]) {
  const uint4* s4 = reinterpret_cast<const uint4*>(sw);
#pragma unroll
  for (int c = 0; c < BLOCK / 4; ++c) {
    const uint4 q = s4[(c + lane) & (BLOCK / 4 - 1)];
    a[4 * c] = q.x;
    a[4 * c + 1] = q.y;
    a[4 * c + 2] = q.z;
    a[4 * c + 3] = q.w;
  }
  return (4 * lane) & (BLOCK - 1);
}

struct NoEpilogue {
  __device__ void operator()(long long, uint32_t*) const {}
};

// Walk this warp's tiles of `words` (and with kInject of `mask`, staged
// beside them): body(b, sw, sm, row) for every block b < n_blocks this
// thread owns, with sw and sm its block's staged words and mask in shared
// memory and row its NP table words (table row b mod n_pblocks; NP = 0
// reads no table); then, in every lane, epilogue(tile, st) with st the
// tile's stage, read out and free until the epilogue's last __syncwarp.
// words and mask are 16-byte aligned; the CTA has WARPS warps and WARPS *
// STAGES * (kInject ? 2 : 1) * TILE_WORDS words of dynamic shared memory at
// smem.
template <bool kInject, int NP, class Body, class Epilogue = NoEpilogue>
__device__ __forceinline__ void walk_tiles(uint32_t* smem,
                                           const uint32_t* words,
                                           const uint32_t* mask,
                                           long long n_blocks,
                                           const uint32_t* table,
                                           long long n_pblocks, Body&& body,
                                           Epilogue&& epilogue = Epilogue{}) {
  constexpr int PLANES = kInject ? 2 : 1;
  constexpr int NR = NP > 0 ? NP : 1;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  uint32_t* ring = smem + wid * STAGES * PLANES * TILE_WORDS;
  const long long n_tiles = (n_blocks + BLOCK - 1) / BLOCK;
  const long long step = (long long)gridDim.x * WARPS;  // tiles per pass
  long long tile = (long long)blockIdx.x * WARPS + wid;
  // this lane's table row, advanced by `delta` rows each pass
  long long pb = 0, delta = 0;
  uint32_t row[NR] = {}, row_next[NR] = {};
  if constexpr (NP > 0) {
    pb = (tile * BLOCK + lane) % n_pblocks;
    delta = (step * BLOCK) % n_pblocks;
    if (tile * BLOCK + lane < n_blocks) {
#pragma unroll
      for (int f = 0; f < NP; ++f) row[f] = table[pb * NP + f];
    }
  }
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k)
    stage_tile<kInject>(ring + k * PLANES * TILE_WORDS, words, mask,
                        tile + k * step, n_blocks, lane);
  int stage = 0;
  for (; tile < n_tiles; tile += step) {
    // refill the stage read in the last pass, and fetch the next rows
    stage_tile<kInject>(
        ring + (stage + STAGES - 1) % STAGES * PLANES * TILE_WORDS, words,
        mask, tile + (STAGES - 1) * step, n_blocks, lane);
    if constexpr (NP > 0) {
      pb += delta;
      if (pb >= n_pblocks) pb -= n_pblocks;
      if ((tile + step) * BLOCK + lane < n_blocks) {
#pragma unroll
        for (int f = 0; f < NP; ++f) row_next[f] = table[pb * NP + f];
      }
    }
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
    __syncwarp();  // every lane's part of this tile has landed

    const long long b = tile * BLOCK + lane;
    uint32_t* st = ring + stage * PLANES * TILE_WORDS;
    if (b < n_blocks) {
      const uint32_t* sw = st + lane * BLOCK;
      body(b, sw, sw + TILE_WORDS, row);
    }
    __syncwarp();  // the stage is read out before the next issue refills it
    epilogue(tile, st);
#pragma unroll
    for (int f = 0; f < NR; ++f) row[f] = row_next[f];
    stage = (stage + 1) % STAGES;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Add each thread's NC counts to counts: reduced over the warp, then over
// the CTA in cta (NC ints of shared memory, zeroed before a __syncthreads
// that precedes the walk), then one integer atomic each -- order-free, so
// the sum is exact.  Every thread of the CTA calls it.
template <int NC>
__device__ __forceinline__ void add_counts(const unsigned (&n)[NC], int* cta,
                                           int* counts) {
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const unsigned s = __reduce_add_sync(0xffffffffu, n[k]);
    if ((threadIdx.x & 31) == 0 && s) atomicAdd(&cta[k], (int)s);
  }
  __syncthreads();
  if (threadIdx.x < NC && cta[threadIdx.x])
    atomicAdd(&counts[threadIdx.x], cta[threadIdx.x]);
}

// Launch a tile-walking kernel over n_blocks with smem bytes of dynamic
// shared memory: one warp per tile, up to as many CTAs as fit on the card
// at once (each warp then walks several tiles).
template <class... KArgs, class... Args>
int launch(void (*kernel)(KArgs...), int smem, long long n_blocks,
           cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    WARPS * 32, smem);
  if (e != cudaSuccess) return (int)e;
  const long long n_tiles = (n_blocks + BLOCK - 1) / BLOCK;
  const long long need = (n_tiles + WARPS - 1) / WARPS;
  const long long cap =
      (long long)repro_sm_count() * (per_sm > 0 ? per_sm : 1);
  kernel<<<(int)(need < cap ? need : cap), WARPS * 32, smem, stream>>>(
      args...);
  return (int)cudaGetLastError();
}

// fn(std::integral_constant<int, F>) for the run-time count n in [lo, hi],
// so a kernel templated on F issues no predicated-off work.
template <int lo, int hi, class Fn>
int with_count(int n, Fn&& fn) {
  if (n == lo) return fn(std::integral_constant<int, lo>{});
  if constexpr (lo < hi) return with_count<lo + 1, hi>(n, fn);
  return (int)cudaErrorInvalidValue;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace tiles
