// The diagonal-parity block code on the card, shared by the encode and
// scrub of csrc/diag_parity.cu and the fused inject+scrub of
// csrc/inject_scrub.cu: one scrub body (the TPU kernels share
// `scrub_body` of src/repro/kernels/diag_parity/kernel.py the same way).
//
// A block is 32 consecutive 32-bit words; the slope-s parity word is
// XOR_i rotl32(w_i, s*i).  Word offsets are 64-bit: one phi3-mini arena
// copy is 3.8e9 words, three stacked copies 1.1e10.
//
// Encode (warp per block): lane i holds w_i, the rotation is a funnel
// shift, the XOR over the block a 5-step __shfl_xor_sync butterfly.
//
// Scrub (thread per block): the warp-per-block form spent 15 shuffles, two
// modulos and a classification on every lane per block, so it was bound by
// instructions, not bytes.  Here a warp stages its next 32 consecutive
// blocks (4 KB, and 4 KB of mask with kInject) into shared memory with
// coalesced 16-byte cp.async while it reduces the current 32 (a ring of
// STAGES tiles per warp, STAGES - 1 in flight), and thread t owns block t
// of the tile.  At step i it reads word j = (i + t) mod 32, so the 32
// lanes hit 32 distinct banks.  Since s*j = s*i + s*t (mod 32), the parity
// word is rotl32(Y, s*t) with Y = XOR_i rotl32(w_(i+t), s*i), which
// Horner's rule builds from i = 31 down as acc = rotl32(acc, s) ^ w_(i+t):
// one funnel shift by the slope and one XOR per word and family, one
// register per family (F is a template parameter, so no predicated-off
// family is issued).  The block's F parity words come in as register loads
// one tile ahead; the syndrome, the one-hot test, the location and the
// classification run once per block in its thread.
#pragma once

#include "common.cuh"

namespace diag {

constexpr int BLOCK = 32;   // words per ECC block == lanes per warp
constexpr int MAXF = 8;     // parity families supported
constexpr int WARPS = 8;    // warps per encode CTA
constexpr int UNROLL = 4;   // blocks an encode warp loads before reducing

constexpr int SWARPS = 4;                   // warps per scrub CTA
constexpr int TILE_WORDS = BLOCK * BLOCK;   // a warp's tile: 32 blocks
constexpr int STAGES = 2;                   // a warp's ring of tiles

struct Slopes {
  int s[MAXF];
};

__device__ __forceinline__ uint32_t rotl_lane(uint32_t w, int slope,
                                              int lane) {
  const int r = ((slope * lane) % BLOCK + BLOCK) % BLOCK;
  return __funnelshift_l(w, w, r);  // rotl32(w, r); r == 0 returns w
}

// rotl32(w, r mod 32) for any int r (the funnel shift uses r & 31)
__device__ __forceinline__ uint32_t rotl(uint32_t w, int r) {
  return __funnelshift_l(w, w, r);
}

// Copy n_words (a multiple of 32) from device memory into shared memory,
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

// The scrub, with an optional XOR fault mask folded in front of the XOR
// trees (kInject).  parity: (n_pblocks, F), read at row b % n_pblocks
// (n_pblocks divides n_blocks: copies of one arena share one table).
// parity_out: nullptr to drop parity corrections, else written at row b --
// every row when out_all, only healed rows otherwise (in place when
// parity_out == parity).  A word is written only where it changes: the
// flagged bit of word i0, and with kInject every word the mask touched
// that the correction does not restore.  counts: corrected, parity_fixed,
// uncorrectable (+ injected first when kInject), reduced per warp and per
// CTA and added with integer atomics, which are order-free, so the result
// is exact.  words and mask are 16-byte aligned; F (2 to MAXF families)
// is a template parameter.
template <bool kInject, int F>
__global__ void __launch_bounds__(SWARPS * 32)
    scrub_kernel(uint32_t* __restrict__ words,
                 const uint32_t* __restrict__ mask, long long n_blocks,
                 const uint32_t* parity, long long n_pblocks,
                 uint32_t* parity_out, int out_all, Slopes sl, int ia, int ib,
                 int* __restrict__ counts) {
  constexpr int NC = kInject ? 4 : 3;
  constexpr int C0 = kInject ? 1 : 0;  // index of `corrected` in counts
  constexpr int PLANES = kInject ? 2 : 1;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int cta[NC];
  if (threadIdx.x < NC) cta[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  uint32_t* ring = smem + wid * STAGES * PLANES * TILE_WORDS;
  const long long n_tiles = (n_blocks + BLOCK - 1) / BLOCK;
  const long long step = (long long)gridDim.x * SWARPS;  // tiles per pass
  long long tile = (long long)blockIdx.x * SWARPS + wid;
  // this lane's parity row, advanced by `delta` rows each pass
  long long pb = (tile * BLOCK + lane) % n_pblocks;
  const long long delta = (step * BLOCK) % n_pblocks;

  int n_corr = 0, n_pfix = 0, n_unc = 0;
  unsigned n_inj = 0;
  uint32_t par[F], par_next[F];
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k)
    stage_tile<kInject>(ring + k * PLANES * TILE_WORDS, words, mask,
                        tile + k * step, n_blocks, lane);
  const bool live0 = tile * BLOCK + lane < n_blocks;
#pragma unroll
  for (int f = 0; f < F; ++f)
    par[f] = live0 ? parity[pb * F + f] : 0u;
  int stage = 0;
  for (; tile < n_tiles; tile += step) {
    // refill the stage read in the last pass, and fetch the next parity
    stage_tile<kInject>(
        ring + (stage + STAGES - 1) % STAGES * PLANES * TILE_WORDS, words,
        mask, tile + (STAGES - 1) * step, n_blocks, lane);
    long long pb_next = pb + delta;
    if (pb_next >= n_pblocks) pb_next -= n_pblocks;
    const bool live = (tile + step) * BLOCK + lane < n_blocks;
#pragma unroll
    for (int f = 0; f < F; ++f)
      par_next[f] = live ? parity[pb_next * F + f] : 0u;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
    __syncwarp();  // every lane's part of this tile has landed

    const long long b = tile * BLOCK + lane;
    if (b < n_blocks) {
      const uint32_t* sw = ring + stage * PLANES * TILE_WORDS + lane * BLOCK;
      const uint32_t* sm = sw + TILE_WORDS;
      uint32_t acc[F];
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = 0u;
      uint32_t touched = 0u;
#pragma unroll
      for (int i = BLOCK - 1; i >= 0; --i) {
        const int j = (i + lane) & (BLOCK - 1);
        uint32_t w = sw[j];
        if constexpr (kInject) {
          const uint32_t m = sm[j];
          touched |= m;
          n_inj += __popc(m);
          w ^= m;  // the injection
        }
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = rotl(acc[f], sl.s[f]) ^ w;
      }
      uint32_t syn[F];
      int hot[F];
      int n_nonzero = 0, ha = 0, hb = 0;
      bool all_onehot = true, all_le1 = true;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        syn[f] = rotl(acc[f], sl.s[f] * lane) ^ par[f];
        const int pc = __popc(syn[f]);
        n_nonzero += pc > 0;
        all_onehot &= pc == 1;
        all_le1 &= pc <= 1;
        hot[f] = __ffs(syn[f]) - 1;  // the one-hot bit (used if one-hot)
        if (f == ia) ha = hot[f];
        if (f == ib) hb = hot[f];
      }
      // locate: slopes 1 and 2 invert the diagonal system
      const int i0 = (hb - ha) & (BLOCK - 1);
      const int j0 = (ha - i0) & (BLOCK - 1);
      bool consistent = true;
#pragma unroll
      for (int f = 0; f < F; ++f)
        consistent &= hot[f] == ((j0 + sl.s[f] * i0) & (BLOCK - 1));
      const bool data_err = n_nonzero == F && all_onehot && consistent;
      const bool parity_err = n_nonzero == 1 && all_le1;
      const bool uncorrectable = n_nonzero > 0 && !data_err && !parity_err;
      uint32_t* out = words + b * BLOCK;
      bool written = false;
      if constexpr (kInject) {
        if (touched) {
          for (int i = 0; i < BLOCK; ++i) {
            const uint32_t m = sm[i];
            const uint32_t fix = data_err && i == i0 ? 1u << j0 : 0u;
            if (m ^ fix) out[i] = sw[i] ^ m ^ fix;
          }
          written = true;
        }
      }
      if (data_err && !written) out[i0] = sw[i0] ^ (1u << j0);
      if (parity_out != nullptr && (out_all || parity_err)) {
#pragma unroll
        for (int f = 0; f < F; ++f)
          parity_out[b * F + f] = par[f] ^ (parity_err ? syn[f] : 0u);
      }
      n_corr += data_err;
      n_pfix += parity_err;
      n_unc += uncorrectable;
    }
    __syncwarp();  // the stage is read out before the next issue refills it
#pragma unroll
    for (int f = 0; f < F; ++f) par[f] = par_next[f];
    pb = pb_next;
    stage = (stage + 1) % STAGES;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  n_corr = __reduce_add_sync(0xffffffffu, n_corr);
  n_pfix = __reduce_add_sync(0xffffffffu, n_pfix);
  n_unc = __reduce_add_sync(0xffffffffu, n_unc);
  if (kInject) n_inj = __reduce_add_sync(0xffffffffu, n_inj);
  if (lane == 0) {
    if (kInject && n_inj) atomicAdd(&cta[0], (int)n_inj);
    if (n_corr) atomicAdd(&cta[C0], n_corr);
    if (n_pfix) atomicAdd(&cta[C0 + 1], n_pfix);
    if (n_unc) atomicAdd(&cta[C0 + 2], n_unc);
  }
  __syncthreads();
  if (threadIdx.x < NC && cta[threadIdx.x])
    atomicAdd(&counts[threadIdx.x], cta[threadIdx.x]);
}

inline int grid_for(long long n_blocks) {
  const long long need = (n_blocks + WARPS * UNROLL - 1) / (WARPS * UNROLL);
  const long long cap = (long long)repro_sm_count() * 8;
  return (int)(need < cap ? need : cap);
}

inline bool load_slopes(const int* slopes, int F, Slopes* sl) {
  if (F < 1 || F > MAXF) return false;
  for (int f = 0; f < MAXF; ++f) sl->s[f] = f < F ? slopes[f] : 0;
  return true;
}

// Launch the scrub with F families fixed at compile time: the kernel's
// per-word loop over the families then issues no predicated-off work.
template <bool kInject, int F>
int launch_scrub_f(int n_fam, uint32_t* words, const uint32_t* mask,
                   long long n_blocks, const uint32_t* parity,
                   long long n_pblocks, uint32_t* parity_out, int out_all,
                   const Slopes& sl, int ia, int ib, int* counts,
                   cudaStream_t stream) {
  if (n_fam != F) {
    if constexpr (F < MAXF)
      return launch_scrub_f<kInject, F + 1>(n_fam, words, mask, n_blocks,
                                            parity, n_pblocks, parity_out,
                                            out_all, sl, ia, ib, counts,
                                            stream);
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = scrub_kernel<kInject, F>;
  const int smem = SWARPS * STAGES * (kInject ? 2 : 1) * TILE_WORDS * 4;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    SWARPS * 32, smem);
  if (e != cudaSuccess) return (int)e;
  const long long n_tiles = (n_blocks + BLOCK - 1) / BLOCK;
  const long long need = (n_tiles + SWARPS - 1) / SWARPS;
  const long long cap =
      (long long)repro_sm_count() * (per_sm > 0 ? per_sm : 1);
  kernel<<<(int)(need < cap ? need : cap), SWARPS * 32, smem, stream>>>(
      words, mask, n_blocks, parity, n_pblocks, parity_out, out_all, sl, ia,
      ib, counts);
  return (int)cudaGetLastError();
}

// Shared argument checks and launch of the scrub kernel.
template <bool kInject>
int launch_scrub(uint32_t* words, const uint32_t* mask, long long n_blocks,
                 const uint32_t* parity, long long n_pblocks,
                 uint32_t* parity_out, int out_all, const int* slopes, int F,
                 int ia, int ib, int* counts, void* stream) {
  Slopes sl;
  const uintptr_t align = reinterpret_cast<uintptr_t>(words) |
                          reinterpret_cast<uintptr_t>(mask);
  if (!load_slopes(slopes, F, &sl) || F < 2 || ia < 0 || ib < 0 ||
      ia >= F || ib >= F || n_pblocks < 1 || n_blocks % n_pblocks ||
      align % 16)
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  return launch_scrub_f<kInject, 2>(F, words, mask, n_blocks, parity,
                                    n_pblocks, parity_out, out_all, sl, ia,
                                    ib, counts,
                                    static_cast<cudaStream_t>(stream));
}

}  // namespace diag
