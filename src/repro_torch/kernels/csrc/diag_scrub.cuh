// The diagonal-parity block code on the card, shared by the encode and
// scrub of csrc/diag_parity.cu and the fused inject+scrub of
// csrc/inject_scrub.cu: one scrub body (the TPU kernels share
// `scrub_body` of src/repro/kernels/diag_parity/kernel.py the same way).
//
// A block is 32 consecutive 32-bit words; the slope-s parity word is
// XOR_i rotl32(w_i, s*i).  One warp per block, lane i holds w_i.  The
// rotation is a funnel shift, the XOR over the block a 5-step butterfly of
// __shfl_xor_sync, so every lane ends with the block's syndrome and the
// classification is warp-uniform.  A warp loads UNROLL consecutive blocks
// (512 B) before it reduces them, to keep more bytes in flight.  Word
// offsets are 64-bit: one phi3-mini arena copy is 3.8e9 words, three
// stacked copies 1.1e10.
#pragma once

#include "common.cuh"

namespace diag {

constexpr int BLOCK = 32;   // words per ECC block == lanes per warp
constexpr int MAXF = 8;     // parity families supported
constexpr int WARPS = 8;    // warps per CTA
constexpr int UNROLL = 4;   // blocks a warp loads before reducing

struct Slopes {
  int s[MAXF];
};

__device__ __forceinline__ uint32_t rotl_lane(uint32_t w, int slope,
                                              int lane) {
  const int r = ((slope * lane) % BLOCK + BLOCK) % BLOCK;
  return __funnelshift_l(w, w, r);  // rotl32(w, r); r == 0 returns w
}

// The scrub, with an optional XOR fault mask folded in front of the XOR
// trees (kInject).  parity: (n_pblocks, F), read at row b % n_pblocks
// (n_pblocks divides n_blocks: copies of one arena share one table).
// parity_out: nullptr to drop parity corrections, else written at row b --
// every row when out_all, only healed rows otherwise (in place when
// parity_out == parity).  A word is written only where it changes: the
// flagged bit of word i0, and with kInject every word the mask touched
// that the correction does not restore.  counts: corrected, parity_fixed,
// uncorrectable (+ injected first when kInject), reduced per CTA in shared
// memory and added with integer atomics, which are order-free, so the
// result is exact.
template <bool kInject>
__global__ void __launch_bounds__(WARPS * 32)
    scrub_kernel(uint32_t* __restrict__ words,
                 const uint32_t* __restrict__ mask, long long n_blocks,
                 const uint32_t* parity, long long n_pblocks,
                 uint32_t* parity_out, int out_all, Slopes sl, int F, int ia,
                 int ib, int* __restrict__ counts) {
  constexpr int NC = kInject ? 4 : 3;
  constexpr int C0 = kInject ? 1 : 0;  // index of `corrected` in counts
  __shared__ int cta[NC];
  if (threadIdx.x < NC) cta[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * WARPS;
  int n_corr = 0, n_pfix = 0, n_unc = 0;
  unsigned n_inj = 0;
  for (long long base = warp * UNROLL; base < n_blocks;
       base += n_warps * UNROLL) {
    uint32_t w[UNROLL], m[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long b = base + u;
      w[u] = b < n_blocks ? words[b * BLOCK + lane] : 0u;
      m[u] = kInject && b < n_blocks ? mask[b * BLOCK + lane] : 0u;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long b = base + u;
      if (b >= n_blocks) break;  // warp-uniform
      const uint32_t wi = w[u] ^ m[u];  // the injection
      if (kInject) n_inj += __popc(m[u]);
      const long long pb = n_pblocks == n_blocks ? b : b % n_pblocks;
      uint32_t syn[MAXF], par[MAXF];
      int hot[MAXF];
      int n_nonzero = 0, ha = 0, hb = 0;
      bool all_onehot = true, all_le1 = true;
#pragma unroll
      for (int f = 0; f < MAXF; ++f) {
        if (f < F) {
          par[f] = parity[pb * F + f];
          syn[f] = warp_xor_all(rotl_lane(wi, sl.s[f], lane)) ^ par[f];
          const int pc = __popc(syn[f]);
          n_nonzero += pc > 0;
          all_onehot &= pc == 1;
          all_le1 &= pc <= 1;
          hot[f] = __ffs(syn[f]) - 1;  // the one-hot bit (used if one-hot)
          if (f == ia) ha = hot[f];
          if (f == ib) hb = hot[f];
        }
      }
      // locate: slopes 1 and 2 invert the diagonal system
      const int i0 = (hb - ha) & (BLOCK - 1);
      const int j0 = (ha - i0) & (BLOCK - 1);
      bool consistent = true;
#pragma unroll
      for (int f = 0; f < MAXF; ++f) {
        if (f < F) consistent &= hot[f] == ((j0 + sl.s[f] * i0) & (BLOCK - 1));
      }
      const bool data_err = n_nonzero == F && all_onehot && consistent;
      const bool parity_err = n_nonzero == 1 && all_le1;
      const bool uncorrectable = n_nonzero > 0 && !data_err && !parity_err;
      const uint32_t fix = data_err && lane == i0 ? 1u << j0 : 0u;
      if (m[u] ^ fix) words[b * BLOCK + lane] = wi ^ fix;
      if (parity_out != nullptr && (out_all || parity_err)) {
#pragma unroll
        for (int f = 0; f < MAXF; ++f) {
          if (f < F && lane == f)
            parity_out[b * F + f] = par[f] ^ (parity_err ? syn[f] : 0u);
        }
      }
      n_corr += data_err;
      n_pfix += parity_err;
      n_unc += uncorrectable;
    }
  }
  if (kInject) n_inj = __reduce_add_sync(0xffffffffu, n_inj);
  if (lane == 0) {  // every lane holds the same warp totals
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

// Shared argument checks and launch of the scrub kernel.
template <bool kInject>
int launch_scrub(uint32_t* words, const uint32_t* mask, long long n_blocks,
                 const uint32_t* parity, long long n_pblocks,
                 uint32_t* parity_out, int out_all, const int* slopes, int F,
                 int ia, int ib, int* counts, void* stream) {
  Slopes sl;
  if (!load_slopes(slopes, F, &sl) || ia < 0 || ib < 0 || ia >= F ||
      ib >= F || n_pblocks < 1 || n_blocks % n_pblocks)
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  scrub_kernel<kInject><<<grid_for(n_blocks), WARPS * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      words, mask, n_blocks, parity, n_pblocks, parity_out, out_all, sl, F,
      ia, ib, counts);
  return (int)cudaGetLastError();
}

}  // namespace diag
