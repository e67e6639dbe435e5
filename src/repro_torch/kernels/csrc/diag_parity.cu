// Diagonal-parity encode and fused scrub over the packed weight arena.
//
// Replaces the TPU kernels `encode_parity_kernel` and `scrub_kernel` of
// src/repro/kernels/diag_parity/kernel.py (:48 and :130, bodies `_kernel`
// and `scrub_body`).  A block is 32 consecutive 32-bit words; the slope-s
// parity word is XOR_i rotl32(w_i, s*i).
//
// Design: one warp per block, lane i holds w_i.  The rotation is a funnel
// shift, the XOR over the block a 5-step butterfly of __shfl_xor_sync, so
// every lane ends with the block's syndrome and the classification is
// warp-uniform.  A warp loads UNROLL consecutive blocks (512 B) before it
// reduces them, to keep more bytes in flight.  The scrub writes in place
// and only where a word changes (the flagged bit of word i0, or a healed
// parity word); counts are reduced per CTA in shared memory and added to a
// (3,) int32 vector with integer atomics, which are order-free, so the
// result is exact.  Word offsets are 64-bit: one phi3-mini arena copy is
// 3.8e9 words, three stacked copies 1.1e10.
//
// Bound: both passes read every arena word once (scrub also the parity
// table) and write almost nothing, so they are bound by device-memory
// bytes: about 16.7 GB for one fp32 phi3-mini copy, 5 ms at 3.35 TB/s.
#include "common.cuh"

namespace {

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

// parity: (n_pblocks, F), read at row b % n_pblocks (n_pblocks divides
// n_blocks: copies of one arena share one table).  parity_out: nullptr to
// drop parity corrections, else written at row b -- every row when out_all,
// only healed rows otherwise (in place when parity_out == parity).
__global__ void __launch_bounds__(WARPS * 32)
    scrub_kernel(uint32_t* __restrict__ words, long long n_blocks,
                 const uint32_t* parity, long long n_pblocks,
                 uint32_t* parity_out, int out_all, Slopes sl, int F, int ia,
                 int ib, int* __restrict__ counts) {
  __shared__ int cta[3];
  if (threadIdx.x < 3) cta[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * WARPS;
  int n_corr = 0, n_pfix = 0, n_unc = 0;
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
      const long long pb = n_pblocks == n_blocks ? b : b % n_pblocks;
      uint32_t syn[MAXF], par[MAXF];
      int hot[MAXF];
      int n_nonzero = 0, ha = 0, hb = 0;
      bool all_onehot = true, all_le1 = true;
#pragma unroll
      for (int f = 0; f < MAXF; ++f) {
        if (f < F) {
          par[f] = parity[pb * F + f];
          syn[f] = warp_xor_all(rotl_lane(w[u], sl.s[f], lane)) ^ par[f];
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
      if (data_err && lane == i0) words[b * BLOCK + lane] = w[u] ^ (1u << j0);
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
  if (lane == 0) {  // every lane holds the same warp totals
    if (n_corr) atomicAdd(&cta[0], n_corr);
    if (n_pfix) atomicAdd(&cta[1], n_pfix);
    if (n_unc) atomicAdd(&cta[2], n_unc);
  }
  __syncthreads();
  if (threadIdx.x < 3 && cta[threadIdx.x])
    atomicAdd(&counts[threadIdx.x], cta[threadIdx.x]);
}

int grid_for(long long n_blocks) {
  const long long need = (n_blocks + WARPS * UNROLL - 1) / (WARPS * UNROLL);
  const long long cap = (long long)repro_sm_count() * 8;
  return (int)(need < cap ? need : cap);
}

bool load_slopes(const int* slopes, int F, Slopes* sl) {
  if (F < 1 || F > MAXF) return false;
  for (int f = 0; f < MAXF; ++f) sl->s[f] = f < F ? slopes[f] : 0;
  return true;
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
  Slopes sl;
  if (!load_slopes(slopes, F, &sl) || ia < 0 || ib < 0 || ia >= F ||
      ib >= F || n_pblocks < 1 || n_blocks % n_pblocks)
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  scrub_kernel<<<grid_for(n_blocks), WARPS * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      words, n_blocks, parity, n_pblocks, parity_out, out_all, sl, F, ia, ib,
      counts);
  return (int)cudaGetLastError();
}
