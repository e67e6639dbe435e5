// (39,32) Hsiao SEC-DED encode and fused scrub over the packed arena.
//
// Replaces the TPU kernels `encode_hsiao_kernel` and `scrub_hsiao_kernel`
// of src/repro/kernels/hsiao_secded/kernel.py (:47 and :112, bodies
// `_encode_checks` and `hsiao_body`).  Each 32-bit word carries 7 check
// bits (check j = parity of w & CHECK_MASKS[j]); a block of 32 words keeps
// them packed as 7 words, check bit j of word i at bit i of word j.
//
// Design: one warp per 32-word block, lane i holds word i.  The packed
// check word j is one __ballot_sync of lane i's check bit, so the layout
// falls out of the vote with no shifts or reductions.  The scrub recomputes
// the 7 ballots, XORs them with the stored row (each lane < 7 loads one
// parity word, __shfl_sync hands it to all), takes bit `lane` of each as
// the word's 7-bit syndrome and classifies it through a 128-entry table in
// shared memory (data bit k, check bit j, clean, or uncorrectable) instead
// of the reference's 39 unrolled compares.  A data error flips its bit (the
// only word write); a check-bit error heals only the parity row; any other
// nonzero syndrome -- a double error -- leaves the word as it is and counts
// uncorrectable.  Counts are per word, reduced per warp and per CTA before
// one integer atomic each.  Word offsets are 64-bit.
//
// Bound: device-memory bytes.  Encode reads every word once and writes
// 7/32 of that; the clean scrub reads words and table and writes nothing:
// for one fp32 phi3-mini arena (3.82e9 words) 18.63 GB, 5.56 ms at
// 3.35 TB/s.
#include "common.cuh"

namespace {

constexpr int BLOCK = 32;
constexpr int NCHK = 7;
constexpr int WARPS = 8;
constexpr int UNROLL = 4;
constexpr int LUT_SIZE = 1 << NCHK;
constexpr uint8_t CLS_CHECK = 32;   // 32 + j: check bit j
constexpr uint8_t CLS_CLEAN = 64;
constexpr uint8_t CLS_UNC = 65;

struct Code {
  uint32_t masks[NCHK];   // CHECK_MASKS
  uint8_t lut[LUT_SIZE];  // syndrome -> class
};

__device__ __forceinline__ uint32_t check_ballot(uint32_t w, uint32_t m) {
  return __ballot_sync(0xffffffffu, __popc(w & m) & 1);
}

__global__ void __launch_bounds__(WARPS * 32)
    encode_kernel(const uint32_t* __restrict__ words, long long n_blocks,
                  uint32_t* __restrict__ parity, Code code) {
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
      uint32_t mine = 0;
#pragma unroll
      for (int j = 0; j < NCHK; ++j) {
        const uint32_t c = check_ballot(w[u], code.masks[j]);
        if (lane == j) mine = c;
      }
      if (lane < NCHK) parity[b * NCHK + lane] = mine;
    }
  }
}

// parity: (n_pblocks, 7), read at row b % n_pblocks.  parity_out: nullptr
// to drop parity corrections, else written at row b -- every row when
// out_all, only healed rows otherwise (in place when parity_out ==
// parity).  counts: corrected, parity_fixed, uncorrectable words.
__global__ void __launch_bounds__(WARPS * 32)
    scrub_kernel(uint32_t* __restrict__ words, long long n_blocks,
                 const uint32_t* parity, long long n_pblocks,
                 uint32_t* parity_out, int out_all, Code code,
                 int* __restrict__ counts) {
  __shared__ uint8_t lut[LUT_SIZE];
  __shared__ int cta[3];
  for (int i = threadIdx.x; i < LUT_SIZE; i += blockDim.x)
    lut[i] = code.lut[i];
  if (threadIdx.x < 3) cta[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * WARPS;
  unsigned n_corr = 0, n_pfix = 0, n_unc = 0;
  for (long long base = warp * UNROLL; base < n_blocks;
       base += n_warps * UNROLL) {
    uint32_t w[UNROLL], p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long b = base + u;
      const long long pb = n_pblocks == n_blocks ? b : b % n_pblocks;
      w[u] = b < n_blocks ? words[b * BLOCK + lane] : 0u;
      p[u] = b < n_blocks && lane < NCHK ? parity[pb * NCHK + lane] : 0u;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long b = base + u;
      if (b >= n_blocks) break;  // warp-uniform
      uint32_t s = 0;
#pragma unroll
      for (int j = 0; j < NCHK; ++j) {
        const uint32_t syn = check_ballot(w[u], code.masks[j]) ^
                             __shfl_sync(0xffffffffu, p[u], j);
        s |= ((syn >> lane) & 1u) << j;
      }
      const int cls = lut[s];
      if (cls < BLOCK) words[b * BLOCK + lane] = w[u] ^ (1u << cls);
      const bool check_err = cls >= CLS_CHECK && cls < CLS_CHECK + NCHK;
      n_corr += cls < BLOCK;
      n_pfix += check_err;
      n_unc += cls == CLS_UNC;
      const bool heal = __any_sync(0xffffffffu, check_err);
      if (parity_out != nullptr && (out_all || heal)) {
        uint32_t fix = 0;
#pragma unroll
        for (int j = 0; j < NCHK; ++j) {
          const uint32_t f = __ballot_sync(0xffffffffu, cls == CLS_CHECK + j);
          if (lane == j) fix = f;
        }
        if (lane < NCHK) parity_out[b * NCHK + lane] = p[u] ^ fix;
      }
    }
  }
  n_corr = __reduce_add_sync(0xffffffffu, n_corr);
  n_pfix = __reduce_add_sync(0xffffffffu, n_pfix);
  n_unc = __reduce_add_sync(0xffffffffu, n_unc);
  if (lane == 0) {
    if (n_corr) atomicAdd(&cta[0], (int)n_corr);
    if (n_pfix) atomicAdd(&cta[1], (int)n_pfix);
    if (n_unc) atomicAdd(&cta[2], (int)n_unc);
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

// The code's tables from its 7 check masks and 32 data columns (the
// syndromes of single data-bit flips).
bool load_code(const uint32_t* masks, const int* columns, Code* code) {
  for (int j = 0; j < NCHK; ++j) code->masks[j] = masks[j];
  for (int s = 0; s < LUT_SIZE; ++s) code->lut[s] = CLS_UNC;
  code->lut[0] = CLS_CLEAN;
  for (int j = 0; j < NCHK; ++j) code->lut[1 << j] = CLS_CHECK + j;
  for (int k = 0; k < BLOCK; ++k) {
    const int c = columns[k];
    if (c <= 0 || c >= LUT_SIZE || code->lut[c] != CLS_UNC) return false;
    code->lut[c] = (uint8_t)k;
  }
  return true;
}

}  // namespace

extern "C" int hsiao_encode(const uint32_t* words, long long n_blocks,
                            uint32_t* parity, const uint32_t* masks,
                            const int* columns, void* stream) {
  Code code;
  if (!load_code(masks, columns, &code)) return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  encode_kernel<<<grid_for(n_blocks), WARPS * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(words, n_blocks,
                                                       parity, code);
  return (int)cudaGetLastError();
}

extern "C" int hsiao_scrub(uint32_t* words, long long n_blocks,
                           const uint32_t* parity, long long n_pblocks,
                           uint32_t* parity_out, int out_all,
                           const uint32_t* masks, const int* columns,
                           int* counts, void* stream) {
  Code code;
  if (!load_code(masks, columns, &code) || n_pblocks < 1 ||
      n_blocks % n_pblocks)
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  scrub_kernel<<<grid_for(n_blocks), WARPS * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      words, n_blocks, parity, n_pblocks, parity_out, out_all, code, counts);
  return (int)cudaGetLastError();
}
