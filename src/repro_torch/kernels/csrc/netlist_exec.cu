// Levelized Minority3 netlist executor over trial-packed words.
//
// Replaces the TPU kernel `netlist_exec_kernel` of
// src/repro/kernels/netlist_exec/kernel.py:76 (bodies `_kernel`,
// `_xor_kernel`, `_inject_kernel`).  The state is (base + L*W, tw) 32-bit
// words, row-major: row r holds wire r of 32*tw trials, trial t in bit t%32
// of word t/32.  Level l reads the (W, 3) rows `rows_in[l]` (all below
// base + l*W), computes W Minority3 gates, corrupts each as
// (val & keep[l, s]) ^ flip[l, s] (mask mode: none, flip only, or both),
// and writes rows [base + l*W, base + (l+1)*W).  Padding slots read row 0
// and write ~0 (then their identity masks) into their own row.  The state
// is updated in place: rows [0, base) are read and never written.
//
// Design: a block owns 32 consecutive trial words for all L levels; a warp
// is one row of those 32 words, so every state, keep and flip access of a
// warp is one coalesced 128-byte line.  The block's 8 warps split a level's
// W slots, and a block barrier separates the levels (the TPU's fori_loop
// over levels; nothing carries between blocks).  Each warp loads the inputs
// of 4 slots before it stores any of their outputs, so 12 gathers are in
// flight at once.  The state stays in device memory (5.4 GB at 2^20 trials
// of the 32-bit multiplier): a level's rows are re-read from L2 by the
// next levels.  Offsets are 64-bit (the state passes 2^31 words at 2^21
// trials).
//
// Bound: device-memory bytes -- rows [0, base) read, keep and flip read,
// rows [base, base + L*W) written.
#include "common.cuh"

namespace {

constexpr int kLanes = 32;   // trial words per block
constexpr int kWarps = 8;    // warps per block, splitting a level's slots
constexpr int kUnroll = 4;   // slots per warp with loads in flight

enum Mode { kNone = 0, kXor = 1, kKeepXor = 2 };

template <int kMode>
__global__ void __launch_bounds__(kLanes * kWarps)
netlist_exec_kernel(const int* __restrict__ rows_in, uint32_t* state,
                    const uint32_t* __restrict__ keep,
                    const uint32_t* __restrict__ flip, int L, int W,
                    int base, long long tw) {
  const long long t = (long long)blockIdx.x * kLanes + threadIdx.x;
  const bool live = t < tw;
  for (int l = 0; l < L; ++l) {
    if (live) {
      const int* rows = rows_in + (long long)l * W * 3;
      uint32_t* out = state + ((long long)base + (long long)l * W) * tw + t;
      const long long m0 = (long long)l * W * tw + t;
      for (int s0 = threadIdx.y; s0 < W; s0 += kWarps * kUnroll) {
        uint32_t v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int s = s0 + u * kWarps;
          if (s < W) {
            const uint32_t a = state[(long long)__ldg(rows + 3 * s) * tw + t];
            const uint32_t b =
                state[(long long)__ldg(rows + 3 * s + 1) * tw + t];
            const uint32_t c =
                state[(long long)__ldg(rows + 3 * s + 2) * tw + t];
            v[u] = ~((a & b) | (b & c) | (a & c));
            const long long m = m0 + (long long)s * tw;
            if (kMode == kKeepXor) v[u] &= __ldg(keep + m);
            if (kMode != kNone) v[u] ^= __ldg(flip + m);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int s = s0 + u * kWarps;
          if (s < W) out[(long long)s * tw] = v[u];
        }
      }
    }
    __syncthreads();   // level l's rows are complete before l+1 reads them
  }
}

}  // namespace

extern "C" int netlist_exec(const int* rows_in, uint32_t* state,
                            const uint32_t* keep, const uint32_t* flip,
                            int L, int W, int base, long long tw, int mode,
                            void* stream) {
  if (L <= 0 || tw <= 0) return 0;
  if (W <= 0 || base < 0 || mode < kNone || mode > kKeepXor)
    return (int)cudaErrorInvalidValue;
  const dim3 block(kLanes, kWarps);
  const long long grid = (tw + kLanes - 1) / kLanes;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kNone) {
    netlist_exec_kernel<kNone><<<(unsigned)grid, block, 0, st>>>(
        rows_in, state, keep, flip, L, W, base, tw);
  } else if (mode == kXor) {
    netlist_exec_kernel<kXor><<<(unsigned)grid, block, 0, st>>>(
        rows_in, state, keep, flip, L, W, base, tw);
  } else {
    netlist_exec_kernel<kKeepXor><<<(unsigned)grid, block, 0, st>>>(
        rows_in, state, keep, flip, L, W, base, tw);
  }
  return (int)cudaGetLastError();
}
