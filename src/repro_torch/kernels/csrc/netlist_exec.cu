// Levelized Minority3 netlist executor over trial-packed words, with the
// live wire state in shared memory.
//
// Replaces the TPU kernel `netlist_exec_kernel` of
// src/repro/kernels/netlist_exec/kernel.py:76 (bodies `_kernel`,
// `_xor_kernel`, `_inject_kernel`).  The state is (base + L*W, tw) 32-bit
// words, row-major: row r holds wire r of 32*tw trials, trial t in bit t%32
// of word t/32.  Level l computes W Minority3 gates over rows below
// base + l*W, corrupts each as (val & keep[l, s]) ^ flip[l, s] (mask mode:
// none, flip only, or both) and writes rows [base + l*W, base + (l+1)*W).
// The state is updated in place: rows [0, base) are read and never
// written; every row at or above base is written, padding rows included.
//
// Design: the TPU kernel carries a trial tile's whole state through its
// level loop in VMEM.  A CTA here owns T trial words (T = 32 ... 1) for all
// L levels and keeps on chip only the rows still to be read: a host plan
// (kernels/netlist_exec/plan.py) gives every row that a later level reads a
// shared-memory slot for its live span, and turns each gate into a
// descriptor of four 16-bit slot numbers (inputs a, b, c, output or none).
// A CTA loads its base rows into their slots once; then, per level, each
// of its 1024 threads takes V consecutive words (V = 4 by 16-byte accesses
// where tw is a multiple of 4, else 1) of every SS-th slot: reads the three
// inputs from shared memory (a warp reads runs of T words of a slot row),
// computes Min3, applies the masks, stores the words to device memory
// (coalesced, every gate) and to the output slot (if the plan gave one).
// No slot is reused before its last read, so one barrier a level orders
// the levels.  The level's descriptors and mask rows stream through a ring
// of kStages levels in shared memory by cp.async, two levels ahead of the
// level being computed.  Offsets into the state and masks are 64-bit (the
// state passes 2^31 words at 2^21 trials) and advance by constant steps.
// The walk's accesses, cp.async and Min3 come from level_walk.cuh, shared
// with crossbar_nor.cu.
//
// Bound: device-memory bytes -- rows [0, base) and the masks read once,
// rows [base, base + L*W) written once: for the 32-bit multiplier at 2^20
// trials (L = 320, W = 128, base 66) 1.605 ms without masks, 3.208 with
// flip and 4.811 with keep and flip at 3.35 TB/s.  The kernel this
// replaces kept the state in device memory and gathered every input from
// there: 16.1 GB of loads a launch through L1/L2, 38-62% of the bound.
// As built for sm_90a (python -m repro_torch.kernels.sass_report), the
// level loop at a 32-word tile, four words a thread, is 356 / 431
// instructions without masks / with flip (361 with both at 16 words): one
// LDS.64 descriptor and three LDS.128 gathers a slot, STG.128 and STS.128
// for its words, LDGSTS for the next levels' descriptors and masks, no
// LDG (rows below base are read before the loop); 32-58 registers, no
// spills.  The kernel it replaces held 24-32 LDG.32 gathers in its loop.
#include "level_walk.cuh"

namespace {

using walk::cp_async;
using walk::cp_async_desc;
using walk::kNoSlot;
using walk::ld;
using walk::st;
using walk::Vec;

constexpr int kThreads = 1024;  // threads per CTA
constexpr int kStages = 3;      // ring levels (plan.STAGES)
constexpr int kUnroll = 2;      // slots a thread reads before it writes

enum Mode { kNone = 0, kXor = 1, kKeepXor = 2 };

// Words of a ring stage's W descriptors (2 words each), rounded up to 16
// bytes: the stage's mask planes follow them.
__host__ __device__ constexpr int desc_words(int W) {
  return (2 * W + 3) / 4 * 4;
}

// Words of one ring stage: the descriptors and NM mask planes of W x T
// words, rounded up to 16 bytes (plan.Plan.stage_words).
__host__ __device__ constexpr int stage_words(int W, int T, int NM) {
  return desc_words(W) + (NM * T * W + 3) / 4 * 4;
}

template <int kMode>
__host__ __device__ constexpr int n_masks() {
  return kMode == kKeepXor ? 2 : kMode == kXor ? 1 : 0;
}

// Stage a level's W descriptors (from desc_l) and this thread's mask words
// (words w .. w+V-1 of slots s0, s0 + SS, ...; `off` is slot s0's offset
// into keep and flip, row_step SS rows) into `sg`, and commit them as one
// cp.async group (an empty group past the last level keeps the count per
// level).
template <int T, int V, int kMode>
__device__ __forceinline__ void stage_level(
    uint32_t* sg, bool live, int W, const uint2* __restrict__ desc_l,
    const uint32_t* __restrict__ keep, const uint32_t* __restrict__ flip,
    long long off, long long row_step, int s0, int w, bool col) {
  constexpr int SS = kThreads / (T / V);
  if (live) {
    uint2* d = reinterpret_cast<uint2*>(sg);
    for (int s = threadIdx.x; s < W; s += kThreads)
      cp_async_desc(d + s, desc_l + s);
    if constexpr (n_masks<kMode>() > 0) {
      if (col) {
        uint32_t* fl = sg + desc_words(W) + w;
        for (int s = s0; s < W; s += SS, off += row_step) {
          cp_async<V>(fl + s * T, flip + off);
          if constexpr (kMode == kKeepXor)
            cp_async<V>(fl + (W + s) * T, keep + off);
        }
      }
    }
  }
  walk::commit_stage();
}

// Thread t owns words w .. w+V-1 of the CTA's tile (w = V * (t mod T/V))
// and slots s0 = t / (T/V), s0 + SS, ... of every level (SS = kThreads /
// (T/V)), so a warp's accesses to a slot row, a mask row or a state row
// are runs of T consecutive words, V words a lane.
template <int T, int V, int kMode>
__global__ void __launch_bounds__(kThreads)
    netlist_exec_kernel(const uint2* __restrict__ desc,
                        const int* __restrict__ base_slot, uint32_t* state,
                        const uint32_t* __restrict__ keep,
                        const uint32_t* __restrict__ flip, int L, int W,
                        int base, long long tw) {
  constexpr int SS = kThreads / (T / V);
  extern __shared__ __align__(16) uint32_t smem[];
  const int sw = stage_words(W, T, n_masks<kMode>());
  uint32_t* slots = smem + kStages * sw;
  const int w = threadIdx.x % (T / V) * V, s0 = threadIdx.x / (T / V);
  const long long t0 = (long long)blockIdx.x * T;
  const bool col = t0 + w < tw;   // with V = 4, tw is a multiple of 4
  const long long row_step = (long long)SS * tw;
  const long long level_step = (long long)W * tw;
  // offset of (level, slot s0, word w) in the masks, for the next level
  // to stage; the same offset past row `base` in the state
  long long off = (long long)s0 * tw + t0 + w;
  uint32_t* out = state + (long long)base * tw + off;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k, off += level_step)
    stage_level<T, V, kMode>(smem + k * sw, k < L, W,
                             desc + (long long)k * W, keep, flip, off,
                             row_step, s0, w, col);
  for (int r = s0; r < base; r += SS) {
    const int s = base_slot[r];
    if (s >= 0 && col)
      st<V>(slots + s * T + w, ld<V>(state + (long long)r * tw + t0 + w));
  }
  uint32_t* my = slots + w;   // slot k's words: my[k * T ...]
  for (int l = 0; l < L; ++l, out += level_step) {
    walk::wait_stages<kStages - 2>();
    // level l's stage has landed for every thread, level l-1's slot
    // writes are visible, and its stage is read out
    __syncthreads();
    const int ls = l + kStages - 1;
    stage_level<T, V, kMode>(smem + ls % kStages * sw, ls < L, W,
                             desc + (long long)ls * W, keep, flip, off,
                             row_step, s0, w, col);
    off += level_step;
    const uint32_t* sg = smem + l % kStages * sw;
    const uint2* d = reinterpret_cast<const uint2*>(sg);
    const uint32_t* fl = sg + desc_words(W) + w;
    const uint32_t* kp = fl + W * T;
    uint32_t* o_ptr = out;
    for (int s = s0; s < W; s += kUnroll * SS) {
      Vec<V> v[kUnroll];
      uint32_t o[kUnroll];
      // every input of the level is read before any of its outputs is
      // written (the plan keeps them in distinct slots)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int su = s + u * SS;
        o[u] = kNoSlot;
        if (su < W) {
          const uint2 e = d[su];
          const Vec<V> a = ld<V>(my + (e.x & 0xFFFFu) * T);
          const Vec<V> b = ld<V>(my + (e.x >> 16) * T);
          const Vec<V> c = ld<V>(my + (e.y & 0xFFFFu) * T);
          Vec<V> km, fm;
          if constexpr (kMode == kKeepXor) km = ld<V>(kp + su * T);
          if constexpr (kMode != kNone) fm = ld<V>(fl + su * T);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            uint32_t x = walk::min3(a.x[j], b.x[j], c.x[j]);
            if constexpr (kMode == kKeepXor) x &= km.x[j];
            if constexpr (kMode != kNone) x ^= fm.x[j];
            v[u].x[j] = x;
          }
          o[u] = e.y >> 16;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u, o_ptr += row_step) {
        if (s + u * SS < W) {
          if (col) st<V>(o_ptr, v[u]);
          if (o[u] != kNoSlot) st<V>(slots + o[u] * T + w, v[u]);
        }
      }
    }
  }
  walk::wait_stages<0>();
}

template <int T, int V, int kMode>
int launch(const uint2* desc, const int* base_slot, int n_slots,
           uint32_t* state, const uint32_t* keep, const uint32_t* flip,
           int L, int W, int base, long long tw, cudaStream_t stream) {
  const long long smem =
      4LL * (kStages * (long long)stage_words(W, T, n_masks<kMode>()) +
             (long long)T * n_slots);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > optin) return (int)cudaErrorInvalidValue;
  auto kernel = netlist_exec_kernel<T, V, kMode>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (tw + T - 1) / T;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, kThreads, (size_t)smem, stream>>>(
      desc, base_slot, state, keep, flip, L, W, base, tw);
  return (int)cudaGetLastError();
}

// Four words a thread where every row and mask access can be 16 bytes: a
// tile of 4 words or more, tw a multiple of 4, 16-byte aligned tensors.
template <int T>
int launch_mode(int mode, bool vec4, const uint2* desc, const int* base_slot,
                int n_slots, uint32_t* state, const uint32_t* keep,
                const uint32_t* flip, int L, int W, int base, long long tw,
                cudaStream_t st) {
  if constexpr (T >= 4) {
    if (vec4) {
      if (mode == kNone)
        return launch<T, 4, kNone>(desc, base_slot, n_slots, state, keep,
                                   flip, L, W, base, tw, st);
      if (mode == kXor)
        return launch<T, 4, kXor>(desc, base_slot, n_slots, state, keep,
                                  flip, L, W, base, tw, st);
      return launch<T, 4, kKeepXor>(desc, base_slot, n_slots, state, keep,
                                    flip, L, W, base, tw, st);
    }
  }
  if (mode == kNone)
    return launch<T, 1, kNone>(desc, base_slot, n_slots, state, keep, flip,
                               L, W, base, tw, st);
  if (mode == kXor)
    return launch<T, 1, kXor>(desc, base_slot, n_slots, state, keep, flip,
                              L, W, base, tw, st);
  return launch<T, 1, kKeepXor>(desc, base_slot, n_slots, state, keep, flip,
                                L, W, base, tw, st);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// desc: (L, W) descriptors of the plan (uint16 slots a, b, c, out);
// base_slot: (base,) slot of each row below base or -1; n_slots and tile
// (trial words a CTA: 32, 16, 8, 4, 2 or 1) from the plan.
extern "C" int netlist_exec(const void* desc, const int* base_slot,
                            int n_slots, int tile, uint32_t* state,
                            const uint32_t* keep, const uint32_t* flip,
                            int L, int W, int base, long long tw, int mode,
                            void* stream) {
  if (L <= 0 || tw <= 0) return 0;
  if (W <= 0 || base < 0 || n_slots < 0 || n_slots > (int)kNoSlot ||
      mode < kNone || mode > kKeepXor || (mode != kNone && flip == nullptr) ||
      (mode == kKeepXor && keep == nullptr))
    return (int)cudaErrorInvalidValue;
  const uint2* d = static_cast<const uint2*>(desc);
  const bool vec4 = tw % 4 == 0 && aligned16(state) &&
                    (keep == nullptr || aligned16(keep)) &&
                    (flip == nullptr || aligned16(flip));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 32:
      return launch_mode<32>(mode, vec4, d, base_slot, n_slots, state, keep,
                             flip, L, W, base, tw, st);
    case 16:
      return launch_mode<16>(mode, vec4, d, base_slot, n_slots, state, keep,
                             flip, L, W, base, tw, st);
    case 8:
      return launch_mode<8>(mode, vec4, d, base_slot, n_slots, state, keep,
                            flip, L, W, base, tw, st);
    case 4:
      return launch_mode<4>(mode, vec4, d, base_slot, n_slots, state, keep,
                            flip, L, W, base, tw, st);
    case 2:
      return launch_mode<2>(mode, vec4, d, base_slot, n_slots, state, keep,
                            flip, L, W, base, tw, st);
    case 1:
      return launch_mode<1>(mode, vec4, d, base_slot, n_slots, state, keep,
                            flip, L, W, base, tw, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
