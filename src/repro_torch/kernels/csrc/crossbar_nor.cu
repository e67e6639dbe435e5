// Levelized Minority3 netlist interpreter over trial-packed words, with the
// live wire versions in shared memory.
//
// Replaces the TPU kernel `netlist_kernel` of
// src/repro/kernels/crossbar_nor/kernel.py:40 (body `_kernel`): gate g of
// the (G, 4) list (in1, in2, in3, out) writes ~maj(w[in1], w[in2], w[in3])
// into wire `out` of a (tw, n_wires) state of 32-bit words (32 trials per
// word), strictly in gate order, fault-free; the result is the whole final
// state, written here to `out` (`in` is not written).
//
// Design: the TPU kernel walks the list one gate at a time over a tile's
// whole state in VMEM.  Gate order is a dependence order only: the 32-bit
// multiplier's 13,792 gates are 306 levels deep.  A host plan
// (kernels/crossbar_nor/plan.py) renames every write to a new version, so a
// list that rewrites wires holds no write-after-read or write-after-write
// hazard; levels the versions (320 levels of W = 128 for that multiplier);
// gives every version that a later level reads a shared-memory slot for its
// live span (netlist_exec's interval colouring: a slot is reused only after
// its last read); and schedules each wire's final version to be flushed to
// `out` with the rest of its group of 32 consecutive wires, one level after
// the group's last write, so a warp's stores cover consecutive wires of one
// trial word (a level's own writes spread over up to 11,000 wires: stored
// at their level, a warp's 32 words fall in about 16 sectors).  A
// descriptor (16 bytes) holds a gate and a flush.
//
// A CTA owns T trial words (a slot row is T words) for all L levels: it
// loads the version 0 of every wire read before written into its slot,
// copies the wires never written from `in` to `out`, then walks the levels
// with one barrier each.  A thread takes V words of two descriptors of each
// level (warps on consecutive descriptors, the chunk of V words fixed per
// thread, so its `out` rows are computed once): it reads the three inputs
// and the flushed version from their slots, stores Min3 to the output slot
// if a later level reads it, and the flushed words to `out`.  The
// descriptors stream through a ring of kStages levels by cp.async, kStages
// - 1 levels ahead (level_walk.cuh, shared with netlist_exec.cu), and a
// thread loads its next level's descriptors into registers while the
// current level's gathers run.  Nothing but final versions and
// never-written wires reaches device memory.
//
// Bound: the state read once and written once (23.9 MB each for the 32-bit
// multiplier at 13,792 trials: 0.0143 ms at 3.35 TB/s).  The walk is a
// chain of L dependent levels, each a shared-memory round trip and a
// barrier on few warps, so latency a level, not bytes, bounds it.
#include "level_walk.cuh"

namespace {

using walk::kNoSlot;
using walk::ld;
using walk::st;
using walk::Vec;

constexpr int kStages = 6;     // ring levels (plan.STAGES)
constexpr int kGroup = 128;    // threads on one chunk of a level's gates
constexpr int kMaxGates = 2;   // descriptors a thread takes a level
                               // (plan.MAX_WIDTH / kGroup)

// Words a thread moves (V) at a T-word tile, and the CTA's threads: kGroup
// on each of the T / V chunks of a slot row.
__host__ __device__ constexpr int words_a_thread(int T) {
  return T < 4 ? T : 4;
}
template <int T>
__host__ __device__ constexpr int threads() {
  return kGroup * (T / words_a_thread(T));
}

// Stage this thread's descriptors of a level, src[0] and src[kThreads]
// (those below W, the rest of the level's by the other threads), into the
// ring stage dst, as one cp.async group (an empty group past the last
// level keeps one group a level).
template <int kThreads>
__device__ __forceinline__ void stage_level(int4* dst, const int4* src,
                                            bool live, int tid, int W) {
  if (live)
#pragma unroll
    for (int j = 0; j < kMaxGates; ++j)
      if (tid + j * kThreads < W)
        walk::cp_async<4>(reinterpret_cast<uint32_t*>(dst + j * kThreads),
                          src + j * kThreads);
  walk::commit_stage();
}

// This thread's descriptors of a level: s0 and s0 + kGroup (below W).
__device__ __forceinline__ void load_gates(int4 (&e)[kMaxGates],
                                           const int4* stage, int s0, int W) {
#pragma unroll
  for (int k = 0; k < kMaxGates; ++k)
    if (s0 + k * kGroup < W) e[k] = stage[s0 + k * kGroup];
}

// gd: (L, W) descriptors {a | b << 16, c | out << 16, flush wire or -1,
// flush slot} of 16-bit slots (W <= kMaxGates * kGroup); base: (2, n_base)
// wires read before written and their slots; copy_wire: (n_copy,) wires
// never written.  Warp w takes words cw .. cw+V-1 of the tile (cw = V * (w
// mod C)) of descriptors s0 = (w / C) * 32 + lane and s0 + kGroup of every
// level.
template <int T>
__global__ void __launch_bounds__(threads<T>())
    crossbar_nor_kernel(const int4* __restrict__ gd, int L, int W,
                        const int* __restrict__ base, int n_base,
                        const int* __restrict__ copy_wire, int n_copy,
                        const uint32_t* __restrict__ in,
                        uint32_t* __restrict__ out, long long tw,
                        int n_wires) {
  constexpr int V = words_a_thread(T);
  constexpr int C = T / V;
  constexpr int kThreads = threads<T>();
  extern __shared__ __align__(16) uint32_t smem[];
  int4* ring = reinterpret_cast<int4*>(smem);
  uint32_t* slots = smem + kStages * 4 * W;
  const long long t0 = (long long)blockIdx.x * T;
  const int n_words = (int)(tw - t0 < T ? tw - t0 : T);
  const int tid = threadIdx.x;
  const int4* src = gd + tid;   // this thread's descriptors to stage next
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k, src += W)
    stage_level<kThreads>(ring + k * W + tid, src, k < L, tid, W);
  // version 0 of the wires read before written; the wires never written:
  // lanes on consecutive wires of one trial word
  for (int i = tid; i < n_base * T; i += kThreads) {
    const int b = i % n_base, w = i / n_base;
    if (w < n_words)
      slots[base[n_base + b] * T + w] = in[(t0 + w) * n_wires + base[b]];
  }
  for (int i = tid; i < n_copy * T; i += kThreads) {
    const int k = i % n_copy, w = i / n_copy;
    if (w < n_words) {
      const long long a = (t0 + w) * n_wires + copy_wire[k];
      out[a] = in[a];
    }
  }
  const int warp = tid / 32;
  const int cw = warp % C * V;
  const int s0 = warp / C * 32 + tid % 32;
  uint32_t* orow[V];                           // this thread's `out` rows
#pragma unroll
  for (int j = 0; j < V; ++j)
    orow[j] = cw + j < n_words ? out + (t0 + cw + j) * n_wires : nullptr;
  uint32_t* const my = slots + cw;            // slot k's words: my[k * T ...]
  int4 e[kMaxGates], en[kMaxGates];
  // ring stages of levels l + 1 (read) and l + kStages - 1 (refilled)
  int rd = 1, wr = kStages - 1;
  // levels 0 and 1 have landed; the base rows are in
  walk::wait_stages<kStages - 3>();
  __syncthreads();
  load_gates(e, ring, s0, W);
  for (int l = 0; l < L; ++l) {
    // the next level's descriptors, read while this level's gathers run
    if (l + 1 < L) load_gates(en, ring + rd * W, s0, W);
    Vec<V> v[kMaxGates], f[kMaxGates];
    // every read of the level comes before any of its slot writes (the
    // plan keeps them in distinct slots)
#pragma unroll
    for (int k = 0; k < kMaxGates; ++k) {
      if (s0 + k * kGroup < W) {
        const uint32_t x = e[k].x, y = e[k].y;
        const Vec<V> a = ld<V>(my + (x & 0xFFFFu) * T);
        const Vec<V> b = ld<V>(my + (x >> 16) * T);
        const Vec<V> c = ld<V>(my + (y & 0xFFFFu) * T);
        f[k] = ld<V>(my + e[k].w * T);
#pragma unroll
        for (int j = 0; j < V; ++j)
          v[k].x[j] = walk::min3(a.x[j], b.x[j], c.x[j]);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxGates; ++k) {
      if (s0 + k * kGroup < W) {
        const uint32_t o = (uint32_t)e[k].y >> 16;
        if (o != kNoSlot) st<V>(my + o * T, v[k]);
        if (e[k].z >= 0)
#pragma unroll
          for (int j = 0; j < V; ++j)
            if (orow[j]) orow[j][e[k].z] = f[k].x[j];
      }
    }
    // refill the stage of level l - 1, read before the last barrier
    stage_level<kThreads>(ring + wr * W + tid, src, l + kStages - 1 < L, tid,
                          W);
    src += W;
    rd = rd + 1 == kStages ? 0 : rd + 1;
    wr = wr + 1 == kStages ? 0 : wr + 1;
    // level l's slot writes are visible and level l + 2's stage has
    // landed for every thread
    walk::wait_stages<kStages - 3>();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxGates; ++k) e[k] = en[k];
  }
  walk::wait_stages<0>();
}

template <int T>
int launch(const int4* gd, int L, int W, const int* base, int n_base,
           const int* copy_wire, int n_copy, int n_slots, const uint32_t* in,
           uint32_t* out, long long tw, int n_wires, cudaStream_t stream) {
  const long long smem = 4LL * (kStages * 4LL * W + (long long)T * n_slots);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > optin) return (int)cudaErrorInvalidValue;
  auto kernel = crossbar_nor_kernel<T>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (tw + T - 1) / T;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, threads<T>(), (size_t)smem, stream>>>(
      gd, L, W, base, n_base, copy_wire, n_copy, in, out, tw, n_wires);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan's arrays (kernels/crossbar_nor/plan.py): gd (L, W) 16-byte gate
// descriptors, base (2, n_base) int32, copy_wire (n_copy,) int32, n_slots
// and tile (trial words a CTA: 32, 16, 8, 4, 2 or 1); in and out the
// (tw, n_wires) states.
extern "C" int crossbar_nor(const void* gd, int L, int W, const int* base,
                            int n_base, const int* copy_wire, int n_copy,
                            int n_slots, int tile, const uint32_t* in,
                            uint32_t* out, long long tw, int n_wires,
                            void* stream) {
  if (tw <= 0 || n_wires <= 0) return 0;
  if (L < 0 || W <= 0 || W > kMaxGates * kGroup || n_base < 0 ||
      n_copy < 0 || n_slots < 0 || n_slots > (int)kNoSlot)
    return (int)cudaErrorInvalidValue;
  const int4* d = static_cast<const int4*>(gd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 32:
      return launch<32>(d, L, W, base, n_base, copy_wire, n_copy, n_slots,
                        in, out, tw, n_wires, st);
    case 16:
      return launch<16>(d, L, W, base, n_base, copy_wire, n_copy, n_slots,
                        in, out, tw, n_wires, st);
    case 8:
      return launch<8>(d, L, W, base, n_base, copy_wire, n_copy, n_slots,
                       in, out, tw, n_wires, st);
    case 4:
      return launch<4>(d, L, W, base, n_base, copy_wire, n_copy, n_slots,
                       in, out, tw, n_wires, st);
    case 2:
      return launch<2>(d, L, W, base, n_base, copy_wire, n_copy, n_slots,
                       in, out, tw, n_wires, st);
    case 1:
      return launch<1>(d, L, W, base, n_base, copy_wire, n_copy, n_slots,
                       in, out, tw, n_wires, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
