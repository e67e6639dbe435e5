// Forward flash attention with online softmax (causal, sliding window, GQA).
//
// Replaces the TPU kernel `flash_attention_kernel` of
// src/repro/kernels/flash_attention/kernel.py:84 (body `_kernel`).  The TPU
// grid (B, H, nq, nk) runs in order and carries the fp32 (acc, m, l)
// scratch across the sequential kv axis; GPU blocks run in no order, so
// here one CTA owns one (b, h, q-tile) and loops over the kv tiles itself.
// q, k, v and o are addressed through (b, s, h) strides, so the model's
// (B, S, H, hd) layout needs no transpose; the GQA kv head of query head h
// is h / (H / KV); masked scores are -1e30 and the final 1/l clamps l at
// 1e-30, as in the reference.
//
// bfloat16, the served model's compute type (flash_wgmma_kernel): one
// warpgroup of 128 threads owns a 64-row query tile, so a (b, h) of S=256
// is 4 CTAs (the server's admission prefill at B=1, H=32 is 128 CTAs, the
// one-shot B=4 is 512); the grid hands out the last query tiles, which see
// the most kv tiles, first.  S = Q K^T is `wgmma` m64n64k16 (bf16 in, fp32
// accumulate) over head_dim in k-steps of 16, both operands in shared
// memory; P is rounded to bf16 in registers, where the S accumulator's
// layout is already the A-fragment layout, and O += P V is `wgmma`
// m64nDk16 with P from registers and V from shared memory (D = head_dim
// padded to 32, 64, 96 or 128; at 256, two n128 halves, and Q plus the
// two K/V stages take 160 KB of shared memory).  The row max and sum of
// the online softmax stay fp32 in registers (two rows a thread, four
// threads a row).  Q is staged once; K/V tiles of 64 keys go through a
// two-stage ring, loaded with 16-byte cp.async (the strided rows do not
// fit one TMA box without a descriptor per call), so tile i+1 is in flight
// while tile i is computed.
// Operands sit in shared memory in the wgmma core-matrix layout without
// swizzle: 8 rows x 16 bytes per 128-byte core matrix, one cp.async chunk a
// core-matrix row.  Only tiles that cross the causal diagonal, the window
// edge or the end of the keys are masked element by element; tiles no row
// can see are skipped.  head_dim a multiple of 8 and 16-byte aligned rows
// (the wrapper checks).
//
// float32 (flash_fwd_kernel, tests and the chip checks): CUDA-core FMAs, a
// CTA of 8 warps holds 16 query rows in dynamic shared memory as fp32
// (head_dim padded to 128 or 256: 40 or 80 KB), one lane per key of a
// 32-key tile, the P.V product by shuffles.
//
// Bound: causal prefill at B=4, H=32, S=256, hd=96 does 4*B*H*hd*S(S+1)/2
// = 1.6 GFLOP on 25 MB of bf16 q/k/v/o, 1.6 us of bf16 tensor-core time
// against 7.5 us of device-memory bytes: bound by bytes.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int HD_MAX = 256;
constexpr int BQ = 16;
constexpr int BK = 32;
constexpr int NWARPS = 8;
constexpr int RPW = BQ / NWARPS;   // query rows per warp
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int HDM>
__global__ void __launch_bounds__(NWARPS * 32)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H,
                     int KV, int Sq, int Sk, int hd, Strides st, float scale,
                     int causal, int window) {
  // q rows (BQ x HDM), k rows (BK x HDM + 1: the padded row keeps a
  // lane's column reads off one bank), v rows (BK x HDM), all fp32
  extern __shared__ __align__(16) float fp32_smem[];
  float* qs = fp32_smem;
  float* ks = qs + BQ * HDM;
  float* vs = ks + BK * (HDM + 1);
  constexpr int DPL = HDM / 32;  // output dims per lane

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int idx = threadIdx.x; idx < BQ * HDM; idx += blockDim.x) {
    const int r = idx / HDM, d = idx % HDM, qi = q0 + r;
    float val = 0.f;
    if (qi < Sq && d < hd)
      val = to_f(q[b * st.qb + qi * st.qs + h * st.qh + d]) * scale;
    qs[r * HDM + d] = val;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }

  // kv range any row of this tile can see; whole masked tiles are skipped
  int k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + BQ);
  int k_lo = 0;
  if (window) k_lo = max(0, q0 - window + 1);
  k_lo = (k_lo / BK) * BK;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // previous tile fully consumed (and q tile written)
    for (int idx = threadIdx.x; idx < BK * HDM; idx += blockDim.x) {
      const int j = idx / HDM, d = idx % HDM, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < Sk && d < hd) {
        kv = to_f(k[b * st.kb + kj * st.ks + kvh * st.kh + d]);
        vv = to_f(v[b * st.vb + kj * st.vs + kvh * st.vh + d]);
      }
      ks[j * (HDM + 1) + d] = kv;
      vs[j * HDM + d] = vv;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp * RPW + r;
      const int qi = q0 + row;
      if (qi >= Sq) continue;  // warp-uniform
      const int kj = k0 + lane;
      float s = 0.f;
      for (int d = 0; d < hd; ++d)
        s = fmaf(qs[row * HDM + d], ks[lane * (HDM + 1) + d], s);
      bool keep = true;
      if (causal) keep &= qi >= kj;
      if (window) keep &= kj > qi - window;
      const bool valid = kj < Sk;
      s = (keep && valid) ? s : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max_all(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum_all(p);
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] *= corr;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int e = 0; e < DPL; ++e)
          acc[r][e] = fmaf(pj, vs[j * HDM + lane + 32 * e], acc[r][e]);
      }
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qi = q0 + warp * RPW + r;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < hd)
        o[b * st.ob + qi * st.os + h * st.oh + d] = from_f<T>(acc[r][e] * inv);
    }
  }
}

template <int HDM>
int launch_fp32(const float* q, const float* k, const float* v, float* o,
                int B, int H, int KV, int Sq, int Sk, int hd,
                const Strides& st, float scale, int causal, int window,
                cudaStream_t s) {
  auto kernel = flash_fwd_kernel<float, HDM>;
  const int smem = (BQ * HDM + BK * (HDM + 1) + BK * HDM) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, NWARPS * 32, smem, s>>>(q, k, v, o, H, KV, Sq, Sk, hd, st,
                                         scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace


namespace wg {

constexpr int BQ = 64;        // query rows per CTA (one wgmma M)
constexpr int BK = 64;        // keys per kv tile (the QK^T wgmma N); a
                              // 128-key tile ran 26% slower on an H100
                              // at B=4, S=256, H=32, hd=96
constexpr int THREADS = 128;  // one warpgroup
constexpr float NEG_INF = -1e30f;

// Element offset of (row r, column c) in an R-row tile: 8 x 8 core
// matrices of 128 contiguous bytes, R / 8 row groups per column group.
template <int R>
__device__ __forceinline__ int tile_offset(int r, int c) {
  return ((c >> 3) * (R / 8) + (r >> 3)) * 64 + (r & 7) * 8 + (c & 7);
}

// wgmma shared-memory descriptors of that layout take a leading byte
// offset (between core matrices along K) and a stride byte offset (along
// M/N).  Row groups lie 128 bytes apart, column groups R * 16.  Q and K
// are K-major (head_dim is K, a column); V is MN-major (head_dim is N, a
// column; keys are K, rows).
constexpr uint32_t ROW_GROUP_BYTES = 128;
__host__ __device__ constexpr uint32_t col_group_bytes(int R) {
  return R * 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);  // layout 0: no swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving register accesses across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64, fp32) += A (64 x 16, bf16, K-major, shared memory) *
// B (16 x 64, bf16, K-major, shared memory)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D (64 x 32, fp32) += A (64 x 16, bf16, registers) *
// B (16 x 32, bf16, MN-major, shared memory)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16, registers) *
// B (16 x 64, bf16, MN-major, shared memory)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 96, fp32) += A (64 x 16, bf16, registers) *
// B (16 x 96, bf16, MN-major, shared memory)
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
      ", {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16, registers) *
// B (16 x 128, bf16, MN-major, shared memory)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// O += P V over head_dim HDP, V's 16 keys of this k-step at tile v (MN-
// major).  At 256, two n128 halves: the second half's B starts 16 column
// groups on, and its accumulators are o's upper 64 (the D layout keeps
// columns 8j.. in registers 4j..).
template <int HDP>
__device__ __forceinline__ void wgmma_pv(float (&d)[HDP / 2],
                                         const uint32_t (&a)[4],
                                         const __nv_bfloat16* v) {
  const uint64_t desc = make_desc(v, ROW_GROUP_BYTES, col_group_bytes(BK));
  if constexpr (HDP == 32) wgmma_rs_n32(d, a, desc);
  if constexpr (HDP == 64) wgmma_rs_n64(d, a, desc);
  if constexpr (HDP == 96) wgmma_rs_n96(d, a, desc);
  if constexpr (HDP == 128) wgmma_rs_n128(d, a, desc);
  if constexpr (HDP == 256) {
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(d), a, desc);
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(d + 64), a,
                  make_desc(v + 16 * BK * 8, ROW_GROUP_BYTES,
                            col_group_bytes(BK)));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [s0, s0 + R) of one head's (S, hd) slice, rows row_stride
// elements apart, into an R-row tile, 16 bytes a cp.async; rows past S and
// columns past hd are zero-filled.  A warp's 32 copies cover 8 rows x 4
// chunks: 64 contiguous bytes a row in device memory, and 512 bytes in
// four bank-conflict-free wavefronts in shared memory.
template <int HDP, int R>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* tile,
                                           const __nv_bfloat16* src,
                                           long long row_stride, int s0,
                                           int S, int hd) {
  constexpr int CH = HDP / 8;  // 16-byte chunks a row
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = threadIdx.x >> 5; g < (R / 8) * (CH / 4); g += THREADS / 32) {
    const int r = (g / (CH / 4)) * 8 + (lane >> 2);
    const int c = ((g % (CH / 4)) * 4 + (lane & 3)) * 8;
    const bool ok = s0 + r < S && c < hd;
    const __nv_bfloat16* from = ok ? src + (s0 + r) * row_stride + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(tile + tile_offset<R>(r, c))),
                 "l"(from), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

template <int HDP>
__global__ void __launch_bounds__(THREADS)
    flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int H, int KV, int Sq,
                       int Sk, int hd, Strides st, float scale_log2,
                       int causal, int window) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * HDP;       // 2 stages of BK x HDP
  __nv_bfloat16* sV = sK + 2 * BK * HDP;   // 2 stages of BK x HDP

  // grid (B*H, q tiles): the causal tiles with the most kv tiles, the
  // last query tiles, go to the card first
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* kh = k + b * st.kb + kvh * st.kh;
  const __nv_bfloat16* vh = v + b * st.vb + kvh * st.vh;

  // kv range any row of this tile can see; whole masked tiles are skipped
  int k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + BQ);
  int k_lo = 0;
  if (window) k_lo = max(0, q0 - window + 1);
  k_lo = (k_lo / BK) * BK;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  stage_rows<HDP, BQ>(sQ, q + b * st.qb + h * st.qh, st.qs, q0, Sq, hd);
  if (n_tiles > 0) {
    stage_rows<HDP, BK>(sK, kh, st.ks, k_lo, Sk, hd);
    stage_rows<HDP, BK>(sV, vh, st.vs, k_lo, Sk, hd);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // this thread's rows (h = 0, 1) of the 64-row tile, and its columns
  // 8j + 2(lane % 4) + e of every accumulator (the wgmma D layout)
  const int row0 = warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  float o_acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o_acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int k0 = k_lo + it * BK;
    if (it + 1 < n_tiles) {  // the other stage was freed by the last barrier
      stage_rows<HDP, BK>(sK + (stage ^ 1) * BK * HDP, kh, st.ks, k0 + BK,
                          Sk, hd);
      stage_rows<HDP, BK>(sV + (stage ^ 1) * BK * HDP, vh, st.vs, k0 + BK,
                          Sk, hd);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    // this thread's copies of tile it have landed; make them visible to
    // the tensor cores (async proxy), then wait for every thread's
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const __nv_bfloat16* tK = sK + stage * BK * HDP;
    const __nv_bfloat16* tV = sV + stage * BK * HDP;

    // S = Q K^T (fp32)
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      wgmma_ss_n64(s,
                   make_desc(sQ + kk * BQ * 16, col_group_bytes(BQ),
                             ROW_GROUP_BYTES),
                   make_desc(tK + kk * BK * 16, col_group_bytes(BK),
                             ROW_GROUP_BYTES));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax in log2 units: x = s * scale * log2(e)
    const bool edge = (causal && k0 + BK - 1 > q0) ||
                      (window && k0 <= q0 + BQ - 1 - window) || k0 + BK > Sk;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = s[i] * scale_log2;
      if (edge) {
        const int qi = q0 + row0 + 8 * ((i >> 1) & 1);
        const int kj = k0 + 8 * (i >> 2) + col0 + (i & 1);
        bool keep = kj < Sk;
        if (causal) keep &= qi >= kj;
        if (window) keep &= kj > qi - window;
        x = keep ? x : NEG_INF;
      }
      s[i] = x;
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = exp2f(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[4 * j + 2 * r + e] - mx);
          s[4 * j + 2 * r + e] = p;
          sum += p;
        }
      }
      l[r] = l[r] * corr[r] + sum;  // this thread's part of the row sum
    }
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      o_acc[4 * j + 0] *= corr[0];
      o_acc[4 * j + 1] *= corr[0];
      o_acc[4 * j + 2] *= corr[1];
      o_acc[4 * j + 3] *= corr[1];
    }

    // O += P V, P rounded to bf16 as the A fragments of 4 k-steps of 16
    uint32_t a[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    fence_regs(o_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv<HDP>(o_acc, a[kk], tV + kk * 128);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o_acc);
    __syncthreads();  // every thread is done with this stage
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int qi = q0 + row0 + 8 * r;
    if (qi >= Sq) continue;
    __nv_bfloat16* orow = o + b * st.ob + qi * st.os + h * st.oh;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int c = 8 * j + col0;
      if (c < hd)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
            o_acc[4 * j + 2 * r] * inv, o_acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <int HDP>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int H, int KV, int Sq, int Sk, int hd, const Strides& st,
                 float scale, int causal, int window, cudaStream_t s) {
  auto kernel = flash_wgmma_kernel<HDP>;
  const int smem = (BQ + 4 * BK) * HDP * 2;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, KV, Sq, Sk, hd, st, scale * 1.4426950408889634f, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace wg

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides
// (q, k, v, o) x (batch, sequence, head); the head_dim stride must be 1.
// bfloat16 also needs head_dim and every stride a multiple of 8 and
// 16-byte aligned pointers (rows are staged by 16-byte copies).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int H, int KV, int Sq, int Sk, int hd,
                                   const long long* strides, float scale,
                                   int causal, int window, void* stream) {
  if (hd < 1 || hd > HD_MAX || KV < 1 || H % KV || (long long)B * H > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  Strides st{strides[0], strides[1], strides[2],  strides[3],
             strides[4], strides[5], strides[6],  strides[7],
             strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(o);
    if (hd <= 128)
      return launch_fp32<128>(qf, kf, vf, of, B, H, KV, Sq, Sk, hd, st,
                              scale, causal, window, s);
    return launch_fp32<256>(qf, kf, vf, of, B, H, KV, Sq, Sk, hd, st, scale,
                            causal, window, s);
  }
  bool aligned = hd % 8 == 0;
  for (int i = 0; i < 12; ++i) aligned &= strides[i] % 8 == 0;
  aligned &= (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
              reinterpret_cast<uintptr_t>(v) |
              reinterpret_cast<uintptr_t>(o)) % 16 == 0;
  if (!aligned) return (int)cudaErrorInvalidValue;
  if (hd <= 32)
    return wg::launch_wgmma<32>(q, k, v, o, B, H, KV, Sq, Sk, hd, st, scale,
                                causal, window, s);
  if (hd <= 64)
    return wg::launch_wgmma<64>(q, k, v, o, B, H, KV, Sq, Sk, hd, st, scale,
                                causal, window, s);
  if (hd <= 96)
    return wg::launch_wgmma<96>(q, k, v, o, B, H, KV, Sq, Sk, hd, st, scale,
                                causal, window, s);
  if (hd <= 128)
    return wg::launch_wgmma<128>(q, k, v, o, B, H, KV, Sq, Sk, hd, st,
                                 scale, causal, window, s);
  return wg::launch_wgmma<256>(q, k, v, o, B, H, KV, Sq, Sk, hd, st, scale,
                               causal, window, s);
}
