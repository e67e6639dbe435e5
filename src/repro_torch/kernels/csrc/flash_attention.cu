// Forward flash attention with online softmax (causal, sliding window, GQA).
//
// Replaces the TPU kernel `flash_attention_kernel` of
// src/repro/kernels/flash_attention/kernel.py:84 (body `_kernel`).  The TPU
// grid (B, H, nq, nk) runs in order and carries the fp32 (acc, m, l)
// scratch across the sequential kv axis; GPU blocks run in no order, so
// here one CTA owns one (b, h, q-tile) and loops over the kv tiles itself.
//
// Design (simple first, no tensor cores): a CTA of 8 warps holds BQ = 16
// query rows, two per warp, pre-scaled into shared memory in fp32.  Each kv
// tile of BK = 32 keys is staged in shared memory as fp32 (K rows padded by
// one word so lane j reading key j is conflict-free).  For one row, lane j
// computes the score of key j; warp max / warp sum shuffles give the online
// softmax update; the P.V product broadcasts p_j by shuffle while each lane
// accumulates hd/32 output dims.  m, l and acc stay fp32 in registers, as
// in the TPU kernel; masked entries use the same -1e30 as the reference.
// Tiles no query row of the CTA can see (causal upper triangle, outside the
// window) are skipped.  head_dim up to 128 (phi3-mini: 96) is handled by
// zero padding in shared memory.  The GQA kv head of query head h is
// h / (H / KV).  q, k, v and o are addressed through (b, s, h) strides, so
// the model's (B, S, H, hd) layout needs no transpose.
//
// Bound: causal prefill at B=4, H=32, S=256, hd=96 does 4*B*H*hd*S(S+1)/2
// = 1.6 GFLOP on 25 MB of bf16 q/k/v/o; this CUDA-core kernel is bound by
// its fp32 FMA issue rate, far from the tensor-core bound.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int HD_MAX = 128;
constexpr int BQ = 16;
constexpr int BK = 32;
constexpr int NWARPS = 8;
constexpr int RPW = BQ / NWARPS;   // query rows per warp
constexpr int DPL = HD_MAX / 32;   // output dims per lane
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

template <typename T>
__global__ void __launch_bounds__(NWARPS * 32)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H,
                     int KV, int Sq, int Sk, int hd, Strides st, float scale,
                     int causal, int window) {
  __shared__ float qs[BQ][HD_MAX];
  __shared__ float ks[BK][HD_MAX + 1];
  __shared__ float vs[BK][HD_MAX];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int idx = threadIdx.x; idx < BQ * HD_MAX; idx += blockDim.x) {
    const int r = idx / HD_MAX, d = idx % HD_MAX, qi = q0 + r;
    float val = 0.f;
    if (qi < Sq && d < hd)
      val = to_f(q[b * st.qb + qi * st.qs + h * st.qh + d]) * scale;
    qs[r][d] = val;
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
    for (int idx = threadIdx.x; idx < BK * HD_MAX; idx += blockDim.x) {
      const int j = idx / HD_MAX, d = idx % HD_MAX, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < Sk && d < hd) {
        kv = to_f(k[b * st.kb + kj * st.ks + kvh * st.kh + d]);
        vv = to_f(v[b * st.vb + kj * st.vs + kvh * st.vh + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp * RPW + r;
      const int qi = q0 + row;
      if (qi >= Sq) continue;  // warp-uniform
      const int kj = k0 + lane;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qs[row][d], ks[lane][d], s);
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
          acc[r][e] = fmaf(pj, vs[j][lane + 32 * e], acc[r][e]);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides
// (q, k, v, o) x (batch, sequence, head); the head_dim stride must be 1.
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
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    flash_fwd_kernel<float><<<grid, NWARPS * 32, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), H, KV, Sq, Sk,
        hd, st, scale, causal, window);
  } else {
    flash_fwd_kernel<__nv_bfloat16><<<grid, NWARPS * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), H, KV, Sq, Sk, hd, st, scale, causal,
        window);
  }
  return (int)cudaGetLastError();
}
