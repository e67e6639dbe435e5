// Per-bit 2-of-3 majority vote: out = (a & b) | (b & c) | (a & c).
//
// Replaces the TPU kernel `vote_kernel` of
// src/repro/kernels/tmr_vote/kernel.py:24 (body `_kernel`), which voted
// (M, N) uint32 tiles.  Voting bits does not depend on layout, so this
// kernel votes the raw bytes of three same-size buffers: int32 tokens,
// bf16 KV caches and fp32 weights vote bit-identically to the reference's
// word view.
//
// Design: grid-stride loop over `width`-byte elements (16-byte uint4 loads
// when all four pointers are 16-byte aligned, else 4 or 1 bytes, chosen by
// the host); the tail shorter than one element is voted byte by byte inside
// the same launch.  Bound: device-memory bytes -- three buffers read, one
// written.
#include "common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T maj3(T a, T b, T c) {
  return (a & b) | (b & c) | (a & c);
}

__device__ __forceinline__ uint4 maj3(uint4 a, uint4 b, uint4 c) {
  return make_uint4(maj3(a.x, b.x, c.x), maj3(a.y, b.y, c.y),
                    maj3(a.z, b.z, c.z), maj3(a.w, b.w, c.w));
}

template <typename T>
__device__ void vote_elems(const uint8_t* a, const uint8_t* b,
                           const uint8_t* c, uint8_t* out, long long n,
                           long long tid, long long stride) {
  const T* pa = reinterpret_cast<const T*>(a);
  const T* pb = reinterpret_cast<const T*>(b);
  const T* pc = reinterpret_cast<const T*>(c);
  T* po = reinterpret_cast<T*>(out);
  for (long long i = tid; i < n; i += stride) po[i] = maj3(pa[i], pb[i], pc[i]);
}

// `out` may alias an input (vote in place): no __restrict__.
__global__ void vote_kernel(const uint8_t* a, const uint8_t* b,
                            const uint8_t* c, uint8_t* out,
                            long long n_bytes, int width) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n = n_bytes / width;
  if (width == 16) {
    vote_elems<uint4>(a, b, c, out, n, tid, stride);
  } else if (width == 4) {
    vote_elems<uint32_t>(a, b, c, out, n, tid, stride);
  } else {
    vote_elems<uint8_t>(a, b, c, out, n, tid, stride);
  }
  for (long long i = n * width + tid; i < n_bytes; i += stride)
    out[i] = maj3(a[i], b[i], c[i]);
}

}  // namespace

extern "C" int tmr_vote(const void* a, const void* b, const void* c,
                        void* out, long long n_bytes, int width,
                        void* stream) {
  if (width != 16 && width != 4 && width != 1)
    return (int)cudaErrorInvalidValue;
  if (n_bytes == 0) return 0;
  const int threads = 256;
  const long long need = (n_bytes / width + threads - 1) / threads + 1;
  const long long cap = (long long)repro_sm_count() * 16;
  const int grid = (int)(need < cap ? need : cap);
  vote_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<const uint8_t*>(c), static_cast<uint8_t*>(out), n_bytes,
      width);
  return (int)cudaGetLastError();
}
