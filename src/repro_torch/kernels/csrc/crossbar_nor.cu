// Gate-serial Minority3 netlist interpreter over trial-packed words.
//
// Replaces the TPU kernel `netlist_kernel` of
// src/repro/kernels/crossbar_nor/kernel.py:40 (body `_kernel`): gate g of
// the (G, 4) list (in1, in2, in3, out) writes ~maj(w[in1], w[in2], w[in3])
// into wire `out` of a (tw, n_wires) state of 32-bit words (32 trials per
// word), strictly in gate order, fault-free.
//
// Design: the only parallel axis is the trial word.  One block owns one
// word: its threads copy the word's n_wires-wire row into shared memory
// (55.4 KB for the 32-bit multiplier; above 48 KB by opt-in), one thread
// walks the gate list there, and the threads copy the row out.  The gate
// rows are read as one 16-byte load each, the same list for every block
// (L1/L2 hits).  Each gate's loads may depend on the previous gate's store,
// so the walk is a chain of dependent shared-memory accesses: the kernel
// is bound by that latency (about G x 40 cycles per block), far above its
// byte bound (the state read once and written once).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
crossbar_nor_kernel(const int4* __restrict__ gates, int G,
                    const uint32_t* __restrict__ in, uint32_t* out,
                    int n_wires) {
  extern __shared__ uint32_t w[];
  const long long row = (long long)blockIdx.x * n_wires;
  for (int i = threadIdx.x; i < n_wires; i += kThreads) w[i] = in[row + i];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int g = 0; g < G; ++g) {
      const int4 q = __ldg(gates + g);
      const uint32_t a = w[q.x], b = w[q.y], c = w[q.z];
      w[q.w] = ~((a & b) | (b & c) | (a & c));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_wires; i += kThreads) out[row + i] = w[i];
}

}  // namespace

// Largest n_wires one block can hold (its row in shared memory).
extern "C" int crossbar_nor_max_wires() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes / (int)sizeof(uint32_t);
}

extern "C" int crossbar_nor(const int* gates, int G, const uint32_t* in,
                            uint32_t* out, long long tw, int n_wires,
                            void* stream) {
  if (tw <= 0 || n_wires <= 0) return 0;
  if (G < 0 || tw > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_wires * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      crossbar_nor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  crossbar_nor_kernel<<<(unsigned)tw, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(gates), G, in, out, n_wires);
  return (int)cudaGetLastError();
}
