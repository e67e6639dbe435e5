// The level walk of the port's levelized netlist kernels: netlist_exec.cu
// and crossbar_nor.cu.
//
// Both keep a CTA's live wire state in shared-memory slots planned on the
// host (kernels/netlist_exec/plan.py), stream each level's descriptors into
// a ring of shared-memory stages by cp.async, a few levels ahead, and order
// the levels by one barrier each: a slot is reused only after its last
// read.  A slot row holds T consecutive trial words; a thread moves V of
// them (V = 1, or 4 as one 16-byte access).
#pragma once

#include "common.cuh"

namespace walk {

// descriptor entry of no slot (plan.NO_SLOT)
constexpr uint32_t kNoSlot = 0xFFFFu;

// V consecutive words of a row, moved as one access (V = 1, 2 or 4).
template <int V>
struct Vec;
template <>
struct Vec<1> {
  uint32_t x[1];
};
template <>
struct alignas(8) Vec<2> {
  uint32_t x[2];
};
template <>
struct alignas(16) Vec<4> {
  uint32_t x[4];
};

template <int V>
__device__ __forceinline__ Vec<V> ld(const uint32_t* p) {
  return *reinterpret_cast<const Vec<V>*>(p);
}

template <int V>
__device__ __forceinline__ void st(uint32_t* p, const Vec<V>& v) {
  *reinterpret_cast<Vec<V>*>(p) = v;
}

// Min3 of three words: ~maj(a, b, c)
__device__ __forceinline__ uint32_t min3(uint32_t a, uint32_t b, uint32_t c) {
  return ~((a & b) | (b & c) | (a & c));
}

// cp.async of V words (4 or 16 bytes; both addresses aligned to that).
template <int V>
__device__ __forceinline__ void cp_async(uint32_t* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

// cp.async of one 8-byte descriptor (four 16-bit slots).
__device__ __forceinline__ void cp_async_desc(uint2* dst, const uint2* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Close this thread's cp.async copies of one ring stage as a group (an
// empty group past the last level keeps one group a level).
__device__ __forceinline__ void commit_stage() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's stage groups are in flight.
template <int N>
__device__ __forceinline__ void wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace walk
