// The diagonal-parity block code on the card, shared by the encode and
// scrub of csrc/diag_parity.cu and the fused inject+scrub of
// csrc/inject_scrub.cu: one parity body (the TPU kernels share
// `scrub_body` of src/repro/kernels/diag_parity/kernel.py the same way).
//
// A block is 32 consecutive 32-bit words; the slope-s parity word is
// XOR_i rotl32(w_i, s*i).  Encode and scrub walk staged tiles as a thread
// per block (staged_tiles.cuh).  The warp-per-block forms spent a 5-step
// shuffle butterfly and two modulos per family on every lane per block, so
// they were bound by instructions, not bytes.  Here thread t holds its
// block as a[i] = w_(i+r), r = 4t mod 32 (load_block).  Since
// s*(i+r) = s*i + s*r (mod 32), the parity word is rotl32(Y, s*r) with
// Y = XOR_i rotl32(a[i], s*i), which Horner's rule builds from i = 31 down
// as acc = rotl32(acc, s) ^ a[i]: one funnel shift by the slope and one XOR
// per word and family, one register per family (F is a template
// parameter, so no predicated-off family is issued).  The scrub's
// syndrome, one-hot test, location and classification run once per block
// in its thread.
#pragma once

#include "staged_tiles.cuh"

namespace diag {

using namespace tiles;

constexpr int MAXF = 8;  // parity families supported

struct Slopes {
  int s[MAXF];
};

// The F parity words of the block held in a (a[i] = w_((i + r) mod 32)):
// p[f] = XOR_i rotl32(w_i, s_f * i).  The one body of the encode and the
// scrub.
template <int F>
__device__ __forceinline__ void block_parity(const uint32_t (&a)[BLOCK],
                                             int r, const Slopes& sl,
                                             uint32_t (&p)[F]) {
  uint32_t acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0u;
#pragma unroll
  for (int i = BLOCK - 1; i >= 0; --i) {
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = rotl(acc[f], sl.s[f]) ^ a[i];
  }
#pragma unroll
  for (int f = 0; f < F; ++f) p[f] = rotl(acc[f], sl.s[f] * r);
}

// The scrub, with an optional XOR fault mask folded in front of the parity
// body (kInject).  parity: (n_pblocks, F), read at row b % n_pblocks
// (n_pblocks divides n_blocks: copies of one arena share one table).
// parity_out: nullptr to drop parity corrections, else written at row b --
// every row when out_all, only healed rows otherwise (in place when
// parity_out == parity).  A word is written only where it changes: the
// flagged bit of word i0, and with kInject every word the mask touched
// that the correction does not restore.  counts: corrected, parity_fixed,
// uncorrectable (+ injected first when kInject), per block.  F (2 to MAXF
// families) is a template parameter.
template <bool kInject, int F>
__global__ void __launch_bounds__(WARPS * 32)
    scrub_kernel(uint32_t* __restrict__ words,
                 const uint32_t* __restrict__ mask, long long n_blocks,
                 const uint32_t* parity, long long n_pblocks,
                 uint32_t* parity_out, int out_all, Slopes sl, int ia, int ib,
                 int* __restrict__ counts) {
  constexpr int NC = kInject ? 4 : 3;
  constexpr int C0 = kInject ? 1 : 0;  // index of `corrected` in counts
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int cta[NC];
  if (threadIdx.x < NC) cta[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  unsigned n[NC] = {};
  walk_tiles<kInject, F>(
      smem, words, mask, n_blocks, parity, n_pblocks,
      [&](long long b, const uint32_t* sw, const uint32_t* sm,
          const uint32_t (&par)[F]) {
        uint32_t a[BLOCK];
        const int r = load_block(sw, lane, a);
        uint32_t touched = 0u;
        if constexpr (kInject) {
          uint32_t m[BLOCK];
          load_block(sm, lane, m);
#pragma unroll
          for (int i = 0; i < BLOCK; ++i) {
            touched |= m[i];
            a[i] ^= m[i];  // the injection
          }
          if (touched) {
            for (int i = 0; i < BLOCK; ++i) n[0] += __popc(sm[i]);
          }
        }
        uint32_t syn[F];
        block_parity<F>(a, r, sl, syn);
        int hot[F];
        int n_nonzero = 0, ha = 0, hb = 0;
        bool all_onehot = true, all_le1 = true;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          syn[f] ^= par[f];
          const int pc = __popc(syn[f]);
          n_nonzero += pc > 0;
          all_onehot &= pc == 1;
          all_le1 &= pc <= 1;
          hot[f] = __ffs(syn[f]) - 1;  // the one-hot bit (used if one-hot)
          if (f == ia) ha = hot[f];
          if (f == ib) hb = hot[f];
        }
        // locate: slopes 1 and 2 invert the diagonal system
        const int i0 = (hb - ha) & (BLOCK - 1);
        const int j0 = (ha - i0) & (BLOCK - 1);
        bool consistent = true;
#pragma unroll
        for (int f = 0; f < F; ++f)
          consistent &= hot[f] == ((j0 + sl.s[f] * i0) & (BLOCK - 1));
        const bool data_err = n_nonzero == F && all_onehot && consistent;
        const bool parity_err = n_nonzero == 1 && all_le1;
        const bool uncorrectable = n_nonzero > 0 && !data_err && !parity_err;
        uint32_t* out = words + b * BLOCK;
        if (kInject && touched) {
          for (int i = 0; i < BLOCK; ++i) {
            const uint32_t m = sm[i];
            const uint32_t fix = data_err && i == i0 ? 1u << j0 : 0u;
            if (m ^ fix) out[i] = sw[i] ^ m ^ fix;
          }
        } else if (data_err) {
          out[i0] = sw[i0] ^ (1u << j0);
        }
        if (parity_out != nullptr && (out_all || parity_err)) {
#pragma unroll
          for (int f = 0; f < F; ++f)
            parity_out[b * F + f] = par[f] ^ (parity_err ? syn[f] : 0u);
        }
        n[C0] += data_err;
        n[C0 + 1] += parity_err;
        n[C0 + 2] += uncorrectable;
      });
  add_counts<NC>(n, cta, counts);
}

inline bool load_slopes(const int* slopes, int F, Slopes* sl) {
  if (F < 1 || F > MAXF) return false;
  for (int f = 0; f < MAXF; ++f) sl->s[f] = f < F ? slopes[f] : 0;
  return true;
}

// Shared argument checks and launch of the scrub kernel, with the F
// families fixed at compile time.
template <bool kInject>
int launch_scrub(uint32_t* words, const uint32_t* mask, long long n_blocks,
                 const uint32_t* parity, long long n_pblocks,
                 uint32_t* parity_out, int out_all, const int* slopes, int F,
                 int ia, int ib, int* counts, void* stream) {
  Slopes sl;
  if (!load_slopes(slopes, F, &sl) || F < 2 || ia < 0 || ib < 0 ||
      ia >= F || ib >= F || n_pblocks < 1 || n_blocks % n_pblocks ||
      !aligned16(words) || !aligned16(mask))
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  const int smem = WARPS * STAGES * (kInject ? 2 : 1) * TILE_WORDS * 4;
  return with_count<2, MAXF>(F, [&](auto f) {
    return launch(scrub_kernel<kInject, decltype(f)::value>, smem, n_blocks,
                  static_cast<cudaStream_t>(stream), words, mask, n_blocks,
                  parity, n_pblocks, parity_out, out_all, sl, ia, ib, counts);
  });
}

}  // namespace diag
