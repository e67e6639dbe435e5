// (39,32) Hsiao SEC-DED encode and fused scrub over the packed arena.
//
// Replaces the TPU kernels `encode_hsiao_kernel` and `scrub_hsiao_kernel`
// of src/repro/kernels/hsiao_secded/kernel.py (:47 and :112, bodies
// `_encode_checks` and `hsiao_body`).  Each 32-bit word carries 7 check
// bits (check j = parity of w & CHECK_MASKS[j]); a block of 32 words keeps
// them packed as 7 words, check bit j of word i at bit i of word j.
//
// Both are a bit-sliced thread per block over staged tiles
// (staged_tiles.cuh).  Thread t holds its block as a[i] = w_((i + r) mod
// 32), r = 4t mod 32, transposes the 32x32 bit matrix in registers (five
// rounds of 16 swaps: two rounds of byte permutes, three of shifts and
// masked merges), so that a[k] holds bit k of every word, and forms check
// row j as the XOR of the bit-planes in CHECK_MASKS[j] (`check_row`, 96
// planes in all, compiled in): bit i of row j is word (i + r) mod 32's
// check bit j.  The warp-per-block kernels these replace took one
// population count and one ballot per check bit and word (population
// count runs at 16 results a clock per SM, so 7 a word took longer than
// the bytes: the scrub ran at 3.4x its byte bound, the encode at 2.1x).
//
// Encode: the 7 rows rotated left by r are the block's check table row,
// written as 7 words (a 28-byte stride across a warp's blocks).
//
// Scrub: the rows XORed with the stored row rotated right by r are the
// syndrome rows in the same rotated frame.  Their OR is zero for a clean
// block, and nothing is written.  Otherwise each set bit of the OR is one
// word: its 7-bit syndrome is gathered from the rows and classified through
// a 128-entry table in shared memory (data bit k, check bit j, clean, or
// uncorrectable).  A data error flips its bit (the only word write); a
// check-bit error heals only the stored row; any other nonzero syndrome --
// a double error -- leaves the word as it is and counts uncorrectable.
// Counts are per word.  Both entry points refuse check masks other than
// the compiled ones and word buffers that are not 16-byte aligned.
//
// Bound: device-memory bytes.  Encode reads every word once and writes
// 7/32 of that; the clean scrub reads words and table and writes nothing:
// for one fp32 phi3-mini arena (3.82e9 words) 18.63 GB, 5.56 ms at
// 3.35 TB/s.  The integer work, about 10 logic or shift results a word,
// takes 2.3 ms for one arena copy at 64 results a clock per SM: under the
// bytes.  As built for sm_90a (python -m repro_torch.kernels.
// sass_report), one block per thread per pass: the scrub's main loop,
// clean and repair paths together, is 808 instructions (25 a word): 292
// LOP3, 66 PRMT, 70 SHF, 8 LDS.128, 7 LDG.32 (the next rows), 31 LDGSTS
// (staging), no POPC, SHFL or VOTE; 80 registers, no spills.  The encode's
// main loop is 814 instructions (25 a word): 267 LOP3, 64 PRMT, 62 SHF,
// 39 LDS.128 (8 for the block, the rest the gathered rows), 31 STG.128,
// 7 STS.32, 31 LDGSTS, no POPC, SHFL or VOTE; 56 registers, no spills.
// The warp-per-block encode's loop (4 words a lane) held 24 POPC and 28
// VOTE in 313 instructions.
#include "staged_tiles.cuh"

namespace {

using tiles::BLOCK;

constexpr int NCHK = 7;
constexpr int LUT_SIZE = 1 << NCHK;
constexpr uint8_t CLS_CHECK = 32;   // 32 + j: check bit j
constexpr uint8_t CLS_CLEAN = 64;
constexpr uint8_t CLS_UNC = 65;
constexpr int SMEM = tiles::WARPS * tiles::STAGES * tiles::TILE_WORDS * 4;

// The scrub's launch parameter.  The masks are the compiled ones, unused
// on the card, but they keep the table in the parameter bank: with the
// table alone (128 bytes) nvcc copies the whole parameter to the stack in
// every thread (an LDC.U8 and an STL.U8 a byte, before the table copy)
// and reads it back with LDL, which made small scrub launches slower; with
// the masks it reads the table in place (LDC.U8 at a register offset).
struct Code {
  uint32_t masks[NCHK];   // CHECK_MASKS
  uint8_t lut[LUT_SIZE];  // syndrome -> class
};

// CHECK_MASKS of kernels/hsiao_secded/code.py, compiled in so that each
// check row's XOR tree is fixed (both entry points refuse other masks).
__host__ __device__ constexpr uint32_t check_mask(int j) {
  return j == 0   ? 0x0894965Bu
         : j == 1 ? 0x11292AADu
         : j == 2 ? 0x224E4D36u
         : j == 3 ? 0x447071C7u
         : j == 4 ? 0x878381F8u
         : j == 5 ? 0xF803FE00u
                  : 0xFFFC0000u;
}

// One round of the 32x32 bit transpose: swap the high J bits of every
// 2J-bit group of a[k] with the low J bits of a[k + J], for the 16 k with
// bit J clear.
template <int J>
__device__ __forceinline__ void swap_round(uint32_t (&a)[BLOCK]) {
  constexpr uint32_t M = J == 4 ? 0x0F0F0F0Fu : J == 2 ? 0x33333333u
                                                       : 0x55555555u;
#pragma unroll
  for (int p = 0; p < BLOCK / 2; ++p) {
    const int k = p / J * 2 * J + p % J;
    const uint32_t x = a[k], y = a[k + J];
    if constexpr (J == 16) {
      a[k] = __byte_perm(x, y, 0x5410);
      a[k + J] = __byte_perm(x, y, 0x7632);
    } else if constexpr (J == 8) {
      a[k] = __byte_perm(x, y, 0x6240);
      a[k + J] = __byte_perm(x, y, 0x7351);
    } else {
      a[k] = (x & M) | ((y << J) & ~M);
      a[k + J] = ((x >> J) & M) | (y & ~M);
    }
  }
}

// Transpose the 32x32 bit matrix in place: afterwards bit i of a[k] is bit
// k of the old a[i].
__device__ __forceinline__ void transpose32(uint32_t (&a)[BLOCK]) {
  swap_round<16>(a);
  swap_round<8>(a);
  swap_round<4>(a);
  swap_round<2>(a);
  swap_round<1>(a);
}

// Check row j of a transposed block: the XOR of the bit-planes in
// CHECK_MASKS[j], bit i for the word that a[i] held before the transpose.
// The encode and the scrub both take their rows from here.
__device__ __forceinline__ uint32_t check_row(int j,
                                              const uint32_t (&a)[BLOCK]) {
  uint32_t x = 0u;
#pragma unroll
  for (int k = 0; k < BLOCK; ++k)
    if ((check_mask(j) >> k) & 1u) x ^= a[k];
  return x;
}

// parity: (n_blocks, 7), 16-byte aligned.  The thread that owns block b
// forms its row (the check rows rotated back to word order); the warp then
// gathers its tile's rows (224 words) in the stage it has read out and
// writes them as 16-byte stores, neighbouring lanes on neighbouring words.
__global__ void __launch_bounds__(tiles::WARPS * 32)
    encode_kernel(const uint32_t* __restrict__ words, long long n_blocks,
                  uint32_t* __restrict__ parity) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31;
  uint32_t p[NCHK];
  tiles::walk_tiles<false, 0>(
      smem, words, nullptr, n_blocks, nullptr, 1,
      [&](long long, const uint32_t* sw, const uint32_t*,
          const uint32_t(&)[1]) {
        uint32_t a[BLOCK];
        const int r = tiles::load_block(sw, lane, a);
        transpose32(a);
#pragma unroll
        for (int j = 0; j < NCHK; ++j)
          p[j] = tiles::rotl(check_row(j, a), r);
      },
      [&](long long tile, uint32_t* st) {
        const long long b0 = tile * BLOCK;
        const long long left = n_blocks - b0;
        const int nw = (int)(left < BLOCK ? left : BLOCK) * NCHK;
        if (lane * NCHK < nw) {   // stride 7: no bank conflict
#pragma unroll
          for (int j = 0; j < NCHK; ++j) st[lane * NCHK + j] = p[j];
        }
        __syncwarp();
        uint32_t* out = parity + b0 * NCHK;   // 896-byte steps
        for (int c = lane; c < nw / 4; c += BLOCK)
          reinterpret_cast<uint4*>(out)[c] =
              reinterpret_cast<const uint4*>(st)[c];
        const int tail = nw / 4 * 4 + lane;   // a tail tile's last words
        if (tail < nw) out[tail] = st[tail];
        __syncwarp();   // read out before the stage is refilled
      });
}

// parity: (n_pblocks, 7), read at row b % n_pblocks.  parity_out: nullptr
// to drop parity corrections, else written at row b -- every row when
// out_all, only healed rows otherwise (in place when parity_out ==
// parity).  counts: corrected, parity_fixed, uncorrectable words.
__global__ void __launch_bounds__(tiles::WARPS * 32)
    scrub_kernel(uint32_t* __restrict__ words, long long n_blocks,
                 const uint32_t* parity, long long n_pblocks,
                 uint32_t* parity_out, int out_all, Code code,
                 int* __restrict__ counts) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint8_t lut[LUT_SIZE];
  __shared__ int cta[3];
  for (int i = threadIdx.x; i < LUT_SIZE; i += blockDim.x)
    lut[i] = code.lut[i];
  if (threadIdx.x < 3) cta[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  unsigned n[3] = {};
  tiles::walk_tiles<false, NCHK>(
      smem, words, nullptr, n_blocks, parity, n_pblocks,
      [&](long long b, const uint32_t* sw, const uint32_t*,
          const uint32_t (&row)[NCHK]) {
        uint32_t a[BLOCK];
        const int r = tiles::load_block(sw, lane, a);
        transpose32(a);
        // syndrome rows, bit i for word (i + r) mod 32
        uint32_t s[NCHK];
        uint32_t dirty = 0u;
#pragma unroll
        for (int j = 0; j < NCHK; ++j) {
          s[j] = tiles::rotr(row[j], r) ^ check_row(j, a);
          dirty |= s[j];
        }
        uint32_t fix[NCHK];
#pragma unroll
        for (int j = 0; j < NCHK; ++j) fix[j] = 0u;
        bool heal = false;
        for (uint32_t d = dirty; d; d &= d - 1) {
          const int i = __ffs(d) - 1;
          int syn = 0;
#pragma unroll
          for (int j = 0; j < NCHK; ++j) syn |= ((s[j] >> i) & 1u) << j;
          const int cls = lut[syn];
          const int wi = (i + r) & (BLOCK - 1);
          if (cls < BLOCK) {
            words[b * BLOCK + wi] = sw[wi] ^ (1u << cls);
            ++n[0];
          } else if (cls < CLS_CHECK + NCHK) {
#pragma unroll
            for (int j = 0; j < NCHK; ++j)
              if (cls == CLS_CHECK + j) fix[j] |= 1u << wi;
            heal = true;
            ++n[1];
          } else {
            ++n[2];
          }
        }
        if (parity_out != nullptr && (out_all || heal)) {
#pragma unroll
          for (int j = 0; j < NCHK; ++j)
            parity_out[b * NCHK + j] = row[j] ^ fix[j];
        }
      });
  tiles::add_counts<3>(n, cta, counts);
}

// The code's syndrome table from its 32 data columns (the syndromes of
// single data-bit flips); false for masks other than the compiled ones or
// columns that are not a code.
bool load_code(const uint32_t* masks, const int* columns, Code* code) {
  for (int j = 0; j < NCHK; ++j) {
    if (masks[j] != check_mask(j)) return false;
    code->masks[j] = masks[j];
  }
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
  if (!load_code(masks, columns, &code) || !tiles::aligned16(words) ||
      !tiles::aligned16(parity))
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  return tiles::launch(encode_kernel, SMEM, n_blocks,
                       static_cast<cudaStream_t>(stream), words, n_blocks,
                       parity);
}

extern "C" int hsiao_scrub(uint32_t* words, long long n_blocks,
                           const uint32_t* parity, long long n_pblocks,
                           uint32_t* parity_out, int out_all,
                           const uint32_t* masks, const int* columns,
                           int* counts, void* stream) {
  Code code;
  if (!load_code(masks, columns, &code) || n_pblocks < 1 ||
      n_blocks % n_pblocks != 0 || !tiles::aligned16(words))
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  return tiles::launch(scrub_kernel, SMEM, n_blocks,
                       static_cast<cudaStream_t>(stream), words, n_blocks,
                       parity, n_pblocks, parity_out, out_all, code, counts);
}
