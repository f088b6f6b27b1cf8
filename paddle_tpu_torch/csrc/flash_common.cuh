// Pieces shared by the flash-attention kernels for Hopper (sm_90a):
// flash_attention.cu (forward) and flash_attention_bwd.cu (dQ, dK/dV).
//
// - tile sizes and the mask value;
// - attention-probs dropout: the keep pattern, from an explicit keep mask
//   or from Philox4x32-10 run inside the kernel.
// The bf16 and fp16 kernels' wgmma and cp.async pieces are in
// flash_wgmma.cuh.
//
// The dropout pattern replaces paddle_tpu/kernels/flash_attention.py:
// _drop_keep_tile. The TPU kernel seeds its hardware PRNG per tile, so its
// pattern depends on the tiling. Here the pattern is a function of
// (seed, b, h, q, k) alone: element (q, k) of head (b, h) takes word
// (q & 1) * 2 + (k & 1) of Philox4x32-10 with counter
// (k >> 1, q >> 1, h, b) and key (seed low 32 bits, seed high 32 bits), and
// is kept when that word >= thresh = floor((1 - keep_prob) * 2^32), the
// TPU kernel's threshold rule. The forward, the dQ kernel and the dK/dV
// kernel each regenerate it bit for bit whatever their tiles, and
// paddle_tpu_torch/kernels/flash_attention.py:philox_keep_mask gives the
// same bits on any device. Every kernel runs Philox once per 2 x 2 group
// and uses all four words (group_bits). The constants and the round are
// those of at::philox_engine (ATen/core/PhiloxRNGEngine.h).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// dropout
// ---------------------------------------------------------------------------

constexpr uint32_t kPhilox10A = 0x9E3779B9u;
constexpr uint32_t kPhilox10B = 0xBB67AE85u;
constexpr uint32_t kPhiloxSA = 0xD2511F53u;
constexpr uint32_t kPhiloxSB = 0xCD9E8D57u;

__device__ __forceinline__ uint4 philox_round(uint4 c, uint2 key) {
  const uint32_t lo0 = kPhiloxSA * c.x, hi0 = __umulhi(kPhiloxSA, c.x);
  const uint32_t lo1 = kPhiloxSB * c.z, hi1 = __umulhi(kPhiloxSB, c.z);
  return make_uint4(hi1 ^ c.y ^ key.x, lo1, hi0 ^ c.w ^ key.y, lo0);
}

// Philox4x32-10: nine rounds each followed by a key bump, then a tenth
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 key) {
#pragma unroll
  for (int r = 0; r < 9; ++r) {
    c = philox_round(c, key);
    key.x += kPhilox10A;
    key.y += kPhilox10B;
  }
  return philox_round(c, key);
}

// The four words of the 2 x 2 group holding element (q, k) of head (b, h)
__device__ __forceinline__ uint4 keep_group(uint2 seed, int b, int h, int q,
                                            int k) {
  return philox4x32_10(
      make_uint4(static_cast<uint32_t>(k) >> 1, static_cast<uint32_t>(q) >> 1,
                 static_cast<uint32_t>(h), static_cast<uint32_t>(b)),
      seed);
}

enum DropMode { kNoDrop = 0, kMaskDrop = 1, kSeedDrop = 2 };

struct Dropout {
  const uint8_t* keep;   // mask mode: [B, H, Sq, Sk] through strides, 1 = keep
  int64_t sb, sh, sq, sk;
  const int64_t* seed;   // seed mode: one value in device memory
  uint32_t thresh;       // seed mode: keep when the word >= thresh
  float rinv;            // 1 / keep_prob
  int mode;
};

// the seed words, read once per block (zero outside seed mode)
__device__ __forceinline__ uint2 read_seed(const Dropout& d) {
  if (d.mode != kSeedDrop) return make_uint2(0u, 0u);
  const uint64_t s = static_cast<uint64_t>(*d.seed);
  return make_uint2(static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32));
}

// keep bits of the 2 x 2 group holding (q, k) of head (b, h): bit
// (q' & 1) * 2 + (k' & 1) for its element (q', k'), 1 = keep. Seed mode:
// the group's four Philox words from one call. Mask mode: the mask's bytes,
// a row's two keys in one 2-byte load where they are adjacent and aligned;
// elements outside [Sq, Sk) read as dropped. All kept without dropout.
// MODE is d.mode, known where the kernel is compiled.
template <int MODE>
__device__ __forceinline__ uint32_t group_bits(const Dropout& d, uint2 seed,
                                               int b, int h, int q, int k,
                                               int Sq, int Sk) {
  q &= ~1;
  k &= ~1;
  if (MODE == kSeedDrop) {
    const uint4 r = keep_group(seed, b, h, q, k);
    return static_cast<uint32_t>(r.x >= d.thresh) |
           static_cast<uint32_t>(r.y >= d.thresh) << 1 |
           static_cast<uint32_t>(r.z >= d.thresh) << 2 |
           static_cast<uint32_t>(r.w >= d.thresh) << 3;
  }
  if (MODE == kNoDrop) return 0xFu;
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (q + i >= Sq) break;
    const uint8_t* row = d.keep + b * d.sb + h * d.sh + (q + i) * d.sq;
    if (k + 1 < Sk && d.sk == 1 &&
        reinterpret_cast<uintptr_t>(row + k) % 2 == 0) {
      const uchar2 m = *reinterpret_cast<const uchar2*>(row + k);
      bits |= static_cast<uint32_t>(m.x != 0) << (2 * i) |
              static_cast<uint32_t>(m.y != 0) << (2 * i + 1);
    } else {
      if (k < Sk && row[k * d.sk]) bits |= 1u << (2 * i);
      if (k + 1 < Sk && row[(k + 1) * d.sk]) bits |= 2u << (2 * i);
    }
  }
  return bits;
}

// The keep bits of a lane's slice of R rows x C columns from row r0 and
// column c0 (R, C, r0 and c0 even): bit i * C + j for row r0 + i, column
// c0 + j. Rows are queries and columns keys or, TRANSPOSED (the dK/dV
// kernels' scores), rows keys and columns queries. The slice holds whole
// 2 x 2 groups, one group_bits call each.
template <int MODE, int R, int C, bool TRANSPOSED>
__device__ __forceinline__ uint32_t slice_keep_bits(const Dropout& d,
                                                    uint2 seed, int b, int h,
                                                    int r0, int c0, int Sq,
                                                    int Sk) {
  static_assert(R % 2 == 0 && C % 2 == 0 && R * C <= 32, "whole groups");
  uint32_t keep = 0u;
#pragma unroll
  for (int ip = 0; ip < R / 2; ++ip)
#pragma unroll
    for (int jp = 0; jp < C / 2; ++jp) {
      const int r = r0 + 2 * ip, c = c0 + 2 * jp;
      // bit (q' & 1) * 2 + (k' & 1) of the group
      const uint32_t bits = TRANSPOSED
                                ? group_bits<MODE>(d, seed, b, h, c, r, Sq, Sk)
                                : group_bits<MODE>(d, seed, b, h, r, c, Sq, Sk);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        if (TRANSPOSED)  // row parity a is the key's: bits a and 2 + a
          keep |= ((bits >> a) & 1u | (bits >> (1 + a)) & 2u)
                  << ((2 * ip + a) * C + 2 * jp);
        else  // row parity a is the query's: bits 2a and 2a + 1
          keep |= ((bits >> (2 * a)) & 3u) << ((2 * ip + a) * C + 2 * jp);
      }
    }
  return keep;
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace flash
