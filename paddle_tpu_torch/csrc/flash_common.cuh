// Pieces shared by the flash-attention kernels for Hopper (sm_90a):
// flash_attention.cu (forward) and flash_attention_bwd.cu (dQ, dK/dV).
//
// - tile sizes and the mask value, as the forward has always used them;
// - the bf16 tensor-core helpers (mma.sync m16n8k16, ldmatrix, fragment
//   loads) and the tile loader;
// - attention-probs dropout: the keep pattern, from an explicit keep mask
//   or from Philox4x32-10 run inside the kernel.
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
// same bits on any device. A thread whose two elements share a 2 x 2
// group (adjacent keys in the forward and dQ kernels, adjacent queries in
// the dK/dV kernel) runs Philox once for both. The constants and the round
// are those of at::philox_engine (ATen/core/PhiloxRNGEngine.h).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kMmaThreads = 128;
constexpr int kSimtThreads = 256;
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

__device__ __forceinline__ uint32_t philox_word(uint4 r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
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

__device__ __forceinline__ float mask_factor(const Dropout& d, int b, int h,
                                             int q, int k, int Sq, int Sk) {
  if (q >= Sq || k >= Sk) return 0.f;
  return d.keep[b * d.sb + h * d.sh + q * d.sq + k * d.sk] ? d.rinv : 0.f;
}

// dropout factor (0 or 1/keep_prob; 1 without dropout) of element (q, k)
__device__ __forceinline__ float drop_factor(const Dropout& d, uint2 seed,
                                             int b, int h, int q, int k,
                                             int Sq, int Sk) {
  if (d.mode == kNoDrop) return 1.f;
  if (d.mode == kMaskDrop) return mask_factor(d, b, h, q, k, Sq, Sk);
  const uint4 r = keep_group(seed, b, h, q, k);
  return philox_word(r, (q & 1) * 2 + (k & 1)) >= d.thresh ? d.rinv : 0.f;
}

// factors of (q, k) and (q, k + 1), k even: one Philox call for both
__device__ __forceinline__ void drop_factor_keys(const Dropout& d, uint2 seed,
                                                 int b, int h, int q, int k,
                                                 int Sq, int Sk, float& f0,
                                                 float& f1) {
  if (d.mode == kNoDrop) {
    f0 = f1 = 1.f;
  } else if (d.mode == kMaskDrop) {
    f0 = mask_factor(d, b, h, q, k, Sq, Sk);
    f1 = mask_factor(d, b, h, q, k + 1, Sq, Sk);
  } else {
    const uint4 r = keep_group(seed, b, h, q, k);
    f0 = philox_word(r, (q & 1) * 2) >= d.thresh ? d.rinv : 0.f;
    f1 = philox_word(r, (q & 1) * 2 + 1) >= d.thresh ? d.rinv : 0.f;
  }
}

// factors of (q, k) and (q + 1, k), q even: one Philox call for both
__device__ __forceinline__ void drop_factor_queries(const Dropout& d,
                                                    uint2 seed, int b, int h,
                                                    int q, int k, int Sq,
                                                    int Sk, float& f0,
                                                    float& f1) {
  if (d.mode == kNoDrop) {
    f0 = f1 = 1.f;
  } else if (d.mode == kMaskDrop) {
    f0 = mask_factor(d, b, h, q, k, Sq, Sk);
    f1 = mask_factor(d, b, h, q + 1, k, Sq, Sk);
  } else {
    const uint4 r = keep_group(seed, b, h, q, k);
    f0 = philox_word(r, k & 1) >= d.thresh ? d.rinv : 0.f;
    f1 = philox_word(r, 2 + (k & 1)) >= d.thresh ? d.rinv : 0.f;
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed: the B operands of two n8 tiles
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The A fragments (kSteps k-steps of 16) of the 16 rows r0 .. r0+15 of a
// row-major bf16 tile in shared memory with row stride LD
template <int kSteps, int LD>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[kSteps][4],
                                             const bf16* tile, int r0) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const bf16* base = tile + kk * 16 + 2 * t;
    f[kk][0] = lds32(base + (r0 + g) * LD);
    f[kk][1] = lds32(base + (r0 + g + 8) * LD);
    f[kk][2] = lds32(base + (r0 + g) * LD + 8);
    f[kk][3] = lds32(base + (r0 + g + 8) * LD + 8);
  }
}

// rows [0, valid) of a 64-row tile into shared memory (row stride LD), the
// rest zero; THREADS threads take part
template <int D, int LD, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t row_stride, int valid,
                                          bool vec16) {
  if (vec16) {
    constexpr int kChunks = D / 8;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < kBlockQ * kChunks; i += THREADS) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < kBlockQ * D; i += THREADS) {
      const int r = i / D, c = i % D;
      dst[r * LD + c] = r < valid ? src[r * row_stride + c]
                                  : __ushort_as_bfloat16(0);
    }
  }
}

// rows [0, valid) of a 64-row fp32 tile into shared memory (row stride
// LD), the rest zero
template <int D, int LD, int THREADS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int64_t row_stride, int valid) {
  for (int i = threadIdx.x; i < kBlockQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = r < valid ? src[r * row_stride + c] : 0.f;
  }
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace flash
