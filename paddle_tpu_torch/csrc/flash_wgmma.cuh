// The tensor-core pieces of the flash-attention kernels for Hopper
// (sm_90a), shared by the forward (flash_attention.cu) and the dQ and
// dK/dV kernels (flash_attention_bwd.cu), for their two 16-bit input types
// E, bf16 and fp16 (the same layouts and instructions, another wgmma type
// and another pair packing); the paged-attention kernel
// (paged_attention.cu) takes its exp2:
// - cp.async copies of 64-row 16-bit tiles into the 128-byte-swizzled
//   layout that the wgmma shared-memory descriptors read, and of fp32
//   vectors;
// - the descriptors of a K-major and of an MN-major operand in that layout;
// - wgmma m64n64k16 with both operands in shared memory, and m64n64k16,
//   m64n128k16 and m64n256k16 with A from registers (N = D for D 64, 128
//   and 256), with their fence, commit and wait;
// - the accumulator turned into A fragments, exp2 in one MUFU op, and the
//   keep bits a lane needs of its 2 x 2 dropout groups.
// A CTA is one or more warpgroups; THREADS below is its thread count.
#pragma once

#include <type_traits>

#include "flash_common.cuh"

namespace flash {

constexpr int kWarpgroup = 128;  // threads of a warpgroup
constexpr int kTile = 64;        // rows of a staged tile
constexpr int kLine = 128;       // bytes of a swizzled row
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kTile == kBlockQ && kTile == kBlockK, "one tile size");

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 (4) bytes from device to shared memory; zeros when !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's landed copies, visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [0, valid) of a kTile x D tile of 16-bit E into shared memory at
// dst (1024-byte aligned), the rest zero, in the layout the SW128
// descriptors read: D / 64 column blocks of kTile lines of 128 bytes,
// 16-byte chunk c of row r at chunk c ^ (r & 7). Threads [0, THREADS) take
// part, a thread one chunk column of rows kRowsPass apart.
template <int D, int THREADS = kWarpgroup, typename E>
__device__ __forceinline__ void tile_async(uint32_t dst, const E* src,
                                           int64_t row_stride, int valid) {
  static_assert(sizeof(E) == 2, "tile_async: 16-bit elements");
  constexpr int kChunks = D / 8;                 // of a row
  constexpr int kRowsPass = THREADS / kChunks;   // rows a pass
  static_assert(kTile % kRowsPass == 0 && (kRowsPass % 8 == 0 ||
                                           8 % kRowsPass == 0),
                "tile_async: whole passes");
  const int c = threadIdx.x % kChunks, r0 = threadIdx.x / kChunks;
  const uint32_t block = (c / 8) * kTile * kLine;
  const E* from = src + c * 8;
#pragma unroll
  for (int i = 0; i < kTile / kRowsPass; ++i) {
    const int r = r0 + i * kRowsPass;
    // whole 8-row passes keep a thread's swizzled chunk; shorter ones (D
    // 256 a warpgroup: 4 rows) step through r & 7
    const int sw = kRowsPass % 8 == 0 ? r0 & 7 : r & 7;
    const bool in = r < valid;
    cp_async16(dst + block + (((c % 8) ^ sw) * 16) + r * kLine,
               in ? from + r * row_stride : src, in);
  }
}

// N fp32 values src[i * stride], i < valid, into shared memory; the rest
// 0
template <int THREADS = kWarpgroup, int N = kTile>
__device__ __forceinline__ void vec_async(uint32_t dst, const float* src,
                                          int64_t stride, int valid) {
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const bool in = i < valid;
    cp_async4(dst + 4 * i, in ? src + i * stride : src, in);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle; lbo and sbo in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// K-major operand (its k dimension along the 128-byte lines): k-step kk of
// the 64-row tile at addr
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, int kk) {
  return sw128_desc(addr + (kk / 4) * kTile * kLine + (kk % 4) * 32, 16,
                    8 * kLine);
}

// MN-major operand (its k dimension across the rows of a staged tile, its
// n dimension along the lines): k-step kk covers rows 16 kk .. 16 kk + 15
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, int kk) {
  return sw128_desc(addr + kk * 16 * kLine, kTile * kLine, 8 * kLine);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x in one MUFU.EX2; results below 2^-126 flush to 0, which a softmax
// probability that small may
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// keeps the compiler from moving reads or writes of an accumulator across
// the wgmma issue and wait around it
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define PT_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define PT_F16(i) PT_F4(i), PT_F4(i + 4), PT_F4(i + 8), PT_F4(i + 12)
#define PT_F32(i) PT_F16(i), PT_F16(i + 16)

// the wgmma input type of E
template <typename E>
constexpr bool kIsF16 = std::is_same<E, f16>::value;

// d (+)= A B^T, 64 x 64, A and B K-major in shared memory
#define PT_WGMMA_SS_N64(T)                                                   \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." T "." T " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"                    \
      : PT_F32(0)                                                            \
      : "l"(a), "l"(b), "r"(accumulate))
template <typename E>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  if constexpr (kIsF16<E>)
    PT_WGMMA_SS_N64("f16");
  else
    PT_WGMMA_SS_N64("bf16");
}
#undef PT_WGMMA_SS_N64

// d += A B, 64 x N: A from registers (the m16n8k16 A fragment of each
// warp's 16 rows), B MN-major in shared memory
#define PT_WGMMA_RS_N64(T)                                                   \
  asm volatile(                                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." T "." T " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"        \
      : PT_F32(0)                                                            \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b))
template <typename E>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kIsF16<E>)
    PT_WGMMA_RS_N64("f16");
  else
    PT_WGMMA_RS_N64("bf16");
}
#undef PT_WGMMA_RS_N64

#define PT_WGMMA_RS_N128(T)                                                  \
  asm volatile(                                                              \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." T "." T " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                  \
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"                             \
      : PT_F32(0), PT_F32(32)                                                \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b))
template <typename E>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kIsF16<E>)
    PT_WGMMA_RS_N128("f16");
  else
    PT_WGMMA_RS_N128("bf16");
}
#undef PT_WGMMA_RS_N128

#define PT_WGMMA_RS_N256(T)                                                  \
  asm volatile(                                                              \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." T "." T " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "    \
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "    \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "    \
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "    \
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "   \
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "   \
      "%127}, {%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n"                 \
      : PT_F32(0), PT_F32(32), PT_F32(64), PT_F32(96)                        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b))
template <typename E>
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kIsF16<E>)
    PT_WGMMA_RS_N256("f16");
  else
    PT_WGMMA_RS_N256("bf16");
}
#undef PT_WGMMA_RS_N256

#undef PT_F32
#undef PT_F16
#undef PT_F4

// two fp32 values rounded to E, lo in the low half
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsF16<E>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// the two E values of a 32-bit word as fp32, lo first
template <typename E>
__device__ __forceinline__ float2 unpack2(uint32_t w) {
  if constexpr (kIsF16<E>)
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// A fragments of the four 16-column k-steps of a 64 x 64 accumulator
template <typename E>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4],
                                           const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack2<E>(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// s = A B^T over D / 16 k-steps, A and B 64-row K-major tiles
template <int D, typename E>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64<E>(s, kmajor_desc(a, kk), kmajor_desc(b, kk), kk > 0);
}

// a bias value in the base-2 exponent, floored so that a finfo.min mask
// stays finite. The floor lies below the running max's start (kNegInf), so
// a row whose every key the bias masks keeps l = 0 and counts as empty, as
// in the TPU kernel.
constexpr float kBiasFloor = 2.f * kNegInf;
__device__ __forceinline__ float bias_log2(float x) {
  return fmaxf(x, kBiasFloor) * kLog2e;
}

// the keep bits a lane needs of a pair of 2 x 2 groups: this lane's rows of
// its own half's group and of its partner's (lane ^ 4) half's group. The
// lane computes the group of half (g & 1), trades it for the other, and
// returns them as (half 0, half 1).
template <int MODE>
__device__ __forceinline__ uint2 paired_bits(const Dropout& d, uint2 seed,
                                             int b, int h, int q, int k,
                                             int Sq, int Sk, int g) {
  const uint32_t mine = group_bits<MODE>(d, seed, b, h, q, k, Sq, Sk);
  const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 4);
  return (g & 1) ? make_uint2(other, mine) : make_uint2(mine, other);
}

// the 1024-byte-aligned start of dynamic shared memory
__device__ __forceinline__ uint32_t aligned_smem(unsigned char* raw,
                                                 unsigned char*& base) {
  const uint32_t addr = smem_u32(raw);
  const uint32_t aligned = (addr + 1023u) & ~1023u;
  base = raw + (aligned - addr);
  return aligned;
}

// lets the kernel take smem bytes of dynamic shared memory, with the
// carveout at its largest so that as many blocks fit on an SM as the
// registers allow
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace flash
