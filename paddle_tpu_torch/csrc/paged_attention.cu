// Ragged paged attention over a paged KV pool, for Hopper (sm_90a): the
// generation engine's mixed step (one launch a layer).
//
// Replaces the TPU kernels paddle_tpu/kernels/paged_attention.py
// _ragged_kernel (fp32 pools) and _ragged_kernel_quant (int8 or
// fp8-e4m3 pools with per-token-per-head fp32 absmax scales), launcher
// ragged_paged_attention_pallas. What it computes:
//   q [B, Cq, H, D] fp32; k_pool, v_pool [N, bs, H, D]; block_tables
//   [B, M] int32; q_lens, ctx_lens [B] int32; out [B, Cq, H, D] fp32.
//   Query j of row b sits at position ctx_lens[b] + j and sees pool
//   positions p <= ctx_lens[b] + j, read through block_tables[b, p / bs]
//   at offset p % bs; queries j >= q_lens[b] see nothing. Scores
//   (q * sm_scale) . k, masked at NEG_INF = -1e30; online softmax with
//   p = 0 where s <= NEG_INF / 2; at the end l <= 0 -> 1, so a row with no
//   visible key gives 0. A quantized pool's value is stored * scale / GRID.
//
// What bounds it on the H100: bytes. A decode query does 2 D flops per
// key and reads 2 D values per key (8 D bytes in fp32, 2 D + 8 in int8 or
// fp8): under 1 flop/byte, against the card's ~20 fp32 flop/byte. The
// least time is the visible K/V rows (plus q, o and the scales) over
// 3.35 TB/s; the chunk's slots read their prompt's blocks again, mostly
// from L2.
//
// Design. A first kernel (one lane holding D/32 values, a 5-step shuffle
// sum and an expf per position, two scale loads by all 32 lanes per
// position, 4 positions in flight a warp) spent its time on instructions
// and latency paid per position: int8 ran slower than fp32 on 4x fewer
// bytes. This one:
// - lanes from sizeof(T): a group of G = D * sizeof(T) / 16 lanes (at
//   most 32) owns one position's row of a head in 16-byte loads, so a
//   warp reads 32 / G positions a load (8 for int8/fp8 at D 64, 2 for
//   fp32); q sits in registers in the same layout, pre-scaled by
//   sm_scale * log2(e), and the dot product is a log2(G)-step shuffle sum;
// - each group keeps its own online softmax (m, l, acc over its lanes'
//   slice of D) over the positions it reads, in base 2 (ex2.approx); the
//   groups of a warp, then the CTA's warps, are merged at the end by
//   the same rescaling by 2^(m_w - m);
// - every warp keeps U loads of K and V in flight a lane and loads the
//   next U while it computes on these (a register double buffer); more in
//   flight costs registers, and so resident warps: int8/fp8 rows run
//   fastest with 2 (93 registers a thread), fp32 with 4;
// - the CTA first stages, for a chunk of up to kChunk positions, each
//   position's pool row (the block-table read leaves the loop) and, for a
//   quantized pool, its k and v scales times 1/GRID; the k scale then multiplies the
//   score and the v scale p, one scalar a position instead of one per
//   element. The JAX body dequantizes every element first, so fp32
//   rounding is reordered: within the same tolerance of the plain
//   version;
// - int8 becomes fp32 by a byte permute into 2^23's mantissa and one
//   subtraction (no I2F), fp8-e4m3 by the paired e4m3 -> f16x2 convert;
// - one CTA per (row b, head h, tile of QT queries), QT = 1 for a
//   one-query row (every slot of the engine's mixed step) and 4 else, its
//   kWarps warps splitting the head's positions (at the main path's 80
//   rows x 16 heads, 2 or 4 heads a CTA ran 11-40% slower, 8 warps
//   24-32% slower, 2 warps within 4%); the CTA walks
//   positions 0 .. min(ctx + last real query + 1, M * bs) and nothing
//   past them (the TPU kernel's "skip blocks at or past ctx + qlen").
// fp32 arithmetic on the CUDA cores throughout (the engine is fp32).
// Not done yet: splitting a long row over several CTAs, and reading a
// chunk's shared blocks once for all its slots (each slot of the mixed
// step is its own row, as in the JAX engine).

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_wgmma.cuh"

namespace {

using flash::fast_exp2;
using flash::kLog2e;
using flash::kNegInf;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 512;  // positions whose rows and scales are staged
// CTAs an SM for one-query rows: at most 102 registers a thread. Without
// the bound ptxas gave int8 113 registers (4 CTAs an SM), which ran 10%
// slower at the main path's call.
constexpr int kMinCtas = 5;

// lanes, loads and values of one head's row of D values of T
template <typename T, int D>
struct Layout {
  static constexpr int kRowVecs = D * static_cast<int>(sizeof(T)) / 16;
  static constexpr int G = kRowVecs < 32 ? kRowVecs : 32;  // lanes a row
  static constexpr int NV = kRowVecs / G;  // 16-byte vectors a lane
  static constexpr int E = 16 / static_cast<int>(sizeof(T));  // a vector
  static constexpr int P = 32 / G;  // positions a warp load
  static_assert(kRowVecs >= 1 && kRowVecs % G == 0, "head dim");
};

// the E values of one 16-byte vector as fp32
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4],
                                       float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

// four int8 as fp32: (x + 128) sits in the low byte of 2^23's bit pattern
// (ulp 1), so subtracting 2^23 + 128 leaves x exactly
__device__ __forceinline__ void int8x4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
           8388736.f;
  }
}

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[16],
                                       int8_t) {
  int8x4(r.x, f);
  int8x4(r.y, f + 4);
  int8x4(r.z, f + 8);
  int8x4(r.w, f + 12);
}

__device__ __forceinline__ void fp8x4(uint32_t w, float* f) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w >> (16 * i)), __NV_E4M3);
    const float2 x = __half22float2(__half2(h));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[16],
                                       __nv_fp8_e4m3) {
  fp8x4(r.x, f);
  fp8x4(r.y, f + 4);
  fp8x4(r.z, f + 8);
  fp8x4(r.w, f + 12);
}

// (m, l, acc) of another part of the same query folded into this one
template <int N>
__device__ __forceinline__ void fold(float& m, float& l, float (&acc)[N],
                                     float m_o, float l_o,
                                     const float (&acc_o)[N]) {
  const float mn = fmaxf(m, m_o);
  const float a = fast_exp2(m - mn);
  const float c = fast_exp2(m_o - mn);
  l = l * a + l_o * c;
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = acc[e] * a + acc_o[e] * c;
  m = mn;
}

// the K and V vectors a lane reads for positions base + u * P + slot
// (u < U) of head h: 16-byte loads, zero past the staged chunk's end c1
template <typename L, int U>
__device__ __forceinline__ void load_rows(uint4 (&nk)[U][L::NV],
                                          uint4 (&nv)[U][L::NV],
                                          const uint4* __restrict__ kvec,
                                          const uint4* __restrict__ vvec,
                                          const int* s_row, int base, int c0,
                                          int c1, int slot, int gi, int heads,
                                          int h) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int p = base + u * L::P + slot;
    const bool live = p < c1;
    const long long row = live ? s_row[p - c0] : 0;
#pragma unroll
    for (int v = 0; v < L::NV; ++v) {
      const long long at = (row * heads + h) * L::kRowVecs + gi + v * L::G;
      nk[u][v] = live ? kvec[at] : make_uint4(0u, 0u, 0u, 0u);
      nv[u][v] = live ? vvec[at] : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <typename T, bool kQuant, int D, int QT>
__global__ void __launch_bounds__(kThreads, QT == 1 ? kMinCtas : 1)
ragged_paged_kernel(const float* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ tables,
                    const int* __restrict__ q_lens,
                    const int* __restrict__ ctx_lens, float* __restrict__ out,
                    int cq, int heads, int bs, int max_blocks, float sm_scale,
                    float inv_grid) {
  using L = Layout<T, D>;
  constexpr int G = L::G, NV = L::NV, E = L::E, P = L::P;
  constexpr int V = NV * E;  // values of a row a lane holds
  // loads of K (and of V) in flight a lane, beside the next U: for
  // one-query rows 4 in fp32 and 2 in int8/fp8 (8 or 16 positions a warp),
  // the faster of 2, 4 and 8 for each at the main path's call
  constexpr int kInflight = QT == 1 && sizeof(T) == 4 ? 4 : 2;
  constexpr int U = kInflight / NV > 0 ? kInflight / NV : 1;
  constexpr int kSpan = U * P;  // positions a warp takes at once
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h = blockIdx.y;
  const int slot = lane / G;
  const int gi = lane % G;
  const int q0 = blockIdx.z * QT;
  const int ctx = ctx_lens[b];
  const int qlen = q_lens[b];
  // real queries of this tile: q0 .. q_end - 1
  const int q_end = min(qlen, min(q0 + QT, cq));
  // positions some query of the tile may see: 0 .. kv_len - 1
  const int kv_len = q_end > q0 ? min(ctx + q_end, max_blocks * bs) : 0;

  __shared__ int s_row[kChunk];
  __shared__ float s_ks[kQuant ? kChunk : 1];
  __shared__ float s_vs[kQuant ? kChunk : 1];

  // q in the lanes' layout: vector v of lane gi holds values
  // (gi + v * G) * E .. + E - 1 of the row
  float qr[QT][V];
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    const int qa = q0 + i;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
#pragma unroll
      for (int e4 = 0; e4 < E; e4 += 4) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (qa < cq) {
          const long long off =
              ((static_cast<long long>(b) * cq + qa) * heads + h) * D +
              (gi + v * G) * E + e4;
          x = *reinterpret_cast<const float4*>(q + off);
        }
        const float c = sm_scale * kLog2e;
        qr[i][v * E + e4] = x.x * c;
        qr[i][v * E + e4 + 1] = x.y * c;
        qr[i][v * E + e4 + 2] = x.z * c;
        qr[i][v * E + e4 + 3] = x.w * c;
      }
    }
  }

  float m[QT], l[QT], acc[QT][V];
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[i][e] = 0.f;
  }

  const uint4* kvec = reinterpret_cast<const uint4*>(k_pool);
  const uint4* vvec = reinterpret_cast<const uint4*>(v_pool);
  const int* table = tables + static_cast<long long>(b) * max_blocks;
  const int stride = kWarps * kSpan;
  for (int c0 = 0; c0 < kv_len; c0 += kChunk) {
    const int c1 = min(kv_len, c0 + kChunk);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = threadIdx.x; i < c1 - c0; i += kThreads) {
      const int p = c0 + i;
      s_row[i] = table[p / bs] * bs + p % bs;
    }
    if (kQuant) {
      __syncthreads();
      for (int i = threadIdx.x; i < c1 - c0; i += kThreads) {
        const long long at = static_cast<long long>(s_row[i]) * heads + h;
        s_ks[i] = k_scales[at] * inv_grid;
        s_vs[i] = v_scales[at] * inv_grid;
      }
    }
    __syncthreads();

    uint4 nk[U][NV], nv[U][NV];
    int base = c0 + warp * kSpan;
    if (base < c1)
      load_rows<L, U>(nk, nv, kvec, vvec, s_row, base, c0, c1, slot, gi,
                      heads, h);
    for (; base < c1; base += stride) {
      uint4 ck[U][NV], cv[U][NV];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          ck[u][v] = nk[u][v];
          cv[u][v] = nv[u][v];
        }
      }
      if (base + stride < c1)
        load_rows<L, U>(nk, nv, kvec, vvec, s_row, base + stride, c0, c1,
                        slot, gi, heads, h);

      float s[QT][U], vsc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = base + u * P + slot;
        const bool live = p < c1;
        float kf[V];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          float f[E];
          unpack(ck[u][v], f, T());
#pragma unroll
          for (int e = 0; e < E; ++e) kf[v * E + e] = f[e];
        }
        float ksc = 1.f;
        vsc[u] = 1.f;
        if (kQuant) {
          ksc = live ? s_ks[p - c0] : 0.f;
          vsc[u] = live ? s_vs[p - c0] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < QT; ++i) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < V; ++e) part = fmaf(qr[i][e], kf[e], part);
#pragma unroll
          for (int o = G / 2; o > 0; o >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, o);
          const int qa = q0 + i;
          s[i][u] = (live && p <= ctx + qa && qa < qlen) ? part * ksc
                                                          : kNegInf;
        }
      }

      float pw[QT][U];
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        float mx = s[i][0];
#pragma unroll
        for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[i][u]);
        const float m_new = fmaxf(m[i], mx);
        const float alpha = fast_exp2(m[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float pu =
              s[i][u] <= kNegInf / 2 ? 0.f : fast_exp2(s[i][u] - m_new);
          psum += pu;
          pw[i][u] = pu * vsc[u];
        }
        l[i] = l[i] * alpha + psum;
        m[i] = m_new;
#pragma unroll
        for (int e = 0; e < V; ++e) acc[i][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          float f[E];
          unpack(cv[u][v], f, T());
#pragma unroll
          for (int i = 0; i < QT; ++i) {
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[i][v * E + e] = fmaf(pw[i][u], f[e], acc[i][v * E + e]);
          }
        }
      }
    }
  }

  // merge the position groups of each warp: lanes gi, gi + G, ... hold
  // the same slice of D
#pragma unroll
  for (int o = G; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[i], o);
      float acc_o[V];
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc_o[e] = __shfl_xor_sync(0xffffffffu, acc[i][e], o);
      fold(m[i], l[i], acc[i], m_o, l_o, acc_o);
    }
  }

  // then the warps, a query at a time
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    __syncthreads();
    if (lane == 0) {
      sm_m[warp] = m[i];
      sm_l[warp] = l[i];
    }
    if (lane < G) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          sm_acc[warp][(gi + v * G) * E + e] = acc[i][v * E + e];
      }
    }
    __syncthreads();
    const int qa = q0 + i;
    if (qa >= cq) continue;
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float mg = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mg = fmaxf(mg, sm_m[w]);
      float lg = 0.f, ag = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = fast_exp2(sm_m[w] - mg);
        lg += sm_l[w] * f;
        ag += sm_acc[w][d] * f;
      }
      if (lg <= 0.f) lg = 1.f;
      out[((static_cast<long long>(b) * cq + qa) * heads + h) * D + d] =
          ag / lg;
    }
  }
}

template <typename T, bool kQuant, int D>
cudaError_t launch_d(const float* q, const void* k_pool, const void* v_pool,
                     const float* k_scales, const float* v_scales,
                     const int* tables, const int* q_lens,
                     const int* ctx_lens, float* out, int batch, int cq,
                     int heads, int bs, int max_blocks, float sm_scale,
                     float inv_grid, cudaStream_t stream) {
  const T* kp = static_cast<const T*>(k_pool);
  const T* vp = static_cast<const T*>(v_pool);
  if (cq == 1) {
    dim3 grid(batch, heads, 1);
    ragged_paged_kernel<T, kQuant, D, 1><<<grid, kThreads, 0, stream>>>(
        q, kp, vp, k_scales, v_scales, tables, q_lens, ctx_lens, out, cq,
        heads, bs, max_blocks, sm_scale, inv_grid);
  } else {
    dim3 grid(batch, heads, (cq + 3) / 4);
    ragged_paged_kernel<T, kQuant, D, 4><<<grid, kThreads, 0, stream>>>(
        q, kp, vp, k_scales, v_scales, tables, q_lens, ctx_lens, out, cq,
        heads, bs, max_blocks, sm_scale, inv_grid);
  }
  return cudaGetLastError();
}

template <typename T, bool kQuant>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scales, const void* v_scales,
                   const void* tables, const void* q_lens,
                   const void* ctx_lens, void* out, int batch, int cq,
                   int heads, int head_dim, int bs, int max_blocks,
                   float sm_scale, float inv_grid, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto ks = static_cast<const float*>(k_scales);
  auto vs = static_cast<const float*>(v_scales);
  auto tb = static_cast<const int*>(tables);
  auto ql = static_cast<const int*>(q_lens);
  auto cl = static_cast<const int*>(ctx_lens);
  auto o = static_cast<float*>(out);
  switch (head_dim) {
    case 16:
      return launch_d<T, kQuant, 16>(qf, k_pool, v_pool, ks, vs, tb, ql, cl,
                                     o, batch, cq, heads, bs, max_blocks,
                                     sm_scale, inv_grid, s);
    case 32:
      return launch_d<T, kQuant, 32>(qf, k_pool, v_pool, ks, vs, tb, ql, cl,
                                     o, batch, cq, heads, bs, max_blocks,
                                     sm_scale, inv_grid, s);
    case 64:
      return launch_d<T, kQuant, 64>(qf, k_pool, v_pool, ks, vs, tb, ql, cl,
                                     o, batch, cq, heads, bs, max_blocks,
                                     sm_scale, inv_grid, s);
    case 128:
      return launch_d<T, kQuant, 128>(qf, k_pool, v_pool, ks, vs, tb, ql, cl,
                                      o, batch, cq, heads, bs, max_blocks,
                                      sm_scale, inv_grid, s);
    case 256:
      return launch_d<T, kQuant, 256>(qf, k_pool, v_pool, ks, vs, tb, ql, cl,
                                      o, batch, cq, heads, bs, max_blocks,
                                      sm_scale, inv_grid, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// fp32 pools (_ragged_kernel); k_scales and v_scales are unused.
extern "C" int pt_ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* q_lens, const void* ctx_lens, void* out,
    int batch, int cq, int heads, int head_dim, int block_size,
    int max_blocks, float sm_scale, void* stream) {
  return static_cast<int>(launch<float, false>(
      q, k_pool, v_pool, nullptr, nullptr, tables, q_lens, ctx_lens, out,
      batch, cq, heads, head_dim, block_size, max_blocks, sm_scale, 1.f,
      stream));
}

// int8 (kv_code 1) or fp8-e4m3 (kv_code 2) pools with [N, bs, H] fp32
// scales (_ragged_kernel_quant).
extern "C" int pt_ragged_paged_attention_quant(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* q_lens, const void* ctx_lens, void* out, int batch, int cq,
    int heads, int head_dim, int block_size, int max_blocks, float sm_scale,
    float inv_grid, int kv_code, void* stream) {
  if (kv_code == 1) {
    return static_cast<int>(launch<int8_t, true>(
        q, k_pool, v_pool, k_scales, v_scales, tables, q_lens, ctx_lens, out,
        batch, cq, heads, head_dim, block_size, max_blocks, sm_scale,
        inv_grid, stream));
  }
  if (kv_code == 2) {
    return static_cast<int>(launch<__nv_fp8_e4m3, true>(
        q, k_pool, v_pool, k_scales, v_scales, tables, q_lens, ctx_lens, out,
        batch, cq, heads, head_dim, block_size, max_blocks, sm_scale,
        inv_grid, stream));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
