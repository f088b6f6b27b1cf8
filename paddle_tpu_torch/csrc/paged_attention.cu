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
//   visible key gives 0. A quantized pool dequantizes in the loop as
//   float(stored) * (scale * inv_grid), the reference's order.
//
// What bounds it on the H100: bytes. A decode query does 2 D flops per
// key and reads 2 D values per key (8 D bytes in fp32): 0.25 flop/byte,
// against the card's ~20 fp32 flop/byte. The least time is the visible K/V
// rows (plus q, o and the scales) over 3.35 TB/s.
//
// Design (a first, simple kernel; not the TPU grid carried over):
// - one CTA of 4 warps per (row b, head h, tile of QT queries), QT = 1 for
//   a one-query row (every slot of the engine's mixed step) and 4 else;
// - the CTA walks positions 0 .. min(ctx + last real query + 1, M * bs)
//   and nothing past them: the TPU kernel's "skip blocks at or past
//   ctx + qlen". Warp w takes groups of kGroup = 4 consecutive positions
//   w*4, w*4 + 16, ...; it starts the K and V loads of a whole group
//   before it uses them, so each warp keeps 8 rows in flight;
// - a lane holds D/32 consecutive values of a row (16 B for fp32 at
//   D = 128), so a warp reads a row of one head as one contiguous run;
// - each warp keeps its own (m, l, acc) per query in registers (fp32,
//   CUDA cores, no TF32: the engine is fp32 end to end); the four warps'
//   states are merged through shared memory at the end, the same
//   rescaling by exp(m_w - m) as the online softmax itself;
// - scores are warp-shuffle sums over D.
// Not done yet: splitting a long row over several CTAs, and reading a
// chunk's shared blocks once for all its slots (each slot of the mixed
// step is its own row, as in the JAX engine, so a 64-token chunk reads
// its prompt's blocks 64 times, mostly from L2).

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 4;  // consecutive positions a warp loads at once

template <typename T, int E>
struct alignas(sizeof(T) * E) Vec {
  T v[E];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, bool kQuant, int D, int QT>
__global__ void __launch_bounds__(kThreads)
ragged_paged_kernel(const float* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ tables,
                    const int* __restrict__ q_lens,
                    const int* __restrict__ ctx_lens, float* __restrict__ out,
                    int cq, int heads, int bs, int max_blocks, float sm_scale,
                    float inv_grid) {
  constexpr int E = D >= 32 ? D / 32 : 1;  // values a lane holds
  constexpr int kLanes = D >= 32 ? 32 : D;  // lanes that hold values
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * QT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool holds = lane < kLanes;
  const int ctx = ctx_lens[b];
  const int qlen = q_lens[b];
  // real queries of this tile: q0 .. q_end - 1
  const int q_end = min(qlen, min(q0 + QT, cq));
  // positions some query of the tile may see: 0 .. kv_len - 1
  const int kv_len = q_end > q0 ? min(ctx + q_end, max_blocks * bs) : 0;
  const long long tok_stride = static_cast<long long>(heads) * D;

  float qr[QT][E];
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    const int qa = q0 + i;
    Vec<float, E> x;
#pragma unroll
    for (int e = 0; e < E; ++e) x.v[e] = 0.f;
    if (holds && qa < cq) {
      const long long off = ((static_cast<long long>(b) * cq + qa) * heads + h)
                            * D + lane * E;
      x = *reinterpret_cast<const Vec<float, E>*>(q + off);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) qr[i][e] = x.v[e] * sm_scale;
  }

  float m[QT], l[QT], acc[QT][E];
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  const int* table = tables + static_cast<long long>(b) * max_blocks;
  for (int base = warp * kGroup; base < kv_len; base += kWarps * kGroup) {
    float kf[kGroup][E], vf[kGroup][E];
    // start every load of the group first
    Vec<T, E> kraw[kGroup], vraw[kGroup];
    float ksc[kGroup], vsc[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int p = base + j;
      ksc[j] = 0.f;
      vsc[j] = 0.f;
      if (p < kv_len) {
        const long long row = static_cast<long long>(table[p / bs]) * bs
                              + p % bs;
        if (holds) {
          const long long off = row * tok_stride + h * D + lane * E;
          kraw[j] = *reinterpret_cast<const Vec<T, E>*>(k_pool + off);
          vraw[j] = *reinterpret_cast<const Vec<T, E>*>(v_pool + off);
        }
        if (kQuant) {
          ksc[j] = k_scales[row * heads + h] * inv_grid;
          vsc[j] = v_scales[row * heads + h] * inv_grid;
        } else {
          ksc[j] = 1.f;
          vsc[j] = 1.f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const bool live = holds && base + j < kv_len;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float kv = live ? to_float(kraw[j].v[e]) : 0.f;
        float vv = live ? to_float(vraw[j].v[e]) : 0.f;
        if (kQuant) {
          kv *= ksc[j];
          vv *= vsc[j];
        }
        kf[j][e] = kv;
        vf[j][e] = vv;
      }
    }
    float s[QT][kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int pos = base + j;
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part = fmaf(qr[i][e], kf[j][e], part);
        const float dot = warp_sum(part);
        const int qa = q0 + i;
        s[i][j] = (pos < kv_len && pos <= ctx + qa && qa < qlen) ? dot
                                                                 : kNegInf;
      }
    }
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < kGroup; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float p[kGroup];
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        p[j] = s[i][j] <= kNegInf / 2 ? 0.f : expf(s[i][j] - m_new);
        psum += p[j];
      }
      l[i] = l[i] * alpha + psum;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float pv = 0.f;
#pragma unroll
        for (int j = 0; j < kGroup; ++j) pv = fmaf(p[j], vf[j][e], pv);
        acc[i][e] = acc[i][e] * alpha + pv;
      }
      m[i] = m_new;
    }
  }

  // merge the warps' (m, l, acc)
  __shared__ float sm_m[kWarps][QT];
  __shared__ float sm_l[kWarps][QT];
  __shared__ float sm_acc[kWarps][QT][D];
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    if (lane == 0) {
      sm_m[warp][i] = m[i];
      sm_l[warp][i] = l[i];
    }
    if (holds) {
#pragma unroll
      for (int e = 0; e < E; ++e) sm_acc[warp][i][lane * E + e] = acc[i][e];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < QT * D; idx += kThreads) {
    const int i = idx / D;
    const int d = idx % D;
    const int qa = q0 + i;
    if (qa >= cq) continue;
    float mg = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mg = fmaxf(mg, sm_m[w][i]);
    float lg = 0.f, ag = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][i] - mg);
      lg += sm_l[w][i] * f;
      ag += sm_acc[w][i][d] * f;
    }
    if (lg <= 0.f) lg = 1.f;
    out[((static_cast<long long>(b) * cq + qa) * heads + h) * D + d] = ag / lg;
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
