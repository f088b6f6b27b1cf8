// Fused layer norm, forward and backward, for Hopper (sm_90a).
//
// Forward: replaces the TPU kernel paddle_tpu/kernels/layer_norm.py:_fwd_kernel
// (launcher _fwd, which reaches pl.pallas_call). Per row of x [rows, F]:
// fp32 mean, centred variance (two passes, never E[x^2] - mean^2),
// rstd = rsqrt(var + eps), y = (x - mean) * rstd * gamma + beta in x's
// dtype. mean and rstd are written in fp32 for the backward.
//
// Backward: replaces paddle_tpu/kernels/layer_norm.py:_bwd_kernel
// (launcher _layer_norm_bwd). With x^ = (x - mean) rstd and g = gamma dy:
// dx = (g - mean(g) - x^ mean(g x^)) rstd in x's dtype, dgamma = sum dy x^
// and dbeta = sum dy over the rows, in gamma's dtype. The TPU kernel sums
// dgamma and dbeta into one output block across its sequential grid. Here
// the grid is one wave of G row groups (kernels/layer_norm.py bwd_grid,
// from rows and F alone), each a run of rows; a group writes its fp32
// dgamma and dbeta sums to a [2, G, F] scratch (at most 2 x 132 x 8192
// values, 8.65 MB), and layer_norm_bwd_reduce_kernel sums the G rows of
// each column in a fixed order. No atomics, so two runs give the same bits.
//
// What bounds both on the H100: bytes. A row of 768 fp32 values is 3 KB
// and takes ~10 flops per value (forward) or ~13 (backward), far below the
// ~295 flop/byte ridge. Both read x (and dy) from device memory exactly
// once, keeping a row in registers between the passes over it, and load
// and store 4 values at a time (16 bytes in fp32, 8 in bf16 and fp16)
// where F and the pointers allow.
//
// Forward: TPR threads own one row (a warp for F <= 1024, a 128-thread
// block up to F = 4096), each keeping up to 32 values in registers. Wider
// rows: a 128-thread block owns a row and walks it in strides, once for
// each pass: x is read three times (sum, centred squares, output), the
// later reads mostly from the 50 MB L2 (a row is at most 256 KB).
//
// Backward (layer_norm_bwd_warp_kernel up to 1024 features,
// layer_norm_bwd_row_kernel past them): the values a lane holds are a
// compile-time count, one instance per bucket of F, so the registers match
// the row; each warp or CTA loads its next row while it reduces and writes
// the current one; the dgamma and dbeta terms stay in registers across all
// of a group's rows. Past 8192 features a thread-block cluster of 2-8 CTAs
// shares each row, the CTAs trading the row's two sums through distributed
// shared memory.
//
// C interface, loaded with ctypes (paddle_tpu_torch/kernels/layer_norm.py):
//   int pt_layer_norm_fwd(x, gamma, beta, y, mean, rstd, rows, features,
//                         eps, x_dtype, w_dtype, stream)
//   int pt_layer_norm_bwd(x, gamma, mean, rstd, dy, dx, dgamma, dbeta,
//                         partial, rows, features, groups, x_dtype, w_dtype,
//                         stream)
// partial is fp32 scratch of 2 * groups * features values (16-byte
// aligned). dtype codes: 0 = float32, 1 = bfloat16, 2 = float16 (x in any
// of them, gamma/beta in fp32 or x's dtype). Returns the cudaError_t of
// the launches (0 on success).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPerThread = 32;
// the widest row: a cluster of 8 CTAs, 16 values a thread
constexpr int kMaxFeatures = 65536;

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    out[0] = p[0];
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  if constexpr (VEC == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else {
    out[0] = __bfloat162float(p[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __half* p, float* out) {
  if constexpr (VEC == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&raw);
    const float2 a = __half22float2(h[0]);
    const float2 b = __half22float2(h[1]);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else {
    out[0] = __half2float(p[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* in) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
    p[0] = in[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* in) {
  if constexpr (VEC == 4) {
    uint2 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
    h[0] = __floats2bfloat162_rn(in[0], in[1]);
    h[1] = __floats2bfloat162_rn(in[2], in[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
    p[0] = __float2bfloat16(in[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(__half* p, const float* in) {
  if constexpr (VEC == 4) {
    uint2 raw;
    __half2* h = reinterpret_cast<__half2*>(&raw);
    h[0] = __floats2half2_rn(in[0], in[1]);
    h[1] = __floats2half2_rn(in[2], in[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
    p[0] = __float2half_rn(in[0]);
  }
}

// Sum of v over the TPR threads that own one row. With TPR = 128 the whole
// block owns the row and the four warps meet in shared memory.
template <int TPR>
__device__ __forceinline__ float row_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if constexpr (TPR == 32) {
    return v;
  } else {
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) scratch[warp] = v;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < TPR / 32; ++w) total += scratch[w];
    __syncthreads();  // scratch is reused by the next reduction
    return total;
  }
}

template <typename T, typename W, int TPR, int VEC>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
                      const W* __restrict__ beta, T* __restrict__ y,
                      float* __restrict__ mean_out,
                      float* __restrict__ rstd_out, int64_t rows, int F,
                      float eps) {
  constexpr int kRowsPerBlock = kThreads / TPR;
  constexpr int kChunks = kMaxPerThread / VEC;
  __shared__ float scratch[kThreads / 32];
  const int t = threadIdx.x % TPR;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / TPR;
  const bool live = row < rows;
  const T* xr = x + row * F;

  float v[kMaxPerThread];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int base = (c * TPR + t) * VEC;
    if (live && base < F) {
      load_vec<VEC>(xr + base, v + c * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j) sum += v[c * VEC + j];
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[c * VEC + j] = 0.f;
    }
  }
  const float mean = row_sum<TPR>(sum, scratch) / F;

  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int base = (c * TPR + t) * VEC;
    if (live && base < F) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = v[c * VEC + j] - mean;
        sq += d * d;
      }
    }
  }
  const float var = row_sum<TPR>(sq, scratch) / F;
  const float rstd = rsqrtf(var + eps);
  if (!live) return;

  T* yr = y + row * F;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int base = (c * TPR + t) * VEC;
    if (base < F) {
      float g[VEC], b[VEC], out[VEC];
      load_vec<VEC>(gamma + base, g);
      load_vec<VEC>(beta + base, b);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        out[j] = (v[c * VEC + j] - mean) * rstd * g[j] + b[j];
      store_vec<VEC>(yr + base, out);
    }
  }
  if (t == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// A row wider than the register-held kernel takes: the block walks it in
// strides of kThreads * VEC values, once for each pass.
template <typename T, typename W, int VEC>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_wide_kernel(const T* __restrict__ x,
                           const W* __restrict__ gamma,
                           const W* __restrict__ beta, T* __restrict__ y,
                           float* __restrict__ mean_out,
                           float* __restrict__ rstd_out, int F, float eps) {
  __shared__ float scratch[kThreads / 32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * F;
  float v[VEC];
  float sum = 0.f;
  for (int base = threadIdx.x * VEC; base < F; base += kThreads * VEC) {
    load_vec<VEC>(xr + base, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) sum += v[j];
  }
  const float mean = row_sum<kThreads>(sum, scratch) / F;

  float sq = 0.f;
  for (int base = threadIdx.x * VEC; base < F; base += kThreads * VEC) {
    load_vec<VEC>(xr + base, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float d = v[j] - mean;
      sq += d * d;
    }
  }
  const float var = row_sum<kThreads>(sq, scratch) / F;
  const float rstd = rsqrtf(var + eps);

  T* yr = y + row * F;
  for (int base = threadIdx.x * VEC; base < F; base += kThreads * VEC) {
    float g[VEC], b[VEC], out[VEC];
    load_vec<VEC>(xr + base, v);
    load_vec<VEC>(gamma + base, g);
    load_vec<VEC>(beta + base, b);
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = (v[j] - mean) * rstd * g[j] + b[j];
    store_vec<VEC>(yr + base, out);
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, typename W, int TPR>
void launch_tpr(const void* x, const void* g, const void* b, void* y,
                float* mean, float* rstd, int64_t rows, int F, float eps,
                cudaStream_t stream) {
  const bool vec = F % 4 == 0 && aligned(x, 4 * sizeof(T)) &&
                   aligned(y, 4 * sizeof(T)) && aligned(g, 4 * sizeof(W)) &&
                   aligned(b, 4 * sizeof(W));
  constexpr int kRowsPerBlock = TPR == 0 ? 1 : kThreads / TPR;
  const unsigned grid =
      static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const T* xt = static_cast<const T*>(x);
  const W* gt = static_cast<const W*>(g);
  const W* bt = static_cast<const W*>(b);
  T* yt = static_cast<T*>(y);
  if constexpr (TPR == 0) {  // wide rows: a block a row
    const unsigned wide = static_cast<unsigned>(rows);
    if (vec) {
      layer_norm_fwd_wide_kernel<T, W, 4><<<wide, kThreads, 0, stream>>>(
          xt, gt, bt, yt, mean, rstd, F, eps);
    } else {
      layer_norm_fwd_wide_kernel<T, W, 1><<<wide, kThreads, 0, stream>>>(
          xt, gt, bt, yt, mean, rstd, F, eps);
    }
  } else if (vec) {
    layer_norm_fwd_kernel<T, W, TPR, 4><<<grid, kThreads, 0, stream>>>(
        xt, gt, bt, yt, mean, rstd, rows, F, eps);
  } else {
    layer_norm_fwd_kernel<T, W, TPR, 1><<<grid, kThreads, 0, stream>>>(
        xt, gt, bt, yt, mean, rstd, rows, F, eps);
  }
}

template <typename T, typename W>
void launch(const void* x, const void* g, const void* b, void* y,
            float* mean, float* rstd, int64_t rows, int F, float eps,
            cudaStream_t stream) {
  if (F <= 32 * kMaxPerThread) {
    launch_tpr<T, W, 32>(x, g, b, y, mean, rstd, rows, F, eps, stream);
  } else if (F <= kThreads * kMaxPerThread) {
    launch_tpr<T, W, 128>(x, g, b, y, mean, rstd, rows, F, eps, stream);
  } else {
    launch_tpr<T, W, 0>(x, g, b, y, mean, rstd, rows, F, eps, stream);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Four consecutive values of T as loaded: one 16-byte (fp32) or 8-byte
// (bf16, fp16) vector where F and the pointers allow, else four scalars.
// They stay in this form until used, so a load in flight holds no
// instruction back.
template <typename T, bool VEC>
struct Quad { T v[4]; };
template <>
struct Quad<float, true> { float4 v; };
template <>
struct Quad<__nv_bfloat16, true> { uint2 v; };
template <>
struct Quad<__half, true> { uint2 v; };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store_one(__half* p, float v) {
  *p = __float2half_rn(v);
}

// n (1..4) values from p; a vector quad always holds 4
template <typename T>
__device__ __forceinline__ void load_quad(const T* p, int, Quad<T, true>& q) {
  q.v = *reinterpret_cast<const decltype(q.v)*>(p);
}
template <typename T>
__device__ __forceinline__ void load_quad(const T* p, int n,
                                          Quad<T, false>& q) {
#pragma unroll
  for (int j = 0; j < 4; ++j) q.v[j] = p[j < n ? j : 0];
}

// fp32 values of a quad, 0 past its n valid ones
__device__ __forceinline__ void unpack(const Quad<float, true>& q, int,
                                       float* o) {
  o[0] = q.v.x; o[1] = q.v.y; o[2] = q.v.z; o[3] = q.v.w;
}
__device__ __forceinline__ void unpack(const Quad<__nv_bfloat16, true>& q,
                                       int, float* o) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q.v);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void unpack(const Quad<__half, true>& q, int,
                                       float* o) {
  const __half2* h = reinterpret_cast<const __half2*>(&q.v);
  const float2 a = __half22float2(h[0]);
  const float2 b = __half22float2(h[1]);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
template <typename T>
__device__ __forceinline__ void unpack(const Quad<T, false>& q, int n,
                                       float* o) {
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = j < n ? to_float(q.v[j]) : 0.f;
}

template <bool VEC, typename T>
__device__ __forceinline__ void store_quad(T* p, int n, const float* v) {
  if constexpr (VEC) {
    store_vec<4>(p, v);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) store_one(p + j, v[j]);
  }
}

// Programmatic dependent launch: the first kernel lets the reduce kernel
// be scheduled as its CTAs finish their rows, and the reduce kernel waits
// for the whole first grid (its memory included) before it reads.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;");
}
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// All dynamic: the cluster kernel's CTAs each read the others' sums.
__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ float4 ln_dyn_smem[];
  return reinterpret_cast<float*>(ln_dyn_smem);
}

// What one lane holds of one row: N quads at columns
// lo + (c * TPR + t) * 4, c < N, clipped at hi, with the row's statistics.
template <typename T, int N, bool VEC>
struct Slice {
  Quad<T, VEC> x[N], d[N];
  float mean, rstd;
};

template <int TPR, typename T, int N, bool VEC>
__device__ __forceinline__ void load_slice(Slice<T, N, VEC>& s,
                                           const T* __restrict__ x,
                                           const T* __restrict__ dy,
                                           const float* __restrict__ mean,
                                           const float* __restrict__ rstd,
                                           int64_t row, int F, int lo,
                                           int hi, int t) {
  const int64_t base = row * F;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const int col = lo + (c * TPR + t) * 4;
    if (col < hi) {
      const int n = min(4, hi - col);
      load_quad(x + base + col, n, s.x[c]);
      load_quad(dy + base + col, n, s.d[c]);
    }
  }
  s.mean = mean[row];
  s.rstd = rstd[row];
}

// The row's two sums over this lane's values, sum g dy and sum g dy x^,
// and its dgamma and dbeta terms added to pg and pb. sg is gamma's slice
// in fp32 from column lo, zero past hi up to a multiple of 4, so the
// padding adds nothing.
template <int TPR, typename T, int N, bool VEC>
__device__ __forceinline__ float2 row_terms(const Slice<T, N, VEC>& s,
                                            const float* sg, float* pg,
                                            float* pb, int lo, int hi,
                                            int t) {
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const int col = lo + (c * TPR + t) * 4;
    if (col < hi) {
      const int n = min(4, hi - col);
      float xv[4], dv[4];
      unpack(s.x[c], n, xv);
      unpack(s.d[c], n, dv);
      const float4 g4 = *reinterpret_cast<const float4*>(sg + (col - lo));
      const float g[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xh = (xv[j] - s.mean) * s.rstd;
        const float w = dv[j] * g[j];
        s1 += w;
        s2 += w * xh;
        pg[c * 4 + j] += dv[j] * xh;
        pb[c * 4 + j] += dv[j];
      }
    }
  }
  return make_float2(s1, s2);
}

// dx of this lane's values, given c1 = mean(g dy) and c2 = mean(g dy x^)
template <int TPR, bool VEC, typename T, int N>
__device__ __forceinline__ void write_dx(const Slice<T, N, VEC>& s,
                                         const float* sg, float c1, float c2,
                                         T* __restrict__ dxrow, int lo,
                                         int hi, int t) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const int col = lo + (c * TPR + t) * 4;
    if (col < hi) {
      const int n = min(4, hi - col);
      float xv[4], dv[4], out[4];
      unpack(s.x[c], n, xv);
      unpack(s.d[c], n, dv);
      const float4 g4 = *reinterpret_cast<const float4*>(sg + (col - lo));
      const float g[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xh = (xv[j] - s.mean) * s.rstd;
        out[j] = (dv[j] * g[j] - c1 - xh * c2) * s.rstd;
      }
      store_quad<VEC>(dxrow + col, n, out);
    }
  }
}

template <typename W>
__device__ __forceinline__ void load_gamma(const W* __restrict__ gamma,
                                           float* sg, int lo, int hi,
                                           int padded, int threads) {
  for (int i = threadIdx.x; i < padded; i += threads)
    sg[i] = lo + i < hi ? to_float(gamma[lo + i]) : 0.f;
}

// Rows of up to kWarpMaxFeatures: a warp a row, 4 values a lane in each of
// N chunks of 128 columns, N a compile-time bucket of F so that the
// registers match the row. One CTA an SM, of warp_cta_warps(N) warps, owns
// a run of rows (the grid is one wave, its size fixed by rows and F:
// kernels/layer_norm.py bwd_grid); each warp walks every warps-th of them
// with its next rows' x and dy already loading (warp_depth rows ahead)
// while it reduces and writes the current one. The dgamma and dbeta terms
// stay in registers across all of a warp's rows and meet in shared memory
// once, added in warp order: one partial row an SM.
constexpr int kWarpChunks[] = {1, 2, 3, 4, 6, 8};
constexpr int kWarpMaxFeatures = 32 * 4 * 8;

// Warps a CTA (one CTA an SM, registers <= 65536 / (32 x this)): a lane
// holds about 8 N fp32 values a row buffered, and 8 N of dgamma and dbeta
// terms. N 6 (BERT-base's 768) keeps two rows ahead with 8 warps, which
// measured 1-5% faster than one row ahead with 12 (three ahead in bf16 and
// fp16 gained nothing).
__host__ __device__ constexpr int warp_cta_warps(int n) {
  return n <= 1 ? 32 : n <= 2 ? 24 : n <= 4 ? 16 : 8;
}
__host__ __device__ constexpr int warp_depth(int n) { return n == 6 ? 2 : 1; }

template <typename T, typename W, int N, bool VEC>
__global__ void __launch_bounds__(32 * warp_cta_warps(N), 1)
layer_norm_bwd_warp_kernel(const T* __restrict__ x,
                           const W* __restrict__ gamma,
                           const float* __restrict__ mean_in,
                           const float* __restrict__ rstd_in,
                           const T* __restrict__ dy, T* __restrict__ dx,
                           float* __restrict__ partial, int64_t rows, int F,
                           int64_t rows_per_group) {
  constexpr int kWarps = warp_cta_warps(N);
  constexpr int kDepth = warp_depth(N);
  const int F4 = (F + 3) & ~3;
  // gamma in fp32, then each warp's dgamma and dbeta rows [kWarps][2][F4]
  float* sg = dyn_smem();
  float* red = sg + F4;
  load_gamma(gamma, sg, 0, F, F4, 32 * kWarps);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * rows_per_group;
  const int64_t end = min(rows, first + rows_per_group);
  float pg[4 * N], pb[4 * N];
#pragma unroll
  for (int i = 0; i < 4 * N; ++i) pg[i] = pb[i] = 0.f;

  // buf[0] is being reduced while buf[1..kDepth], the next rows, load
  Slice<T, N, VEC> buf[kDepth + 1];
  int64_t row = first + warp;
#pragma unroll
  for (int d = 0; d < kDepth; ++d)
    if (row + d * kWarps < end)
      load_slice<32>(buf[d], x, dy, mean_in, rstd_in, row + d * kWarps, F,
                     0, F, lane);
  for (; row < end; row += kWarps) {
    const int64_t next = row + kDepth * kWarps;
    if (next < end)
      load_slice<32>(buf[kDepth], x, dy, mean_in, rstd_in, next, F, 0, F,
                     lane);
    float2 s = row_terms<32>(buf[0], sg, pg, pb, 0, F, lane);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s.x += __shfl_xor_sync(0xffffffffu, s.x, off);
      s.y += __shfl_xor_sync(0xffffffffu, s.y, off);
    }
    write_dx<32, VEC>(buf[0], sg, s.x / F, s.y / F, dx + row * F, 0, F,
                      lane);
#pragma unroll
    for (int d = 0; d < kDepth; ++d) buf[d] = buf[d + 1];
  }

  // the reduce kernel may be scheduled now; it waits for this grid's end
  launch_dependents();

  // the CTA's dgamma and dbeta rows: each warp's in shared memory, then
  // their sums in warp order
  float* mine = red + warp * 2 * F4;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const int col = (c * 32 + lane) * 4;
    if (col < F) {
      *reinterpret_cast<float4*>(mine + col) =
          make_float4(pg[c * 4], pg[c * 4 + 1], pg[c * 4 + 2], pg[c * 4 + 3]);
      *reinterpret_cast<float4*>(mine + F4 + col) =
          make_float4(pb[c * 4], pb[c * 4 + 1], pb[c * 4 + 2], pb[c * 4 + 3]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * F; i += 32 * kWarps) {
    const int which = i < F ? 0 : 1;
    const int at = which * F4 + i - which * F;
    float v = red[at];
    for (int w = 1; w < kWarps; ++w) v += red[w * 2 * F4 + at];
    partial[(static_cast<int64_t>(which) * gridDim.x + blockIdx.x) * F + i -
            which * F] = v;
  }
}

// Wider rows: a CTA of 512 threads owns a row, or a thread-block cluster
// of K (2, 4 or 8) CTAs does, each CTA a slice of S = ceil(F / K) columns
// (rounded up to 4) held in registers, 4 values a thread in each of N
// chunks of 2048 columns. The CTAs of a cluster exchange the row's two
// sums through distributed shared memory, one cluster barrier a row, so
// every CTA reads its x and dy from device memory once; the dgamma and
// dbeta terms of a CTA's columns stay in its registers across the
// cluster's rows. A cluster owns a run of rows and keeps the next row
// loading while it finishes the current one.
constexpr int kRowThreads = 512;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowMaxChunks = 4;
constexpr int kRowMaxCluster = 8;
static_assert(kRowMaxCluster * kRowThreads * 4 * kRowMaxChunks == kMaxFeatures,
              "the widest row fills a cluster of the largest instance");
// shared floats ahead of the gamma slice: two slots of the warps' sums
// and two of the CTA's (the next row writes the other slot, so one
// barrier a row suffices)
constexpr int kRowSumFloats = 2 * (2 * kRowWarps + 2);

__host__ __device__ constexpr int row_min_blocks(int n) {
  return n <= 1 ? 2 : 1;
}

template <typename T, typename W, int N, bool VEC>
__global__ void __launch_bounds__(kRowThreads, row_min_blocks(N))
layer_norm_bwd_row_kernel(const T* __restrict__ x,
                          const W* __restrict__ gamma,
                          const float* __restrict__ mean_in,
                          const float* __restrict__ rstd_in,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          float* __restrict__ partial, int64_t rows, int F,
                          int64_t rows_per_group) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int S = ((F + K - 1) / K + 3) & ~3;
  const int lo = rank * S, hi = min(F, lo + S);
  float* smem = dyn_smem();
  float2* wsum = reinterpret_cast<float2*>(smem);  // [2][kRowWarps]
  float2* csum = wsum + 2 * kRowWarps;              // [2]
  float* sg = smem + kRowSumFloats;
  load_gamma(gamma, sg, lo, hi, S, kRowThreads);
  __syncthreads();

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int64_t group = blockIdx.x / K;
  const int64_t first = group * rows_per_group;
  const int64_t end = min(rows, first + rows_per_group);
  float pg[4 * N], pb[4 * N];
#pragma unroll
  for (int i = 0; i < 4 * N; ++i) pg[i] = pb[i] = 0.f;

  Slice<T, N, VEC> cur, nxt;
  if (first < end)
    load_slice<kRowThreads>(cur, x, dy, mean_in, rstd_in, first, F, lo, hi, t);
  // every CTA of a cluster walks the same rows, so all reach each barrier
  int slot = 0;
  for (int64_t row = first; row < end; ++row, slot ^= 1) {
    if (row + 1 < end)
      load_slice<kRowThreads>(nxt, x, dy, mean_in, rstd_in, row + 1, F, lo,
                              hi, t);
    float2 s = row_terms<kRowThreads>(cur, sg, pg, pb, lo, hi, t);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s.x += __shfl_xor_sync(0xffffffffu, s.x, off);
      s.y += __shfl_xor_sync(0xffffffffu, s.y, off);
    }
    float2* ws = wsum + slot * kRowWarps;
    if (lane == 0) ws[warp] = s;
    __syncthreads();
    float2 tot = ws[0];
#pragma unroll
    for (int w = 1; w < kRowWarps; ++w) {
      tot.x += ws[w].x;
      tot.y += ws[w].y;
    }
    if (K > 1) {
      if (t == 0) csum[slot] = tot;
      cluster.sync();
      tot = *cluster.map_shared_rank(csum + slot, 0);
      for (int r = 1; r < K; ++r) {
        const float2 o = *cluster.map_shared_rank(csum + slot, r);
        tot.x += o.x;
        tot.y += o.y;
      }
    }
    write_dx<kRowThreads, VEC>(cur, sg, tot.x / F, tot.y / F, dx + row * F,
                               lo, hi, t);
    cur = nxt;
  }
  launch_dependents();
  // no CTA leaves while another may still read its sums
  if (K > 1) cluster.sync();

  const int64_t groups = gridDim.x / K;
  float* out_g = partial + group * F;
  float* out_b = partial + (groups + group) * F;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const int col = lo + (c * kRowThreads + t) * 4;
    if (col < hi) {
      const int n = min(4, hi - col);
      if constexpr (VEC) {
        store_vec<4>(out_g + col, pg + c * 4);
        store_vec<4>(out_b + col, pb + c * 4);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < n) {
            out_g[col + j] = pg[c * 4 + j];
            out_b[col + j] = pb[c * 4 + j];
          }
        }
      }
    }
  }
}

// dgamma and dbeta: the sums over the G partial rows of [2, G, F], in a
// fixed order. A block owns 32 columns, 4 a thread; its 32 slices of
// threads each sum every 32nd partial row, then the slices are added in
// slice order. No atomics, so two runs give the same bits.
constexpr int kRedQuads = 8;
constexpr int kRedSlices = 32;

template <typename W, bool VEC>
__global__ void __launch_bounds__(kRedQuads * kRedSlices)
layer_norm_bwd_reduce_kernel(const float* __restrict__ partial,
                             W* __restrict__ dgamma, W* __restrict__ dbeta,
                             int G, int F) {
  __shared__ float4 sums[kRedSlices][kRedQuads];
  wait_prerequisites();
  const int q = threadIdx.x % kRedQuads, slice = threadIdx.x / kRedQuads;
  const int which = blockIdx.y;
  const int col = (blockIdx.x * kRedQuads + q) * 4;
  const int n = min(4, F - col);
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  if (col < F) {
    const float* src = partial + static_cast<int64_t>(which) * G * F + col;
#pragma unroll 8
    for (int r = slice; r < G; r += kRedSlices) {
      const float* p = src + static_cast<int64_t>(r) * F;
      if constexpr (VEC) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        a[0] += v.x; a[1] += v.y; a[2] += v.z; a[3] += v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < n) a[j] += p[j];
      }
    }
  }
  sums[slice][q] = make_float4(a[0], a[1], a[2], a[3]);
  __syncthreads();
  if (slice == 0 && col < F) {
    float4 tot = sums[0][q];
#pragma unroll
    for (int k = 1; k < kRedSlices; ++k) {
      const float4 v = sums[k][q];
      tot.x += v.x; tot.y += v.y; tot.z += v.z; tot.w += v.w;
    }
    const float out[4] = {tot.x, tot.y, tot.z, tot.w};
    W* dst = (which == 0 ? dgamma : dbeta) + col;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) store_one(dst + j, out[j]);
  }
}

// The instance for F, mirrored by kernels/layer_norm.py bwd_instance:
// N chunks of a warp's row for F <= kWarpMaxFeatures (0 past it), else the
// cluster size K and N chunks of a 512-thread CTA's slice.
int warp_chunks(int F) {
  const int need = (F + 127) / 128;
  for (int n : kWarpChunks)
    if (n >= need) return n;
  return 0;
}

void row_plan(int F, int* K, int* N) {
  int k = 1;
  while (k * kRowThreads * 4 * kRowMaxChunks < F) k *= 2;
  const int S = ((F + k - 1) / k + 3) & ~3;
  *K = k;
  *N = (S + kRowThreads * 4 - 1) / (kRowThreads * 4);
}

// each warp's two sums rows and gamma: up to 70 KB, past the 48 KB a
// launch gets without asking
template <typename T, typename W, int N, bool VEC>
cudaError_t launch_warp(const T* x, const W* g, const float* mean,
                        const float* rstd, const T* dy, T* dx, float* partial,
                        int64_t rows, int F, int groups, int64_t per_group,
                        cudaStream_t stream) {
  auto* kernel = layer_norm_bwd_warp_kernel<T, W, N, VEC>;
  const int smem = (1 + 2 * warp_cta_warps(N)) * ((F + 3) & ~3) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<groups, 32 * warp_cta_warps(N), smem, stream>>>(
      x, g, mean, rstd, dy, dx, partial, rows, F, per_group);
  return cudaGetLastError();
}

template <typename T, typename W, int N, bool VEC>
cudaError_t launch_row(const T* x, const W* g, const float* mean,
                       const float* rstd, const T* dy, T* dx, float* partial,
                       int64_t rows, int F, int groups, int64_t per_group,
                       cudaStream_t stream, int K) {
  const int S = ((F + K - 1) / K + 3) & ~3;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(groups * K));
  cfg.blockDim = dim3(kRowThreads);
  cfg.dynamicSmemBytes = (kRowSumFloats + S) * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, layer_norm_bwd_row_kernel<T, W, N, VEC>, x,
                            g, mean, rstd, dy, dx, partial, rows, F,
                            per_group);
}

template <typename T, typename W, bool VEC>
cudaError_t launch_bwd_vec(const T* x, const W* g, const float* mean,
                           const float* rstd, const T* dy, T* dx, W* dgamma,
                           W* dbeta, float* partial, int64_t rows, int F,
                           int groups, cudaStream_t stream) {
  const int64_t per_group = (rows + groups - 1) / groups;
  cudaError_t err = cudaSuccess;
#define LN_BWD_ARGS \
  x, g, mean, rstd, dy, dx, partial, rows, F, groups, per_group, stream
  if (F <= kWarpMaxFeatures) {
    switch (warp_chunks(F)) {
      case 1: err = launch_warp<T, W, 1, VEC>(LN_BWD_ARGS); break;
      case 2: err = launch_warp<T, W, 2, VEC>(LN_BWD_ARGS); break;
      case 3: err = launch_warp<T, W, 3, VEC>(LN_BWD_ARGS); break;
      case 4: err = launch_warp<T, W, 4, VEC>(LN_BWD_ARGS); break;
      case 6: err = launch_warp<T, W, 6, VEC>(LN_BWD_ARGS); break;
      default: err = launch_warp<T, W, 8, VEC>(LN_BWD_ARGS); break;
    }
  } else {
    int K, N;
    row_plan(F, &K, &N);
    switch (N) {
      case 1: err = launch_row<T, W, 1, VEC>(LN_BWD_ARGS, K); break;
      case 2: err = launch_row<T, W, 2, VEC>(LN_BWD_ARGS, K); break;
      case 3: err = launch_row<T, W, 3, VEC>(LN_BWD_ARGS, K); break;
      default: err = launch_row<T, W, 4, VEC>(LN_BWD_ARGS, K); break;
    }
  }
#undef LN_BWD_ARGS
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((F + 4 * kRedQuads - 1) / (4 * kRedQuads), 2);
  cfg.blockDim = dim3(kRedQuads * kRedSlices);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, layer_norm_bwd_reduce_kernel<W, VEC>,
                            static_cast<const float*>(partial), dgamma, dbeta,
                            groups, F);
}

template <typename T, typename W>
cudaError_t launch_bwd(const void* x, const void* g, const float* mean,
                       const float* rstd, const void* dy, void* dx,
                       void* dgamma, void* dbeta, float* partial,
                       int64_t rows, int F, int groups, cudaStream_t stream) {
  const bool vec = F % 4 == 0 && aligned(x, 4 * sizeof(T)) &&
                   aligned(dy, 4 * sizeof(T)) && aligned(dx, 4 * sizeof(T)) &&
                   aligned(partial, 16);
  const T* xt = static_cast<const T*>(x);
  const W* gt = static_cast<const W*>(g);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  W* dg = static_cast<W*>(dgamma);
  W* db = static_cast<W*>(dbeta);
  if (vec)
    return launch_bwd_vec<T, W, true>(xt, gt, mean, rstd, dyt, dxt, dg, db,
                                      partial, rows, F, groups, stream);
  return launch_bwd_vec<T, W, false>(xt, gt, mean, rstd, dyt, dxt, dg, db,
                                     partial, rows, F, groups, stream);
}

}  // namespace

// Runs f<T, W>() for the C interface's dtype codes; false for a pair
// with no instance.
template <typename F>
bool dispatch(int x_dtype, int w_dtype, F&& f) {
  if (x_dtype == 0 && w_dtype == 0) {
    f(float{}, float{});
  } else if (x_dtype == 1 && w_dtype == 0) {
    f(__nv_bfloat16{}, float{});
  } else if (x_dtype == 1 && w_dtype == 1) {
    f(__nv_bfloat16{}, __nv_bfloat16{});
  } else if (x_dtype == 2 && w_dtype == 0) {
    f(__half{}, float{});
  } else if (x_dtype == 2 && w_dtype == 2) {
    f(__half{}, __half{});
  } else {
    return false;
  }
  return true;
}

extern "C" int pt_layer_norm_fwd(const void* x, const void* gamma,
                                 const void* beta, void* y, void* mean,
                                 void* rstd, long long rows, int features,
                                 float eps, int x_dtype, int w_dtype,
                                 void* stream) {
  if (rows < 1 || features < 1 || features > kMaxFeatures)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  const bool ok = dispatch(x_dtype, w_dtype, [&](auto t, auto w) {
    launch<decltype(t), decltype(w)>(x, gamma, beta, y, m, r, rows, features,
                                     eps, s);
  });
  if (!ok) return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}


extern "C" int pt_layer_norm_bwd(const void* x, const void* gamma,
                                 const void* mean, const void* rstd,
                                 const void* dy, void* dx, void* dgamma,
                                 void* dbeta, void* partial, long long rows,
                                 int features, int groups, int x_dtype,
                                 int w_dtype, void* stream) {
  if (rows < 1 || features < 1 || features > kMaxFeatures || groups < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* part = static_cast<float*>(partial);
  cudaError_t err = cudaSuccess;
  const bool ok = dispatch(x_dtype, w_dtype, [&](auto t, auto w) {
    err = launch_bwd<decltype(t), decltype(w)>(x, gamma, m, r, dy, dx, dgamma,
                                               dbeta, part, rows, features,
                                               groups, s);
  });
  if (!ok) return cudaErrorInvalidValue;
  return static_cast<int>(err);
}
