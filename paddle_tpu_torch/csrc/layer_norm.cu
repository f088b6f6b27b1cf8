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
// blocks run in parallel: pass 1 has each of G blocks walk rows
// blockIdx.x, blockIdx.x + G, ... and write its fp32 partial sums to a
// [2, G, F] scratch; pass 2 sums the G partials of each column in a fixed
// order. No atomics, so the result is the same from run to run.
//
// What bounds both on the H100: bytes. A row of 768 fp32 values is 3 KB
// and takes ~10 flops per value (forward) or ~12 (backward), far below the
// ~295 flop/byte ridge. The design reads x (and dy) from device memory
// exactly once: TPR threads own one row (a warp for F <= 1024, a
// 128-thread block up to F = 4096), each keeping up to 32 values of it in
// registers between the passes over the row, and loads and stores 4 values
// at a time (16 bytes in fp32, 8 in bf16 and fp16) where F and the
// pointers allow. The backward's partials add 2 G F fp32 values written
// and read once, about 4% of its traffic at [16384, 768].
//
// Wide rows (4096 < F <= kMaxFeatures): a 128-thread block owns a row and
// walks it in strides, once for each pass, with no copy of the row in
// registers: the forward reads x three times (sum, centred squares,
// output) and the backward x and dy twice. The first read of a row comes
// from device memory, the later ones mostly from the 50 MB L2 (a row is at
// most 256 KB). The backward's block adds each row's dgamma and dbeta
// terms into its own partial row, whose columns each thread owns, so the
// fixed-order reduction of the narrow path serves unchanged.
//
// C interface, loaded with ctypes (paddle_tpu_torch/kernels/layer_norm.py):
//   int pt_layer_norm_fwd(x, gamma, beta, y, mean, rstd, rows, features,
//                         eps, x_dtype, w_dtype, stream)
//   int pt_layer_norm_bwd(x, gamma, mean, rstd, dy, dx, dgamma, dbeta,
//                         partial, rows, features, blocks, x_dtype, w_dtype,
//                         stream)
// partial is fp32 scratch of 2 * blocks * features values. dtype codes:
// 0 = float32, 1 = bfloat16, 2 = float16 (x in any of them, gamma/beta in
// fp32 or x's dtype). Returns the cudaError_t of the launches (0 on
// success).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPerThread = 32;
// the widest row: the backward's partial sums take 2 G F fp32 values
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

// The largest [rows a block, F] tile of partial sums: 4 x 1024 (a warp a
// row) or 1 x 4096 (a block a row).
constexpr int kMaxRed = 4096;

template <typename T, typename W, int TPR, int VEC>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
                      const float* __restrict__ mean_in,
                      const float* __restrict__ rstd_in,
                      const T* __restrict__ dy, T* __restrict__ dx,
                      float* __restrict__ partial, int64_t rows, int F) {
  constexpr int kRowsPerBlock = kThreads / TPR;
  constexpr int kChunks = kMaxPerThread / VEC;
  __shared__ float scratch[kThreads / 32];
  __shared__ float red[2 * kMaxRed];
  const int t = threadIdx.x % TPR;
  const int group = threadIdx.x / TPR;

  float g[kMaxPerThread], pg[kMaxPerThread], pb[kMaxPerThread];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int base = (c * TPR + t) * VEC;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      g[c * VEC + j] = 0.f;
      pg[c * VEC + j] = 0.f;
      pb[c * VEC + j] = 0.f;
    }
    if (base < F) load_vec<VEC>(gamma + base, g + c * VEC);
  }

  // the loop bound depends on the block alone: with TPR = 128 every thread
  // of the block reaches row_sum's __syncthreads together
  for (int64_t rb = blockIdx.x; rb * kRowsPerBlock < rows; rb += gridDim.x) {
    const int64_t row = rb * kRowsPerBlock + group;
    const bool live = row < rows;
    const float mean = live ? mean_in[row] : 0.f;
    const float rstd = live ? rstd_in[row] : 0.f;
    float xh[kMaxPerThread], d[kMaxPerThread];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int base = (c * TPR + t) * VEC;
      if (live && base < F) {
        load_vec<VEC>(x + row * F + base, xh + c * VEC);
        load_vec<VEC>(dy + row * F + base, d + c * VEC);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int i = c * VEC + j;
          xh[i] = (xh[i] - mean) * rstd;
          const float w = d[i] * g[i];
          s1 += w;
          s2 += w * xh[i];
        }
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          xh[c * VEC + j] = 0.f;
          d[c * VEC + j] = 0.f;
        }
      }
    }
    const float c1 = row_sum<TPR>(s1, scratch) / F;
    const float c2 = row_sum<TPR>(s2, scratch) / F;
    if (!live) continue;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int base = (c * TPR + t) * VEC;
      if (base < F) {
        float out[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int i = c * VEC + j;
          out[j] = (d[i] * g[i] - c1 - xh[i] * c2) * rstd;
          pg[i] += d[i] * xh[i];
          pb[i] += d[i];
        }
        store_vec<VEC>(dx + row * F + base, out);
      }
    }
  }

  // this block's partials: its row groups meet in shared memory and are
  // summed in group order
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int base = (c * TPR + t) * VEC;
    if (base < F) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        red[group * F + base + j] = pg[c * VEC + j];
        red[kMaxRed + group * F + base + j] = pb[c * VEC + j];
      }
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < F; col += kThreads) {
    float sg = 0.f, sb = 0.f;
#pragma unroll
    for (int r = 0; r < kRowsPerBlock; ++r) {
      sg += red[r * F + col];
      sb += red[kMaxRed + r * F + col];
    }
    partial[static_cast<int64_t>(blockIdx.x) * F + col] = sg;
    partial[(static_cast<int64_t>(gridDim.x) + blockIdx.x) * F + col] = sb;
  }
}

// The backward of a wide row: a block a row, G blocks walking the rows as
// in the narrow kernel. Pass 1 over the row gives its two sums, pass 2 dx
// and the row's dgamma and dbeta terms, added into this block's partial
// rows (the same thread owns a column in every row, so no two threads
// meet; the block's first row writes).
template <typename T, typename W, int VEC>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_wide_kernel(const T* __restrict__ x,
                           const W* __restrict__ gamma,
                           const float* __restrict__ mean_in,
                           const float* __restrict__ rstd_in,
                           const T* __restrict__ dy, T* __restrict__ dx,
                           float* __restrict__ partial, int64_t rows, int F) {
  __shared__ float scratch[kThreads / 32];
  float* pg = partial + static_cast<int64_t>(blockIdx.x) * F;
  float* pb = partial + (static_cast<int64_t>(gridDim.x) + blockIdx.x) * F;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const bool first = row == blockIdx.x;
    const float mean = mean_in[row], rstd = rstd_in[row];
    const T* xr = x + row * F;
    const T* dr = dy + row * F;
    float s1 = 0.f, s2 = 0.f;
    for (int base = threadIdx.x * VEC; base < F; base += kThreads * VEC) {
      float xv[VEC], d[VEC], g[VEC];
      load_vec<VEC>(xr + base, xv);
      load_vec<VEC>(dr + base, d);
      load_vec<VEC>(gamma + base, g);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float w = d[j] * g[j];
        s1 += w;
        s2 += w * ((xv[j] - mean) * rstd);
      }
    }
    const float c1 = row_sum<kThreads>(s1, scratch) / F;
    const float c2 = row_sum<kThreads>(s2, scratch) / F;
    for (int base = threadIdx.x * VEC; base < F; base += kThreads * VEC) {
      float xv[VEC], d[VEC], g[VEC], out[VEC];
      load_vec<VEC>(xr + base, xv);
      load_vec<VEC>(dr + base, d);
      load_vec<VEC>(gamma + base, g);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xh = (xv[j] - mean) * rstd;
        out[j] = (d[j] * g[j] - c1 - xh * c2) * rstd;
        const float tg = d[j] * xh;
        pg[base + j] = first ? tg : pg[base + j] + tg;
        pb[base + j] = first ? d[j] : pb[base + j] + d[j];
      }
      store_vec<VEC>(dx + row * F + base, out);
    }
  }
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store_one(__half* p, float v) {
  *p = __float2half_rn(v);
}

// pass 2: out[which][col] = sum over the G partial rows, in a fixed order.
// A block owns 32 columns; its 8 slices of threads each sum every 8th
// partial row, then the slices are added in slice order.
constexpr int kRedCols = 32;
constexpr int kRedSlices = 8;

template <typename W>
__global__ void __launch_bounds__(kRedCols * kRedSlices)
layer_norm_bwd_reduce_kernel(const float* __restrict__ partial,
                             W* __restrict__ dgamma, W* __restrict__ dbeta,
                             int G, int F) {
  __shared__ float sums[kRedSlices][kRedCols];
  const int tx = threadIdx.x % kRedCols, ty = threadIdx.x / kRedCols;
  const int col = blockIdx.x * kRedCols + tx;  // over 2F: dgamma, dbeta
  const int which = col / F, c = col % F;
  float s = 0.f;
  if (col < 2 * F) {
    const float* src = partial + static_cast<int64_t>(which) * G * F + c;
#pragma unroll 8
    for (int r = ty; r < G; r += kRedSlices) s += src[static_cast<int64_t>(r) * F];
  }
  sums[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && col < 2 * F) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < kRedSlices; ++k) total += sums[k][tx];
    store_one((which == 0 ? dgamma : dbeta) + c, total);
  }
}

template <typename T, typename W, int TPR>
void launch_bwd_tpr(const void* x, const void* g, const float* mean,
                    const float* rstd, const void* dy, void* dx,
                    float* partial, int64_t rows, int F, int blocks,
                    cudaStream_t stream) {
  const bool vec = F % 4 == 0 && aligned(x, 4 * sizeof(T)) &&
                   aligned(dy, 4 * sizeof(T)) && aligned(dx, 4 * sizeof(T)) &&
                   aligned(g, 4 * sizeof(W));
  const T* xt = static_cast<const T*>(x);
  const W* gt = static_cast<const W*>(g);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  if constexpr (TPR == 0) {  // wide rows: a block a row
    if (vec) {
      layer_norm_bwd_wide_kernel<T, W, 4><<<blocks, kThreads, 0, stream>>>(
          xt, gt, mean, rstd, dyt, dxt, partial, rows, F);
    } else {
      layer_norm_bwd_wide_kernel<T, W, 1><<<blocks, kThreads, 0, stream>>>(
          xt, gt, mean, rstd, dyt, dxt, partial, rows, F);
    }
  } else if (vec) {
    layer_norm_bwd_kernel<T, W, TPR, 4><<<blocks, kThreads, 0, stream>>>(
        xt, gt, mean, rstd, dyt, dxt, partial, rows, F);
  } else {
    layer_norm_bwd_kernel<T, W, TPR, 1><<<blocks, kThreads, 0, stream>>>(
        xt, gt, mean, rstd, dyt, dxt, partial, rows, F);
  }
}

template <typename T, typename W>
void launch_bwd(const void* x, const void* g, const float* mean,
                const float* rstd, const void* dy, void* dx, void* dgamma,
                void* dbeta, float* partial, int64_t rows, int F, int blocks,
                cudaStream_t stream) {
  if (F <= 32 * kMaxPerThread) {
    launch_bwd_tpr<T, W, 32>(x, g, mean, rstd, dy, dx, partial, rows, F,
                             blocks, stream);
  } else if (F <= kThreads * kMaxPerThread) {
    launch_bwd_tpr<T, W, 128>(x, g, mean, rstd, dy, dx, partial, rows, F,
                              blocks, stream);
  } else {
    launch_bwd_tpr<T, W, 0>(x, g, mean, rstd, dy, dx, partial, rows, F,
                            blocks, stream);
  }
  const int grid = (2 * F + kRedCols - 1) / kRedCols;
  layer_norm_bwd_reduce_kernel<W><<<grid, kRedCols * kRedSlices, 0, stream>>>(
      partial, static_cast<W*>(dgamma), static_cast<W*>(dbeta), blocks, F);
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
                                 int features, int blocks, int x_dtype,
                                 int w_dtype, void* stream) {
  if (rows < 1 || features < 1 || features > kMaxFeatures || blocks < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* part = static_cast<float*>(partial);
  const bool ok = dispatch(x_dtype, w_dtype, [&](auto t, auto w) {
    launch_bwd<decltype(t), decltype(w)>(x, gamma, m, r, dy, dx, dgamma,
                                         dbeta, part, rows, features, blocks,
                                         s);
  });
  if (!ok) return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
