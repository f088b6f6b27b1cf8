// Fused layer-norm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/kernels/layer_norm.py:_fwd_kernel
// (launcher _fwd, which reaches pl.pallas_call). Per row of x [rows, F]:
// fp32 mean, centred variance (two passes, never E[x^2] - mean^2),
// rstd = rsqrt(var + eps), y = (x - mean) * rstd * gamma + beta in x's
// dtype. mean and rstd are written in fp32 for the backward.
//
// What bounds it on the H100: bytes. A row of 768 fp32 values is 3 KB
// and takes ~10 flops per value, far below the ~295 flop/byte ridge.
// The design reads x from device memory exactly once: TPR threads own one
// row (a warp for F <= 1024, a 128-thread block up to F = 4096), each
// keeping up to 32 values of it in registers between the two passes, and
// loads and stores 4 values at a time (16 bytes in fp32, 8 in bf16) where
// F and the pointers allow. Rows run in parallel over the whole grid.
//
// C interface, loaded with ctypes (paddle_tpu_torch/kernels/layer_norm.py):
//   int pt_layer_norm_fwd(x, gamma, beta, y, mean, rstd, rows, features,
//                         eps, x_dtype, w_dtype, stream)
// dtype codes: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launch (0 on success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPerThread = 32;

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
  constexpr int kRowsPerBlock = kThreads / TPR;
  const unsigned grid =
      static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const T* xt = static_cast<const T*>(x);
  const W* gt = static_cast<const W*>(g);
  const W* bt = static_cast<const W*>(b);
  T* yt = static_cast<T*>(y);
  if (vec) {
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
  } else {
    launch_tpr<T, W, 128>(x, g, b, y, mean, rstd, rows, F, eps, stream);
  }
}

}  // namespace

extern "C" int pt_layer_norm_fwd(const void* x, const void* gamma,
                                 const void* beta, void* y, void* mean,
                                 void* rstd, long long rows, int features,
                                 float eps, int x_dtype, int w_dtype,
                                 void* stream) {
  if (rows < 1 || features < 1 || features > 128 * kMaxPerThread)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  if (x_dtype == 0 && w_dtype == 0) {
    launch<float, float>(x, gamma, beta, y, m, r, rows, features, eps, s);
  } else if (x_dtype == 1 && w_dtype == 0) {
    launch<__nv_bfloat16, float>(x, gamma, beta, y, m, r, rows, features,
                                 eps, s);
  } else if (x_dtype == 1 && w_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, m, r, rows,
                                         features, eps, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
