// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/kernels/flash_attention.py:_fwd_kernel
// (launcher _fwd, which reaches pl.pallas_call), with its attention-probs
// dropout (_drop_keep_tile; see flash_common.cuh). For q [B,H,Sq,D], k and
// v [B,H,Sk,D] and an optional additive fp32 bias that broadcasts to
// [B,H,Sq,Sk]:
//   s = (q k^T) * scale + bias, causal mask bottom-right aligned (key j is
//   visible to query i when i + Sk - Sq >= j, masked scores are -1e30),
//   p = softmax(s), o = (p * keep / keep_prob) v in q's dtype,
//   lse = logsumexp(s) in fp32.
// Dropout multiplies only the value accumulation: the softmax denominator
// and lse stay undropped, as in the TPU kernel. The keep pattern comes
// from an explicit [B,H,Sq,Sk] keep mask read through strides (the JAX
// package's HBM-mask path) or from Philox run in the kernel (its seed
// path), with no mask in memory. A row that sees no key (causal with
// Sq > Sk, or every key masked by the bias) writes o = 0 and lse = 0, as
// the TPU kernel does.
//
// What bounds it on the H100: at BERT-base (S = 512, D = 64) the work is
// 4*S*D = 131k flops for every 4*D elements of q, k, v, o a row moves. In
// bf16 on the tensor cores (989 TFLOP/s) that sits just under the ridge,
// so bytes and operations bound it about equally; in fp32 on the CUDA cores
// (67 TFLOP/s) operations bound it. Both kernels below keep the [Sq, Sk]
// score matrix out of device memory: a block owns a 64-row q tile of one
// (b, h), walks the k tiles of 64 keys with K and V staged in shared memory,
// and keeps the running max, sum and [64, D] accumulator on chip, in fp32.
// q, k, v, o and the bias are read through strides, so a [B,S,H,D]
// projection output needs no transpose and a [B,1,1,S] padding mask
// (strides 0) is never materialised. Ragged tile edges are masked.
//
// - bfloat16: tensor cores through mma.sync m16n8k16 (bf16 in, fp32
//   accumulate). 4 warps, each owning 16 query rows; the scores stay in the
//   MMA accumulator registers, the online softmax runs on them there, and
//   they are rounded to bf16 as the A operand of P V. Loads are plain
//   16-byte copies, not yet asynchronous (cp.async / TMA) nor overlapped
//   with the MMAs, and the MMAs are not yet wgmma: later work.
// - float32: the CUDA cores, fp32 FMA, 256 threads with a 4 x D/16 slice of
//   the accumulator each (the TPU kernel's fp32 numerics exactly).
//
// C interface, loaded with ctypes (paddle_tpu_torch/kernels/flash_attention.py):
//   int pt_flash_attention_fwd(q, k, v, bias, keep, seed, o, lse, B, H, Sq,
//                              Sk, D, strides, scale, causal, thresh, rinv,
//                              dtype, stream)
//   int pt_flash_dropout_keep_mask(seed, B, H, Sq, Sk, thresh, out, stream)
// strides points to 20 int64 in host memory, in elements: q, k, v and o
// (batch, head, row), then bias and keep (batch, head, query, key). The
// last dim of q, k, v and o is contiguous. keep (uint8, 1 = keep) selects
// mask mode, seed (one int64 in device memory) seed mode; with neither
// there is no dropout. thresh and rinv = 1 / keep_prob define the dropout.
// pt_flash_dropout_keep_mask writes the seed-mode pattern as a contiguous
// uint8 [B,H,Sq,Sk] mask, for checking it against the plain version.
// dtype codes: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launch (0 on success).
#include "flash_common.cuh"

using namespace flash;

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  void* o;
  float* lse;
  int B, H, Sq, Sk;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int64_t bias_sb, bias_sh, bias_sq, bias_sk;
  float scale;
  int causal;
  int vec16;  // q, k, v rows start on 16-byte boundaries
  Dropout drop;
};

// number of k tiles a q tile starting at q0 needs (causal: up to the last
// key any of its rows can see)
__device__ __forceinline__ int k_tiles(const Params& p, int q0) {
  int n = (p.Sk + kBlockK - 1) / kBlockK;
  if (p.causal) {
    const int last = min(q0 + kBlockQ, p.Sq) - 1 + (p.Sk - p.Sq);
    n = last < 0 ? 0 : min(n, last / kBlockK + 1);
  }
  return n;
}

// score of (qrow, col) after scale, bias and masks; -inf past the last key
__device__ __forceinline__ float masked_score(const Params& p,
                                              const float* bias, float s,
                                              int qrow, int col) {
  if (col >= p.Sk) return -INFINITY;
  float val = s;
  if (bias != nullptr && qrow < p.Sq) val += bias[qrow * p.bias_sq + col * p.bias_sk];
  if (p.causal && qrow + (p.Sk - p.Sq) < col) val = kNegInf;
  return val;
}

// ---------------------------------------------------------------------------
// float32: CUDA-core kernel
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t simt_smem_bytes() {
  return sizeof(float) * (kBlockQ * (D + 1) + kBlockK * (D + 1) +
                          kBlockK * D + kBlockQ * (kBlockK + 1) + 3 * kBlockQ);
}

template <int D>
__global__ void __launch_bounds__(kSimtThreads)
flash_fwd_simt_kernel(const Params p) {
  constexpr int QS = D + 1;        // row strides padded against bank conflicts
  constexpr int KS = D + 1;
  constexpr int SS = kBlockK + 1;
  constexpr int DJ = D / 16;       // accumulator columns a thread owns
  extern __shared__ float smem[];
  float* Qs = smem;                          // [kBlockQ][QS], q * scale
  float* Ks = Qs + kBlockQ * QS;             // [kBlockK][KS]
  float* Vs = Ks + kBlockK * KS;             // [kBlockK][D]
  float* Ss = Vs + kBlockK * D;              // [kBlockQ][SS], scores then p
  float* row_m = Ss + kBlockQ * SS;          // running max
  float* row_l = row_m + kBlockQ;            // running sum
  float* row_alpha = row_l + kBlockQ;        // this tile's rescale factor

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;    // 4x4 score / 4xDJ acc layout
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bias =
      p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const uint2 seed = read_seed(p.drop);

  // q is scaled before the product, as the TPU kernel does
  for (int i = tid; i < kBlockQ * D; i += kSimtThreads) {
    const int r = i / D, c = i % D;
    Qs[r * QS + c] = q0 + r < p.Sq ? q[(q0 + r) * p.q_ss + c] * p.scale : 0.f;
  }
  if (tid < kBlockQ) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }
  const int n_tiles = k_tiles(p, q0);

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // Q is staged; the last tile's K, V, S are consumed
    for (int i = tid; i < kBlockK * D; i += kSimtThreads) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < p.Sk;
      Ks[r * KS + c] = ok ? k[(k0 + r) * p.k_ss + c] : 0.f;
      Vs[r * D + c] = ok ? v[(k0 + r) * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    // scores: thread (ty, tx) owns rows ty + 16i and columns tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ss[(ty + 16 * i) * SS + tx + 16 * j] = masked_score(
            p, bias, s[i][j], q0 + ty + 16 * i, k0 + tx + 16 * j);
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, a lane two columns
#pragma unroll
    for (int rr = 0; rr < kBlockQ / 8; ++rr) {
      const int r = warp * (kBlockQ / 8) + rr;
      float* srow = Ss + r * SS;
      const float a = srow[lane], c = srow[lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float pa = expf(a - m_new);  // 0 past the last key (a = -inf)
      float pc = expf(c - m_new);
      if (p.causal) {
        // a row with no visible key yet has m_new = -1e30 and would get
        // exp(0) = 1 for its masked entries: they must count 0
        if (a <= kNegInf / 2) pa = 0.f;
        if (c <= kNegInf / 2) pc = 0.f;
      }
      float sum = pa + pc;
      // dropout scales the value accumulation only: l sums undropped p
      srow[lane] = pa * drop_factor(p.drop, seed, b, h, q0 + r, k0 + lane,
                                    p.Sq, p.Sk);
      srow[lane + 32] = pc * drop_factor(p.drop, seed, b, h, q0 + r,
                                         k0 + lane + 32, p.Sq, p.Sk);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        row_alpha[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = row_alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * SS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qrow = q0 + r;
    if (qrow >= p.Sq) continue;
    const float l = row_l[r];
    const bool empty = l <= 0.f;
    const float l_safe = empty ? 1.f : l;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      o[qrow * p.o_ss + tx + 16 * j] = acc[i][j] / l_safe;
    if (tx == 0)
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + qrow] =
          empty ? 0.f : row_m[r] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * 3 * kBlockQ * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const Params p) {
  constexpr int LD = D + 8;          // padded row: conflict-free fragments
  constexpr int kSteps = D / 16;     // k-steps of Q K^T
  constexpr int kTilesS = kBlockK / 8;
  constexpr int kTilesO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBlockQ * LD;
  bf16* Vs = Ks + kBlockK * LD;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, t = lane & 3;  // MMA fragment coordinates
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bias =
      p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const uint2 seed = read_seed(p.drop);

  load_tile<D, LD, kMmaThreads>(Qs, q + q0 * p.q_ss, p.q_ss,
                                min(kBlockQ, p.Sq - q0), p.vec16);
  __syncthreads();
  // this warp's 16 query rows as A fragments, kept in registers
  const int r0 = warp * 16 + g;
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const bf16* base = Qs + kk * 16 + 2 * t;
    qf[kk][0] = lds32(base + r0 * LD);
    qf[kk][1] = lds32(base + (r0 + 8) * LD);
    qf[kk][2] = lds32(base + r0 * LD + 8);
    qf[kk][3] = lds32(base + (r0 + 8) * LD + 8);
  }
  const int rows[2] = {q0 + r0, q0 + r0 + 8};

  float acc[kTilesO][4];
#pragma unroll
  for (int i = 0; i < kTilesO; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  const int n_tiles = k_tiles(p, q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    const int valid = min(kBlockK, p.Sk - k0);
    __syncthreads();  // the last tile's K and V are consumed
    load_tile<D, LD, kMmaThreads>(Ks, k + k0 * p.k_ss, p.k_ss, valid,
                                  p.vec16);
    load_tile<D, LD, kMmaThreads>(Vs, v + k0 * p.v_ss, p.v_ss, valid,
                                  p.vec16);
    __syncthreads();

    // S = Q K^T: n-tile nt holds keys nt*8 .. nt*8+7; element e of a
    // fragment is row g + 8*(e/2), key nt*8 + 2t + e%2
    float s[kTilesS][4];
#pragma unroll
    for (int nt = 0; nt < kTilesS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const bf16* krow = Ks + (nt * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        mma_bf16(s[nt], qf[kk], lds32(krow + kk * 16),
                 lds32(krow + kk * 16 + 8));
    }
#pragma unroll
    for (int nt = 0; nt < kTilesS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = masked_score(p, bias, s[nt][e] * p.scale, rows[e >> 1],
                                k0 + nt * 8 + 2 * t + (e & 1));

    // online softmax; a row's 64 scores lie in the 4 lanes of its quad
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kTilesS; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * hr], s[nt][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kTilesS; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x = s[nt][2 * hr + j];
          float pv = expf(x - m_new);  // 0 past the last key (x = -inf)
          if (p.causal && x <= kNegInf / 2) pv = 0.f;
          s[nt][2 * hr + j] = pv;
          sum += pv;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m[hr] - m_new);
      l[hr] = l[hr] * alpha + sum;
      m[hr] = m_new;
#pragma unroll
      for (int dt = 0; dt < kTilesO; ++dt) {
        acc[dt][2 * hr] *= alpha;
        acc[dt][2 * hr + 1] *= alpha;
      }
      // dropout scales the value accumulation only: l summed undropped p
      if (p.drop.mode != kNoDrop) {
#pragma unroll
        for (int nt = 0; nt < kTilesS; ++nt) {
          float f0, f1;
          drop_factor_keys(p.drop, seed, b, h, rows[hr], k0 + nt * 8 + 2 * t,
                           p.Sq, p.Sk, f0, f1);
          s[nt][2 * hr] *= f0;
          s[nt][2 * hr + 1] *= f1;
        }
      }
    }

    // acc += P V: the score fragments of n-tiles 2j and 2j+1 are the A
    // fragment of k-step j; V's B fragments come transposed by ldmatrix
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                             pack_bf16(s[2 * j][2], s[2 * j][3]),
                             pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const int key = j * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vs + key * LD + i * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * i], a, bv[0], bv[1]);
        mma_bf16(acc[2 * i + 1], a, bv[2], bv[3]);
      }
    }
  }

  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qrow = rows[hr];
    if (qrow >= p.Sq) continue;
    const bool empty = l[hr] <= 0.f;
    const float l_safe = empty ? 1.f : l[hr];
#pragma unroll
    for (int dt = 0; dt < kTilesO; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(o + qrow * p.o_ss + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[dt][2 * hr] / l_safe,
                                acc[dt][2 * hr + 1] / l_safe);
    if (t == 0)
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + qrow] =
          empty ? 0.f : m[hr] + logf(l[hr]);
  }
}

template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, const Params& p,
           cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, p.B);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// one thread a 2 x 2 group of the seed-mode pattern, each row of it through
// drop_factor_keys, the word selection of the bf16 forward kernel
// (d.rinv is 1, so a factor is 1 for keep and 0 for drop)
__global__ void keep_mask_kernel(Dropout d, int B, int H, int Sq, int Sk,
                                 uint8_t* out) {
  const uint2 seed = read_seed(d);
  const int gq = (Sq + 1) / 2, gk = (Sk + 1) / 2;
  const int64_t n = static_cast<int64_t>(B) * H * gq * gk;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int k = 2 * static_cast<int>(i % gk);
    const int q2 = static_cast<int>((i / gk) % gq);
    const int h = static_cast<int>((i / gk / gq) % H);
    const int b = static_cast<int>(i / gk / gq / H);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = 2 * q2 + e;
      if (q >= Sq) continue;
      float f0, f1;
      drop_factor_keys(d, seed, b, h, q, k, Sq, Sk, f0, f1);
      uint8_t* row = out + ((static_cast<int64_t>(b) * H + h) * Sq + q) * Sk;
      row[k] = f0 != 0.f;
      if (k + 1 < Sk) row[k + 1] = f1 != 0.f;
    }
  }
}

}  // namespace

extern "C" int pt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      const void* keep, const void* seed,
                                      void* o, void* lse, int B, int H,
                                      int Sq, int Sk, int D,
                                      const void* strides, float scale,
                                      int causal, unsigned int thresh,
                                      float rinv, int dtype, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  if (keep != nullptr && seed != nullptr) return cudaErrorInvalidValue;
  const int64_t* st = static_cast<const int64_t*>(strides);
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = st[0]; p.q_sh = st[1]; p.q_ss = st[2];
  p.k_sb = st[3]; p.k_sh = st[4]; p.k_ss = st[5];
  p.v_sb = st[6]; p.v_sh = st[7]; p.v_ss = st[8];
  p.o_sb = st[9]; p.o_sh = st[10]; p.o_ss = st[11];
  p.bias_sb = st[12]; p.bias_sh = st[13]; p.bias_sq = st[14];
  p.bias_sk = st[15];
  p.drop.keep = static_cast<const uint8_t*>(keep);
  p.drop.sb = st[16]; p.drop.sh = st[17]; p.drop.sq = st[18];
  p.drop.sk = st[19];
  p.drop.seed = static_cast<const int64_t*>(seed);
  p.drop.thresh = thresh;
  p.drop.rinv = rinv;
  p.drop.mode = keep ? kMaskDrop : seed ? kSeedDrop : kNoDrop;
  p.scale = scale;
  p.causal = causal;
  bool vec = aligned16(q) && aligned16(k) && aligned16(v);
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % 8 == 0;
  p.vec16 = vec;
  // the bf16 epilogue stores bf16 pairs: o rows must be 4-byte aligned
  if (dtype == 1 && (reinterpret_cast<uintptr_t>(o) % 4 != 0 ||
                     p.o_ss % 2 != 0 || p.o_sh % 2 != 0 || p.o_sb % 2 != 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch(flash_fwd_simt_kernel<64>, kSimtThreads,
                  simt_smem_bytes<64>(), p, s);
  if (dtype == 0 && D == 128)
    return launch(flash_fwd_simt_kernel<128>, kSimtThreads,
                  simt_smem_bytes<128>(), p, s);
  if (dtype == 1 && D == 64)
    return launch(flash_fwd_mma_kernel<64>, kMmaThreads,
                  mma_smem_bytes<64>(), p, s);
  if (dtype == 1 && D == 128)
    return launch(flash_fwd_mma_kernel<128>, kMmaThreads,
                  mma_smem_bytes<128>(), p, s);
  return cudaErrorInvalidValue;
}


extern "C" int pt_flash_dropout_keep_mask(const void* seed, int B, int H,
                                          int Sq, int Sk, unsigned int thresh,
                                          void* out, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || seed == nullptr)
    return cudaErrorInvalidValue;
  Dropout d;
  d.keep = nullptr;
  d.sb = d.sh = d.sq = d.sk = 0;
  d.seed = static_cast<const int64_t*>(seed);
  d.thresh = thresh;
  d.rinv = 1.f;
  d.mode = kSeedDrop;
  keep_mask_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      d, B, H, Sq, Sk, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
