// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the
// dK/dV kernel.
//
// Replaces the TPU kernels paddle_tpu/kernels/flash_attention.py:
// _bwd_dq_kernel and _bwd_dkv_kernel (both launched from _bwd, each
// reaching pl.pallas_call). From q, k, v, the forward's o and lse, the
// incoming dO, the optional additive fp32 bias and the dropout of the
// forward (keep mask or seed; see flash_common.cuh), with p recomputed as
// exp(s - lse) and keep the dropout factor (0 or 1/keep_prob, 1 without
// dropout):
//   delta = rowsum(dO * o)                     (fp32, [B,H,Sq])
//   dp    = (dO v^T) * keep
//   ds    = p * (dp - delta) * scale
//   dQ    = ds k,   dK = ds^T q,   dV = (p * keep)^T dO
// in the dtype of q, k, v. Masked scores (causal, past the last key, a row
// that the forward left empty with lse = 0) give p = 0 and no gradient.
//
// Blocks run in parallel on Hopper, so, as in the TPU kernels, one block
// owns a 64-row q tile and walks the k tiles for dQ (up to the last key its
// rows can see), and another owns a 64-key k tile and walks the q tiles
// from the first one that can see it for dK and dV. Every sum stays in one
// block: no atomics, and the result is the same from run to run. The dQ
// kernel also computes delta for its rows and writes it to device memory;
// the dK/dV kernel, launched after it on the same stream, reads it. The
// dK/dV kernel works on transposed scores s^T = k q^T, so that its rows are
// its keys and every product keeps the forward kernel's operand layouts;
// there the bias and the keep mask are read with query and key swapped,
// and a [B,1,1,S] padding bias (stride 0 along q) is read per column.
//
// What bounds it on the H100: per (b, h) the backward does 2.5 times the
// forward's matrix work (s, dp, dQ, dK, dV: 10 S^2 D flops) on the same
// bytes plus dO and three gradients, so at S = 512, D = 64 it sits at the
// ridge in bf16 and is bound by operations in fp32. Nothing of size
// [Sq, Sk] reaches device memory.
//
// - bfloat16: tensor cores through mma.sync m16n8k16 (bf16 in, fp32
//   accumulate), 4 warps each owning 16 rows (queries in the dQ kernel,
//   keys in the dK/dV kernel). p and ds are recomputed in fp32 and rounded
//   to bf16 as A operands of the next products. Loads are plain 16-byte
//   copies, neither asynchronous nor overlapped, and the MMAs are not yet
//   wgmma: later work.
// - float32: the CUDA cores, fp32 FMA, 256 threads with 4 x 4 score and
//   4 x D/16 accumulator slices each, as in the forward.
//
// C interface, loaded with ctypes (paddle_tpu_torch/kernels/flash_attention.py):
//   int pt_flash_attention_bwd_dq(q, k, v, o, dout, lse, delta, bias, keep,
//                                 seed, dq, dk, dv, B, H, Sq, Sk, D,
//                                 strides, scale, causal, thresh, rinv,
//                                 dtype, stream)
//   int pt_flash_attention_bwd_dkv(... the same arguments ...)
// The dQ entry writes delta and dq (dk, dv unused); the dK/dV entry reads
// delta and writes dk and dv (dq unused). strides points to 32 int64 in
// host memory, in elements: q, k, v, o, dout, dq, dk, dv (batch, head,
// row), then bias and keep (batch, head, query, key). The last dim of every
// tensor but the bias and keep is contiguous; lse and delta are contiguous
// [B,H,Sq] fp32. keep (uint8, 1 = keep) selects mask mode, seed (one int64
// in device memory) seed mode. dtype codes: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
#include "flash_common.cuh"

using namespace flash;

namespace {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  const float* bias;
  void* dq;
  void* dk;
  void* dv;
  int B, H, Sq, Sk;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss, do_sb, do_sh, do_ss;
  int64_t dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int64_t bias_sb, bias_sh, bias_sq, bias_sk;
  float scale;
  int causal;
  int vec16;  // q, k, v, dout rows start on 16-byte boundaries
  Dropout drop;
};

// score of query qr and key kc after scale, bias and masks; -inf outside
// the [Sq, Sk] range, -1e30 where causal masks it. bias is already offset
// to this (b, h).
__device__ __forceinline__ float score(const BwdParams& p, const float* bias,
                                       float s, int qr, int kc) {
  if (qr >= p.Sq || kc >= p.Sk) return -INFINITY;
  float val = s;
  if (bias != nullptr) val += bias[qr * p.bias_sq + kc * p.bias_sk];
  if (p.causal && qr + (p.Sk - p.Sq) < kc) val = kNegInf;
  return val;
}

// k tiles a q tile starting at q0 needs (causal: up to its last visible key)
__device__ __forceinline__ int k_tiles(const BwdParams& p, int q0) {
  int n = (p.Sk + kBlockK - 1) / kBlockK;
  if (p.causal) {
    const int last = min(q0 + kBlockQ, p.Sq) - 1 + (p.Sk - p.Sq);
    n = last < 0 ? 0 : min(n, last / kBlockK + 1);
  }
  return n;
}

// the first q tile that can see a k tile starting at k0
__device__ __forceinline__ int first_q_tile(const BwdParams& p, int k0) {
  return p.causal ? max(k0 - (p.Sk - p.Sq), 0) / kBlockQ : 0;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// delta = rowsum(dO * o) of rows [q0, q0 + valid) of this (b, h), TPR
// threads a row (blockDim.x / TPR rows at a time); into delta_s and device
// memory
template <typename T, int D, int TPR>
__device__ __forceinline__ void row_delta(const BwdParams& p, const T* o,
                                          const T* dout, int b, int h,
                                          int q0, int valid,
                                          float* delta_s) {
  static_assert(TPR == 2 || TPR == 4, "row_delta: 2 or 4 threads a row");
  for (int base = 0; base < kBlockQ; base += blockDim.x / TPR) {
    const int r = base + threadIdx.x / TPR, part = threadIdx.x % TPR;
    float s = 0.f;
    if (r < valid) {
      const T* orow = o + (q0 + r) * p.o_ss;
      const T* drow = dout + (q0 + r) * p.do_ss;
      for (int c = part; c < D; c += TPR) s += to_f32(orow[c]) * to_f32(drow[c]);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (TPR == 4) s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0 && r < kBlockQ) {
      delta_s[r] = s;
      if (r < valid)
        p.delta[(static_cast<int64_t>(b) * p.H + h) * p.Sq + q0 + r] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA-core kernels
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t simt_bwd_smem_bytes() {
  return sizeof(float) * (4 * kBlockQ * (D + 1) + 2 * kBlockQ * (kBlockK + 1) +
                          2 * kBlockQ);
}

template <int D>
__global__ void __launch_bounds__(kSimtThreads)
flash_bwd_dq_simt_kernel(const BwdParams p) {
  constexpr int LD = D + 1;
  constexpr int SS = kBlockK + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [64][LD]
  float* dOs = Qs + kBlockQ * LD;    // [64][LD]
  float* Ks = dOs + kBlockQ * LD;    // [64][LD]
  float* Vs = Ks + kBlockK * LD;     // [64][LD]
  float* Ss = Vs + kBlockK * LD;     // [64][SS], ds
  float* lse_s = Ss + 2 * kBlockQ * SS;
  float* delta_s = lse_s + kBlockQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* o = static_cast<const float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* bias =
      p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const uint2 seed = read_seed(p.drop);
  const int valid_q = min(kBlockQ, p.Sq - q0);

  load_tile_f32<D, LD, kSimtThreads>(Qs, q + q0 * p.q_ss, p.q_ss, valid_q);
  load_tile_f32<D, LD, kSimtThreads>(dOs, dout + q0 * p.do_ss, p.do_ss,
                                     valid_q);
  row_delta<float, D, 4>(p, o, dout, b, h, q0, valid_q, delta_s);
  if (tid < kBlockQ)
    lse_s[tid] = tid < valid_q
                     ? p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + q0 + tid]
                     : 0.f;

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int n_tiles = k_tiles(p, q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // Q, dO, lse, delta staged; last tile's K, ds consumed
    load_tile_f32<D, LD, kSimtThreads>(Ks, k + k0 * p.k_ss, p.k_ss,
                                       min(kBlockK, p.Sk - k0));
    load_tile_f32<D, LD, kSimtThreads>(Vs, v + k0 * p.v_ss, p.v_ss,
                                       min(kBlockK, p.Sk - k0));
    __syncthreads();

    // thread (ty, tx) owns rows ty + 16i and keys tx + 16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], da[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = Qs[(ty + 16 * i) * LD + d];
        da[i] = dOs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = Ks[(tx + 16 * j) * LD + d];
        vb[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float pv =
            expf(score(p, bias, s[i][j] * p.scale, q0 + r, k0 + c) - lse_s[r]);
        const float f = drop_factor(p.drop, seed, b, h, q0 + r, k0 + c,
                                    p.Sq, p.Sk);
        Ss[r * SS + c] = pv * (dp[i][j] * f - delta_s[r]) * p.scale;
      }
    __syncthreads();

    // dQ += ds k
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float dsv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = Ss[(ty + 16 * i) * SS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

  float* dq = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + ty + 16 * i;
    if (qrow >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[qrow * p.dq_ss + tx + 16 * j] = acc[i][j];
  }
}

template <int D>
__global__ void __launch_bounds__(kSimtThreads)
flash_bwd_dkv_simt_kernel(const BwdParams p) {
  constexpr int LD = D + 1;
  constexpr int SS = kBlockQ + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                  // [64][LD]
  float* Vs = Ks + kBlockK * LD;     // [64][LD]
  float* Qs = Vs + kBlockK * LD;     // [64][LD]
  float* dOs = Qs + kBlockQ * LD;    // [64][LD]
  float* Ps = dOs + kBlockQ * LD;    // [64 keys][SS queries], p * keep
  float* DSs = Ps + kBlockK * SS;    // [64 keys][SS queries], ds
  float* lse_s = DSs + kBlockK * SS;
  float* delta_s = lse_s + kBlockQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* bias =
      p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const float* lse = p.lse + (static_cast<int64_t>(b) * p.H + h) * p.Sq;
  const float* delta = p.delta + (static_cast<int64_t>(b) * p.H + h) * p.Sq;
  const uint2 seed = read_seed(p.drop);

  load_tile_f32<D, LD, kSimtThreads>(Ks, k + k0 * p.k_ss, p.k_ss,
                                     min(kBlockK, p.Sk - k0));
  load_tile_f32<D, LD, kSimtThreads>(Vs, v + k0 * p.v_ss, p.v_ss,
                                     min(kBlockK, p.Sk - k0));

  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int n_q = (p.Sq + kBlockQ - 1) / kBlockQ;
  for (int qt = first_q_tile(p, k0); qt < n_q; ++qt) {
    const int q0 = qt * kBlockQ;
    const int valid_q = min(kBlockQ, p.Sq - q0);
    __syncthreads();  // the last tile's Q, dO, p, ds are consumed
    load_tile_f32<D, LD, kSimtThreads>(Qs, q + q0 * p.q_ss, p.q_ss, valid_q);
    load_tile_f32<D, LD, kSimtThreads>(dOs, dout + q0 * p.do_ss, p.do_ss,
                                       valid_q);
    if (tid < kBlockQ) {
      lse_s[tid] = tid < valid_q ? lse[q0 + tid] : 0.f;
      delta_s[tid] = tid < valid_q ? delta[q0 + tid] : 0.f;
    }
    __syncthreads();

    // transposed scores: thread (ty, tx) owns keys ty + 16i, queries tx + 16j
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float ka[4], va[4], qb[4], db[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = Ks[(ty + 16 * i) * LD + d];
        va[i] = Vs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qb[j] = Qs[(tx + 16 * j) * LD + d];
        db[j] = dOs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(ka[i], qb[j], st[i][j]);
          dpt[i][j] = fmaf(va[i], db[j], dpt[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float pv =
            expf(score(p, bias, st[i][j] * p.scale, q0 + c, k0 + r) - lse_s[c]);
        const float f = drop_factor(p.drop, seed, b, h, q0 + c, k0 + r,
                                    p.Sq, p.Sk);
        Ps[r * SS + c] = pv * f;
        DSs[r * SS + c] = pv * (dpt[i][j] * f - delta_s[c]) * p.scale;
      }
    __syncthreads();

    // dV += (p keep)^T dO, dK += ds^T q
#pragma unroll 4
    for (int qq = 0; qq < kBlockQ; ++qq) {
      float pa[4], da[4], ob[DJ], qb[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = Ps[(ty + 16 * i) * SS + qq];
        da[i] = DSs[(ty + 16 * i) * SS + qq];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        ob[j] = dOs[qq * LD + tx + 16 * j];
        qb[j] = Qs[qq * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv[i][j] = fmaf(pa[i], ob[j], dv[i][j]);
          dk[i][j] = fmaf(da[i], qb[j], dk[i][j]);
        }
    }
  }

  float* dkp = static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  float* dvp = static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int krow = k0 + ty + 16 * i;
    if (krow >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkp[krow * p.dk_ss + tx + 16 * j] = dk[i][j];
      dvp[krow * p.dv_ss + tx + 16 * j] = dv[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernels (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t mma_bwd_smem_bytes() {
  return sizeof(bf16) * 4 * kBlockQ * (D + 8) + sizeof(float) * 2 * kBlockQ;
}

// acc[2i], acc[2i+1] += A B, where A is the k-step of 16 columns packed
// from score fragments and B the rows [16 j, 16 j + 16) of a row-major
// [64][LD] bf16 tile (k = its rows, n = its D columns), transposed by
// ldmatrix
template <int D, int LD, int kTilesO>
__device__ __forceinline__ void mma_rows(float (&acc)[kTilesO][4],
                                         const uint32_t (&a)[4],
                                         const bf16* tile, int j) {
  const int lane = threadIdx.x % 32;
  const int row = j * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    uint32_t bv[4];
    ldmatrix_x4_trans(bv, tile + row * LD + i * 16 + (lane / 16) * 8);
    mma_bf16(acc[2 * i], a, bv[0], bv[1]);
    mma_bf16(acc[2 * i + 1], a, bv[2], bv[3]);
  }
}

// the A fragment of k-step j from score fragments s[2j], s[2j+1]
template <int kTilesS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                       const float (&s)[kTilesS][4], int j) {
  a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
  a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
  a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
  a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
}

// c[nt] = A B^T over kSteps k-steps, A from registers, B^T the rows
// nt*8 .. nt*8+7 of a row-major [64][LD] bf16 tile
template <int kSteps, int kTiles, int LD>
__device__ __forceinline__ void mma_abt(float (&c)[kTiles][4],
                                        const uint32_t (&a)[kSteps][4],
                                        const bf16* tile) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
    const bf16* row = tile + (nt * 8 + g) * LD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      mma_bf16(c[nt], a[kk], lds32(row + kk * 16), lds32(row + kk * 16 + 8));
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const BwdParams p) {
  constexpr int LD = D + 8;
  constexpr int kSteps = D / 16;
  constexpr int kTilesS = kBlockK / 8;
  constexpr int kTilesO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kBlockQ * LD;
  bf16* Ks = dOs + kBlockQ * LD;
  bf16* Vs = Ks + kBlockK * LD;
  float* delta_s = reinterpret_cast<float*>(Vs + kBlockK * LD);
  float* lse_s = delta_s + kBlockQ;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* o = static_cast<const bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* bias =
      p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const uint2 seed = read_seed(p.drop);
  const int valid_q = min(kBlockQ, p.Sq - q0);

  load_tile<D, LD, kMmaThreads>(Qs, q + q0 * p.q_ss, p.q_ss, valid_q, p.vec16);
  load_tile<D, LD, kMmaThreads>(dOs, dout + q0 * p.do_ss, p.do_ss, valid_q,
                                p.vec16);
  row_delta<bf16, D, 2>(p, o, dout, b, h, q0, valid_q, delta_s);
  if (threadIdx.x < kBlockQ)
    lse_s[threadIdx.x] =
        static_cast<int>(threadIdx.x) < valid_q
            ? p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + q0 + threadIdx.x]
            : 0.f;
  __syncthreads();

  const int r0 = warp * 16;
  uint32_t qf[kSteps][4], df[kSteps][4];
  load_a_frags<kSteps, LD>(qf, Qs, r0);
  load_a_frags<kSteps, LD>(df, dOs, r0);
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const float lse_r[2] = {lse_s[r0 + g], lse_s[r0 + g + 8]};
  const float delta_r[2] = {delta_s[r0 + g], delta_s[r0 + g + 8]};

  float acc[kTilesO][4];
#pragma unroll
  for (int i = 0; i < kTilesO; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_tiles = k_tiles(p, q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    const int valid = min(kBlockK, p.Sk - k0);
    __syncthreads();  // the last tile's K and V are consumed
    load_tile<D, LD, kMmaThreads>(Ks, k + k0 * p.k_ss, p.k_ss, valid, p.vec16);
    load_tile<D, LD, kMmaThreads>(Vs, v + k0 * p.v_ss, p.v_ss, valid, p.vec16);
    __syncthreads();

    // element e of fragment nt: query rows[e/2], key k0 + nt*8 + 2t + e%2
    float s[kTilesS][4], dp[kTilesS][4];
    mma_abt<kSteps, kTilesS, LD>(s, qf, Ks);
    mma_abt<kSteps, kTilesS, LD>(dp, df, Vs);
#pragma unroll
    for (int nt = 0; nt < kTilesS; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int kc = k0 + nt * 8 + 2 * t;
        float f0, f1;
        drop_factor_keys(p.drop, seed, b, h, rows[hr], kc, p.Sq, p.Sk, f0, f1);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * hr + j;
          const float pv = expf(
              score(p, bias, s[nt][e] * p.scale, rows[hr], kc + j) - lse_r[hr]);
          s[nt][e] =
              pv * (dp[nt][e] * (j ? f1 : f0) - delta_r[hr]) * p.scale;  // ds
        }
      }

    // dQ += ds k
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      uint32_t a[4];
      pack_a<kTilesS>(a, s, j);
      mma_rows<D, LD, kTilesO>(acc, a, Ks, j);
    }
  }

  bf16* dq = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (rows[hr] >= p.Sq) continue;
#pragma unroll
    for (int dt = 0; dt < kTilesO; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dq + rows[hr] * p.dq_ss + dt * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(acc[dt][2 * hr], acc[dt][2 * hr + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const BwdParams p) {
  constexpr int LD = D + 8;
  constexpr int kSteps = D / 16;
  constexpr int kTilesS = kBlockQ / 8;  // n-tiles over a q tile's queries
  constexpr int kTilesO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kBlockK * LD;
  bf16* Qs = Vs + kBlockK * LD;
  bf16* dOs = Qs + kBlockQ * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + kBlockQ * LD);
  float* delta_s = lse_s + kBlockQ;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* bias =
      p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const float* lse = p.lse + (static_cast<int64_t>(b) * p.H + h) * p.Sq;
  const float* delta = p.delta + (static_cast<int64_t>(b) * p.H + h) * p.Sq;
  const uint2 seed = read_seed(p.drop);
  const int valid_k = min(kBlockK, p.Sk - k0);

  load_tile<D, LD, kMmaThreads>(Ks, k + k0 * p.k_ss, p.k_ss, valid_k, p.vec16);
  load_tile<D, LD, kMmaThreads>(Vs, v + k0 * p.v_ss, p.v_ss, valid_k, p.vec16);
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t kf[kSteps][4], vf[kSteps][4];
  load_a_frags<kSteps, LD>(kf, Ks, r0);
  load_a_frags<kSteps, LD>(vf, Vs, r0);
  const int keys[2] = {k0 + r0 + g, k0 + r0 + g + 8};

  float dk[kTilesO][4], dv[kTilesO][4];
#pragma unroll
  for (int i = 0; i < kTilesO; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int n_q = (p.Sq + kBlockQ - 1) / kBlockQ;
  for (int qt = first_q_tile(p, k0); qt < n_q; ++qt) {
    const int q0 = qt * kBlockQ;
    const int valid_q = min(kBlockQ, p.Sq - q0);
    __syncthreads();  // the last tile's Q, dO, lse, delta are consumed
    load_tile<D, LD, kMmaThreads>(Qs, q + q0 * p.q_ss, p.q_ss, valid_q,
                                  p.vec16);
    load_tile<D, LD, kMmaThreads>(dOs, dout + q0 * p.do_ss, p.do_ss, valid_q,
                                  p.vec16);
    if (threadIdx.x < kBlockQ) {
      const int r = threadIdx.x;
      lse_s[r] = r < valid_q ? lse[q0 + r] : 0.f;
      delta_s[r] = r < valid_q ? delta[q0 + r] : 0.f;
    }
    __syncthreads();

    // element e of fragment nt: key keys[e/2], query q0 + nt*8 + 2t + e%2
    float st[kTilesS][4], dpt[kTilesS][4];
    mma_abt<kSteps, kTilesS, LD>(st, kf, Qs);
    mma_abt<kSteps, kTilesS, LD>(dpt, vf, dOs);
    // in place: st becomes p * keep (the A operand of dV), dpt becomes ds
#pragma unroll
    for (int nt = 0; nt < kTilesS; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int lq = nt * 8 + 2 * t;
        float f0, f1;
        drop_factor_queries(p.drop, seed, b, h, q0 + lq, keys[hr], p.Sq, p.Sk,
                            f0, f1);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * hr + j;
          const float f = j ? f1 : f0;
          const float pv =
              expf(score(p, bias, st[nt][e] * p.scale, q0 + lq + j, keys[hr]) -
                   lse_s[lq + j]);
          st[nt][e] = pv * f;
          dpt[nt][e] = pv * (dpt[nt][e] * f - delta_s[lq + j]) * p.scale;
        }
      }

    // dV += (p keep)^T dO, dK += ds^T q
#pragma unroll
    for (int j = 0; j < kBlockQ / 16; ++j) {
      uint32_t a[4];
      pack_a<kTilesS>(a, st, j);
      mma_rows<D, LD, kTilesO>(dv, a, dOs, j);
      pack_a<kTilesS>(a, dpt, j);
      mma_rows<D, LD, kTilesO>(dk, a, Qs, j);
    }
  }

  bf16* dkp = static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  bf16* dvp = static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (keys[hr] >= p.Sk) continue;
#pragma unroll
    for (int dt = 0; dt < kTilesO; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + keys[hr] * p.dk_ss + dt * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(dk[dt][2 * hr], dk[dt][2 * hr + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvp + keys[hr] * p.dv_ss + dt * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(dv[dt][2 * hr], dv[dt][2 * hr + 1]);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, int tiles,
           const BwdParams& p, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles, p.H, p.B);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// fills p from the C arguments; false when they are refused
bool make_params(BwdParams& p, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const void* lse, void* delta,
                 const void* bias, const void* keep, const void* seed,
                 void* dq, void* dk, void* dv, int B, int H, int Sq, int Sk,
                 const void* strides, float scale, int causal,
                 unsigned int thresh, float rinv, int dtype) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || H > 65535 || B > 65535)
    return false;
  if (keep != nullptr && seed != nullptr) return false;
  const int64_t* st = static_cast<const int64_t*>(strides);
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.bias = static_cast<const float*>(bias);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = st[0]; p.q_sh = st[1]; p.q_ss = st[2];
  p.k_sb = st[3]; p.k_sh = st[4]; p.k_ss = st[5];
  p.v_sb = st[6]; p.v_sh = st[7]; p.v_ss = st[8];
  p.o_sb = st[9]; p.o_sh = st[10]; p.o_ss = st[11];
  p.do_sb = st[12]; p.do_sh = st[13]; p.do_ss = st[14];
  p.dq_sb = st[15]; p.dq_sh = st[16]; p.dq_ss = st[17];
  p.dk_sb = st[18]; p.dk_sh = st[19]; p.dk_ss = st[20];
  p.dv_sb = st[21]; p.dv_sh = st[22]; p.dv_ss = st[23];
  p.bias_sb = st[24]; p.bias_sh = st[25]; p.bias_sq = st[26];
  p.bias_sk = st[27];
  p.drop.keep = static_cast<const uint8_t*>(keep);
  p.drop.sb = st[28]; p.drop.sh = st[29]; p.drop.sq = st[30];
  p.drop.sk = st[31];
  p.drop.seed = static_cast<const int64_t*>(seed);
  p.drop.thresh = thresh;
  p.drop.rinv = rinv;
  p.drop.mode = keep ? kMaskDrop : seed ? kSeedDrop : kNoDrop;
  p.scale = scale;
  p.causal = causal;
  bool vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % 8 == 0;
  for (int i = 12; i < 15; ++i) vec = vec && st[i] % 8 == 0;
  p.vec16 = vec;
  if (dtype == 1) {
    // the bf16 epilogues store bf16 pairs: gradient rows 4-byte aligned
    const void* outs[3] = {dq, dk, dv};
    for (const void* ptr : outs)
      if (ptr != nullptr && reinterpret_cast<uintptr_t>(ptr) % 4 != 0)
        return false;
    for (int i = 15; i < 24; ++i)
      if (st[i] % 2 != 0) return false;
  }
  return true;
}

}  // namespace

#define PT_FLASH_BWD_ARGS                                                     \
  const void *q, const void *k, const void *v, const void *o,               \
      const void *dout, const void *lse, void *delta, const void *bias,     \
      const void *keep, const void *seed, void *dq, void *dk, void *dv,     \
      int B, int H, int Sq, int Sk, int D, const void *strides, float scale, \
      int causal, unsigned int thresh, float rinv, int dtype, void *stream

extern "C" int pt_flash_attention_bwd_dq(PT_FLASH_BWD_ARGS) {
  BwdParams p;
  if (!make_params(p, q, k, v, o, dout, lse, delta, bias, keep, seed, dq,
                   nullptr, nullptr, B, H, Sq, Sk, strides, scale, causal,
                   thresh, rinv, dtype))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (Sq + kBlockQ - 1) / kBlockQ;
  if (dtype == 0 && D == 64)
    return launch(flash_bwd_dq_simt_kernel<64>, kSimtThreads,
                  simt_bwd_smem_bytes<64>(), tiles, p, s);
  if (dtype == 0 && D == 128)
    return launch(flash_bwd_dq_simt_kernel<128>, kSimtThreads,
                  simt_bwd_smem_bytes<128>(), tiles, p, s);
  if (dtype == 1 && D == 64)
    return launch(flash_bwd_dq_mma_kernel<64>, kMmaThreads,
                  mma_bwd_smem_bytes<64>(), tiles, p, s);
  if (dtype == 1 && D == 128)
    return launch(flash_bwd_dq_mma_kernel<128>, kMmaThreads,
                  mma_bwd_smem_bytes<128>(), tiles, p, s);
  return cudaErrorInvalidValue;
}

extern "C" int pt_flash_attention_bwd_dkv(PT_FLASH_BWD_ARGS) {
  BwdParams p;
  if (!make_params(p, q, k, v, o, dout, lse, delta, bias, keep, seed,
                   nullptr, dk, dv, B, H, Sq, Sk, strides, scale, causal,
                   thresh, rinv, dtype))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (Sk + kBlockK - 1) / kBlockK;
  if (dtype == 0 && D == 64)
    return launch(flash_bwd_dkv_simt_kernel<64>, kSimtThreads,
                  simt_bwd_smem_bytes<64>(), tiles, p, s);
  if (dtype == 0 && D == 128)
    return launch(flash_bwd_dkv_simt_kernel<128>, kSimtThreads,
                  simt_bwd_smem_bytes<128>(), tiles, p, s);
  if (dtype == 1 && D == 64)
    return launch(flash_bwd_dkv_mma_kernel<64>, kMmaThreads,
                  mma_bwd_smem_bytes<64>(), tiles, p, s);
  if (dtype == 1 && D == 128)
    return launch(flash_bwd_dkv_mma_kernel<128>, kMmaThreads,
                  mma_bwd_smem_bytes<128>(), tiles, p, s);
  return cudaErrorInvalidValue;
}
