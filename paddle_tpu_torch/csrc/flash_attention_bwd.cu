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
// owns a tile of queries and walks the k tiles for dQ (up to the last key
// its rows can see), and another owns a tile of keys and walks the q tiles
// from the first one that can see it for dK and dV. Every sum stays in one
// block: no atomics, and the result is the same from run to run. The dQ
// kernel also computes delta for its rows and writes it to device memory;
// the dK/dV kernel, launched after it on the same stream, reads it. The
// dK/dV kernel works on transposed scores s^T = k q^T, so that its rows are
// its keys; there the bias and the keep mask are read with query and key
// swapped, and a [B,1,1,S] padding bias (stride 0 along q) is read per row.
//
// What bounds it on the H100 (chip_smoke.py bwd_work, [32,12,512,64]
// bf16): each kernel moves 0.153 GB; the dQ kernel does 38.7 GFLOP (s,
// dp, ds k) and the dK/dV kernel 51.5 (s, dp, dV, dK), so the dQ kernel
// is bound by bytes (0.0455 ms) and the dK/dV kernel by tensor-core
// operations (0.0521 ms). Both sit
// near the ridge, so the design keeps the tensor cores fed and moves each
// tile once:
//
// - bfloat16: every product is a wgmma (bf16 in, fp32 accumulate) on
//   64-row tiles, a CTA one warpgroup. In the dQ kernel
//   s = q k^T and dp = dO v^T read both operands from shared memory, and
//   dQ += ds k takes ds from registers with k as an MN-major operand. In
//   the dK/dV kernel the accumulators of s^T = k q^T and dp^T = v dO^T turn
//   in registers into the A operands of dV += (p keep)^T dO and
//   dK += ds^T q, so p and ds never pass through shared memory. The fixed
//   operand (q and dO in the dQ kernel, k and v in the dK/dV kernel) is
//   loaded once; the moving one streams through a ring of kStages tiles by
//   cp.async, the next tile in flight while the tensor cores work on this
//   one, in the 128-byte-swizzled layout that the wgmma descriptors read
//   (a D = 64 bf16 row is one 128-byte line). A [B,1,1,S] bias, lse and
//   delta arrive per tile in the same ring; a full bias is read per score.
//   p = exp2(s * scale * log2(e) + (bias - lse) * log2(e)): one FMA and
//   one exp2 a score. Seed-mode dropout runs Philox once per 2 x 2 group
//   and uses all four words: a lane computes one group and trades its
//   four bits with lane ^ 4, which holds the other query (dQ) or key
//   (dK/dV) of each pair; mask mode reads a row's two keys as one 2-byte
//   load. One warpgroup a CTA, owning 64 rows, and a ring of two stages
//   beat, on the H100, two warpgroups a CTA (an SM then holds one CTA,
//   against three, and the two warpgroups run in lockstep between the
//   tile barriers) and a third stage (loads are not the limit). What is
//   left bounds the kernels by the issue of the per-score arithmetic, so
//   each kernel is compiled per dropout mode and bias layout: no score
//   pays for a branch it does not take.
//   The wgmma and cp.async pieces are shared with the forward, in
//   flash_wgmma.cuh.
// - float32: the CUDA cores, fp32 FMA, 256 threads with 4 x 4 score and
//   4 x D/16 accumulator slices each; the scores pass through shared
//   memory (not yet register-tiled like the forward's fp32 kernel).
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
// [B,H,Sq] fp32. In bf16, q, k, v, o and dout must start on 16 bytes and
// have strides that are multiples of 8 elements (cp.async moves 16-byte
// chunks); the wrapper copies an input that does not. keep (uint8, 1 =
// keep) selects mask mode, seed (one int64 in device memory) seed mode.
// dtype codes: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launch (0 on success).
#include "flash_wgmma.cuh"

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

// k tiles a block of `rows` queries from q0 needs (causal: up to the last
// key its last row can see)
__device__ __forceinline__ int visible_k_tiles(const BwdParams& p, int q0,
                                               int rows) {
  int n = (p.Sk + kBlockK - 1) / kBlockK;
  if (p.causal) {
    const int last = min(q0 + rows, p.Sq) - 1 + (p.Sk - p.Sq);
    n = last < 0 ? 0 : min(n, last / kBlockK + 1);
  }
  return n;
}

// the first q tile that can see a k tile starting at k0
__device__ __forceinline__ int first_q_tile(const BwdParams& p, int k0) {
  return p.causal ? max(k0 - (p.Sk - p.Sq), 0) / kBlockQ : 0;
}

// delta = rowsum(dO * o) of fp32 rows [q0, q0 + valid) of this (b, h), 4
// threads a row (blockDim.x / 4 rows at a time); into delta_s and device
// memory
template <int D>
__device__ __forceinline__ void row_delta(const BwdParams& p, const float* o,
                                          const float* dout, int b, int h,
                                          int q0, int valid,
                                          float* delta_s) {
  for (int base = 0; base < kBlockQ; base += blockDim.x / 4) {
    const int r = base + threadIdx.x / 4, part = threadIdx.x % 4;
    float s = 0.f;
    if (r < valid) {
      const float* orow = o + (q0 + r) * p.o_ss;
      const float* drow = dout + (q0 + r) * p.do_ss;
      for (int c = part; c < D; c += 4) s += orow[c] * drow[c];
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
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

constexpr int kSimtThreads = 256;

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
  row_delta<D>(p, o, dout, b, h, q0, valid_q, delta_s);
  if (tid < kBlockQ)
    lse_s[tid] = tid < valid_q
                     ? p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + q0 + tid]
                     : 0.f;

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int n_tiles = visible_k_tiles(p, q0, kBlockQ);
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
// bfloat16: wgmma kernels fed by a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;  // one warpgroup a CTA
constexpr int kStages = 2;     // ring of streamed tiles
static_assert(kThreads == kWarpgroup, "one warpgroup a CTA");

template <int D>
struct DqSmem {  // byte offsets from a 1024-byte-aligned base
  static constexpr int kTileBytes = kTile * D * 2;
  static constexpr int Q = 0;
  static constexpr int dO = Q + kTileBytes;
  static constexpr int K = dO + kTileBytes;  // kStages tiles
  static constexpr int V = K + kStages * kTileBytes;
  static constexpr int bias = V + kStages * kTileBytes;  // kStages x kTile
  static constexpr int delta = bias + kStages * kTile * 4;
  static constexpr int bytes = delta + kTile * 4 + 1024;  // + alignment
};

template <int D>
struct DkvSmem {
  static constexpr int kTileBytes = kTile * D * 2;
  static constexpr int K = 0;
  static constexpr int V = K + kTileBytes;
  static constexpr int Q = V + kTileBytes;  // kStages tiles
  static constexpr int dO = Q + kStages * kTileBytes;
  static constexpr int lse = dO + kStages * kTileBytes;  // kStages x kTile
  static constexpr int delta = lse + kStages * kTile * 4;
  static constexpr int bias = delta + kStages * kTile * 4;  // kTile
  static constexpr int bytes = bias + kTile * 4 + 1024;
};

// delta = rowsum(dO * o) of rows [q0, q0 + valid) of this (b, h), D / 8
// threads a row, each one 16-byte chunk, every load issued before the
// first sum; into delta_s[0, kTile) and device memory
template <int D>
__device__ __forceinline__ void rows_delta(const BwdParams& p, const bf16* o,
                                           const bf16* dout, int b, int h,
                                           int q0, int valid,
                                           float* delta_s) {
  constexpr int TPR = D / 8;
  constexpr int kPasses = kTile * TPR / kThreads;
  const int part = threadIdx.x % TPR, r0 = threadIdx.x / TPR;
  uint4 ov[kPasses], dv[kPasses];
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int r = r0 + i * (kThreads / TPR);
    ov[i] = dv[i] = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) {
      ov[i] = *reinterpret_cast<const uint4*>(o + (q0 + r) * p.o_ss +
                                              part * 8);
      dv[i] = *reinterpret_cast<const uint4*>(dout + (q0 + r) * p.do_ss +
                                              part * 8);
    }
  }
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int r = r0 + i * (kThreads / TPR);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov[i]);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv[i]);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 of = __bfloat1622float2(o2[k]);
      const float2 df = __bfloat1622float2(d2[k]);
      s = fmaf(of.x, df.x, fmaf(of.y, df.y, s));
    }
#pragma unroll
    for (int m = TPR / 2; m > 0; m /= 2)
      s += __shfl_xor_sync(0xffffffffu, s, m);
    if (part == 0) {
      delta_s[r] = s;
      if (r < valid)
        p.delta[(static_cast<int64_t>(b) * p.H + h) * p.Sq + q0 + r] = s;
    }
  }
}

// The dQ kernel: one CTA (a warpgroup) owns 64 queries and walks the key
// tiles they can see. DROP is the dropout mode and
// FULL_BIAS says the bias has a stride along the queries (read per score);
// a [B,1,1,S] bias is staged per key tile.
template <int D, int DROP, bool FULL_BIAS>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wgmma_kernel(const BwdParams p) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t base = aligned_smem(smem_raw, sm);
  const float* bias_s = reinterpret_cast<const float*>(sm + L::bias);
  float* delta_s = reinterpret_cast<float*>(sm + L::delta);

  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* o = static_cast<const bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* bias =
      p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const bool row_bias = !FULL_BIAS && bias != nullptr;
  const uint2 seed = read_seed(p.drop);
  const int valid_q = min(kTile, p.Sq - q0);
  const int n_tiles = visible_k_tiles(p, q0, kTile);

  // the fixed tiles, then the first kStages - 1 streamed ones, one group
  // each
  tile_async<D>(base + L::Q, q + q0 * p.q_ss, p.q_ss, valid_q);
  tile_async<D>(base + L::dO, dout + q0 * p.do_ss, p.do_ss, valid_q);
  auto issue = [&](int kt) {
    const int st = kt % kStages, k0 = kt * kTile;
    const int valid = min(kTile, p.Sk - k0);
    tile_async<D>(base + L::K + st * L::kTileBytes, k + k0 * p.k_ss, p.k_ss,
                  valid);
    tile_async<D>(base + L::V + st * L::kTileBytes, v + k0 * p.v_ss, p.v_ss,
                  valid);
    if (row_bias)
      vec_async(base + L::bias + st * kTile * 4, bias + k0 * p.bias_sk,
                p.bias_sk, valid);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  // this thread's rows: g and g + 8 of its warp's 16
  const int r_loc = threadIdx.x / 32 * 16 + g;
  int rows[2], kmax[2];
  float lse2[2];
  const float* brow[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rows[hr] = q0 + r_loc + 8 * hr;
    const bool in = rows[hr] < p.Sq;
    lse2[hr] = in ? p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq +
                          rows[hr]] * kLog2e
                  : 0.f;
    // keys [0, kmax) are visible to the row
    kmax[hr] = !in ? 0
               : p.causal ? max(0, min(p.Sk, rows[hr] + (p.Sk - p.Sq) + 1))
                          : p.Sk;
    brow[hr] = FULL_BIAS ? bias + rows[hr] * p.bias_sq : nullptr;
  }
  rows_delta<D>(p, o, dout, b, h, q0, valid_q, delta_s);
  __syncthreads();  // delta_s
  // delta * scale: ds = p (dp keep scale - delta scale)
  const float dsc[2] = {delta_s[r_loc] * p.scale,
                        delta_s[r_loc + 8] * p.scale};
  const float scale_log2 = p.scale * kLog2e;
  const float kept = (DROP == kNoDrop ? 1.f : p.drop.rinv) * p.scale;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + kStages - 1 < n_tiles) issue(kt + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile kt (and Q, dO) landed
    fence_proxy_async();
    __syncthreads();
    const int st = kt % kStages, k0 = kt * kTile;
    const uint32_t kb = base + L::K + st * L::kTileBytes;
    const uint32_t vb = base + L::V + st * L::kTileBytes;

    // element 4j + 2hr + e: query rows[hr], key k0 + 8j + 2t + e
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    pin(s);
    pin(dp);
    wgmma_fence();
    scores<D>(s, base + L::Q, kb);
    wgmma_commit();
    scores<D>(dp, base + L::dO, vb);
    wgmma_commit();
    // while the tensor cores work: the keep bits, bit i for element i
    uint32_t keep = 0xFFFFFFFFu;
    if (DROP != kNoDrop) {
      keep = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint2 bits = paired_bits<DROP>(
            p.drop, seed, b, h, rows[0] + 8 * (g & 1), k0 + 8 * j + 2 * t,
            p.Sq, p.Sk, g);
        // this lane's rows have the query parity of g: bits 2(g & 1) + e
        keep |= ((bits.x >> (2 * (g & 1))) & 3u) << (4 * j) |
                ((bits.y >> (2 * (g & 1))) & 3u) << (4 * j + 2);
      }
    }
    wgmma_wait<1>();
    pin(s);
    // p = exp2(s scale log2(e) + (bias - lse) log2(e)), 0 where masked
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = k0 + 8 * j + 2 * t + e;
        const float bl = row_bias
                             ? bias_log2(bias_s[st * kTile + 8 * j + 2 * t + e])
                             : 0.f;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 4 * j + 2 * hr + e;
          const bool vis = kc < kmax[hr];
          float x = bl - lse2[hr];
          if (FULL_BIAS && vis) x += bias_log2(brow[hr][kc * p.bias_sk]);
          s[i] = vis ? fast_exp2(fmaf(s[i], scale_log2, x)) : 0.f;
        }
      }
    wgmma_wait<0>();
    pin(dp);
    // ds = p (dp keep - delta) scale, into s
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float fs = (keep >> i) & 1u ? kept : 0.f;
      s[i] *= fmaf(dp[i], fs, -dsc[(i / 2) % 2]);
    }
    uint32_t a[4][4];
    to_a_frags(a, s);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], mnmajor_desc(kb, kk));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

  // element 4n + 2hr + e of acc: row rows[hr], column 8n + 2t + e
  bf16* dq = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (rows[hr] >= p.Sq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dq + rows[hr] * p.dq_ss + 8 * n +
                                         2 * t) =
          __floats2bfloat162_rn(acc[4 * n + 2 * hr], acc[4 * n + 2 * hr + 1]);
  }
}

// The dK/dV kernel: one CTA (a warpgroup) owns 64 keys and walks the
// query tiles that can see them, on transposed scores (rows are keys).
template <int D, int DROP, bool FULL_BIAS>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wgmma_kernel(const BwdParams p) {
  using L = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t base = aligned_smem(smem_raw, sm);

  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* bias =
      p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const bool row_bias = !FULL_BIAS && bias != nullptr;
  const float* lse = p.lse + (static_cast<int64_t>(b) * p.H + h) * p.Sq;
  const float* delta = p.delta + (static_cast<int64_t>(b) * p.H + h) * p.Sq;
  const uint2 seed = read_seed(p.drop);
  const int valid_k = min(kTile, p.Sk - k0);
  const int qt0 = first_q_tile(p, k0);
  const int n_tiles = (p.Sq + kTile - 1) / kTile - qt0;

  tile_async<D>(base + L::K, k + k0 * p.k_ss, p.k_ss, valid_k);
  tile_async<D>(base + L::V, v + k0 * p.v_ss, p.v_ss, valid_k);
  if (row_bias)
    vec_async(base + L::bias, bias + k0 * p.bias_sk, p.bias_sk, valid_k);
  auto issue = [&](int i) {
    const int st = i % kStages, q0 = (qt0 + i) * kTile;
    const int valid = min(kTile, p.Sq - q0);
    tile_async<D>(base + L::Q + st * L::kTileBytes, q + q0 * p.q_ss, p.q_ss,
                  valid);
    tile_async<D>(base + L::dO + st * L::kTileBytes, dout + q0 * p.do_ss,
                  p.do_ss, valid);
    vec_async(base + L::lse + st * kTile * 4, lse + q0, 1, valid);
    vec_async(base + L::delta + st * kTile * 4, delta + q0, 1, valid);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  // this thread's keys: g and g + 8 of its warp's 16
  const int r_loc = threadIdx.x / 32 * 16 + g;
  int keys[2], qmin[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    keys[hr] = k0 + r_loc + 8 * hr;
    // queries [qmin, Sq) see the key; none when it is past Sk
    qmin[hr] = keys[hr] >= p.Sk ? p.Sq
               : p.causal       ? keys[hr] - (p.Sk - p.Sq)
                                : 0;
  }
  const float scale_log2 = p.scale * kLog2e;
  const float rinv = DROP == kNoDrop ? 1.f : p.drop.rinv;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + kStages - 1 < n_tiles) issue(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile it (and K, V, the bias) landed
    fence_proxy_async();
    __syncthreads();
    const int st = it % kStages, q0 = (qt0 + it) * kTile;
    const uint32_t qb = base + L::Q + st * L::kTileBytes;
    const uint32_t ob = base + L::dO + st * L::kTileBytes;
    const float* lse_s = reinterpret_cast<const float*>(sm + L::lse) +
                         st * kTile;
    const float* delta_s = reinterpret_cast<const float*>(sm + L::delta) +
                           st * kTile;

    // element 4j + 2hr + e: key keys[hr], query q0 + 8j + 2t + e
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    pin(s);
    pin(dp);
    wgmma_fence();
    scores<D>(s, base + L::K, qb);
    wgmma_commit();
    scores<D>(dp, base + L::V, ob);
    wgmma_commit();
    // while the tensor cores work: the keep bits, bit i for element i
    uint32_t keep = 0xFFFFFFFFu;
    if (DROP != kNoDrop) {
      keep = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint2 bits = paired_bits<DROP>(
            p.drop, seed, b, h, q0 + 8 * j + 2 * t, keys[0] + 8 * (g & 1),
            p.Sq, p.Sk, g);
        // this lane's keys have the parity of g: bits 2e + (g & 1)
        const uint32_t w0 = bits.x >> (g & 1), w1 = bits.y >> (g & 1);
        keep |= ((w0 & 1u) | (w0 >> 1 & 2u)) << (4 * j) |
                ((w1 & 1u) | (w1 >> 1 & 2u)) << (4 * j + 2);
      }
    }
    wgmma_wait<1>();
    pin(s);
    float bl[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      bl[hr] = row_bias ? bias_log2(reinterpret_cast<const float*>(
                              sm + L::bias)[r_loc + 8 * hr])
                        : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e, qq = q0 + c;
        const float l2 = lse_s[c] * kLog2e;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 4 * j + 2 * hr + e;
          const bool vis = qq >= qmin[hr] && qq < p.Sq;
          float x = bl[hr] - l2;
          if (FULL_BIAS && vis)
            x += bias_log2(bias[qq * p.bias_sq + keys[hr] * p.bias_sk]);
          s[i] = vis ? fast_exp2(fmaf(s[i], scale_log2, x)) : 0.f;
        }
      }
    wgmma_wait<0>();
    pin(dp);
    // dp becomes ds = p (dp keep - delta) scale, s becomes p keep
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dsc = delta_s[8 * j + 2 * t + e] * p.scale;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 4 * j + 2 * hr + e;
          const float f = (keep >> i) & 1u ? rinv : 0.f;
          dp[i] = s[i] * fmaf(dp[i], f * p.scale, -dsc);
          s[i] *= f;
        }
      }
    uint32_t ap[4][4], ads[4][4];
    to_a_frags(ap, s);
    to_a_frags(ads, dp);
    pin(dv);
    pin(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dv, ap[kk], mnmajor_desc(ob, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dk, ads[kk], mnmajor_desc(qb, kk));
    wgmma_commit();
    wgmma_wait<0>();
    pin(dv);
    pin(dk);
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

  bf16* dkp = static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  bf16* dvp = static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (keys[hr] >= p.Sk) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + keys[hr] * p.dk_ss + 8 * n +
                                         2 * t) =
          __floats2bfloat162_rn(dk[4 * n + 2 * hr], dk[4 * n + 2 * hr + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvp + keys[hr] * p.dv_ss + 8 * n +
                                         2 * t) =
          __floats2bfloat162_rn(dv[4 * n + 2 * hr], dv[4 * n + 2 * hr + 1]);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, int tiles,
           const BwdParams& p, cudaStream_t stream) {
  const cudaError_t err = prepare(kernel, smem);
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
  if (dtype == 1) {
    // cp.async and the delta pass move 16-byte chunks of q, k, v, o, dout
    const void* ins[5] = {q, k, v, o, dout};
    for (const void* ptr : ins)
      if (!aligned16(ptr)) return false;
    for (int i = 0; i < 15; ++i)
      if (st[i] % 8 != 0) return false;
    // the epilogues store bf16 pairs: gradient rows 4-byte aligned
    const void* outs[3] = {dq, dk, dv};
    for (const void* ptr : outs)
      if (ptr != nullptr && reinterpret_cast<uintptr_t>(ptr) % 4 != 0)
        return false;
    for (int i = 15; i < 24; ++i)
      if (st[i] % 2 != 0) return false;
  }
  return true;
}

// the dQ (dq) or the dK/dV kernel in its instance for this dropout mode
// and bias layout
template <int D, int DROP, bool FULL_BIAS>
int launch_wgmma(bool dq, const BwdParams& p, cudaStream_t stream) {
  if (dq)
    return launch(flash_bwd_dq_wgmma_kernel<D, DROP, FULL_BIAS>, kThreads,
                  DqSmem<D>::bytes, (p.Sq + kTile - 1) / kTile, p, stream);
  return launch(flash_bwd_dkv_wgmma_kernel<D, DROP, FULL_BIAS>, kThreads,
                DkvSmem<D>::bytes, (p.Sk + kTile - 1) / kTile, p, stream);
}

template <int D>
int launch_wgmma(bool dq, const BwdParams& p, cudaStream_t stream) {
  const bool full = p.bias != nullptr && p.bias_sq != 0;
  switch (p.drop.mode * 2 + full) {
    case 0: return launch_wgmma<D, kNoDrop, false>(dq, p, stream);
    case 1: return launch_wgmma<D, kNoDrop, true>(dq, p, stream);
    case 2: return launch_wgmma<D, kMaskDrop, false>(dq, p, stream);
    case 3: return launch_wgmma<D, kMaskDrop, true>(dq, p, stream);
    case 4: return launch_wgmma<D, kSeedDrop, false>(dq, p, stream);
    case 5: return launch_wgmma<D, kSeedDrop, true>(dq, p, stream);
  }
  return cudaErrorInvalidValue;
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
  if (dtype == 1 && D == 64) return launch_wgmma<64>(true, p, s);
  if (dtype == 1 && D == 128) return launch_wgmma<128>(true, p, s);
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
  if (dtype == 1 && D == 64) return launch_wgmma<64>(false, p, s);
  if (dtype == 1 && D == 128) return launch_wgmma<128>(false, p, s);
  return cudaErrorInvalidValue;
}
