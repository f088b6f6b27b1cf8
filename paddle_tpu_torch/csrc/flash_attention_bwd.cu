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
// - bfloat16 and float16 (one template, E the input type): every product
//   is a wgmma (E in, fp32 accumulate) on 64-row tiles, a CTA one
//   warpgroup. In the dQ kernel
//   s = q k^T and dp = dO v^T read both operands from shared memory, and
//   dQ += ds k takes ds from registers with k as an MN-major operand. In
//   the dK/dV kernel the accumulators of s^T = k q^T and dp^T = v dO^T turn
//   in registers into the A operands of dV += (p keep)^T dO and
//   dK += ds^T q, so p and ds never pass through shared memory. The fixed
//   operand (q and dO in the dQ kernel, k and v in the dK/dV kernel) is
//   loaded once; the moving one streams through a ring of kStages tiles by
//   cp.async, the next tile in flight while the tensor cores work on this
//   one, in the 128-byte-swizzled layout that the wgmma descriptors read
//   (a D = 64 row of 16-bit values is one 128-byte line). A [B,1,1,S]
//   bias, lse and delta arrive per tile in the same ring; a full bias is
//   read per score.
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
//   each kernel is compiled per dropout mode, bias layout, D and input
//   type: no score pays for a branch it does not take. (Tiling measured in
//   bf16.) At D 256 a thread of the dQ kernel holds 128 fp32 of dQ (one
//   m64n256k16 a k-step); dK and dV (2 x 128) fit no single warpgroup, so
//   the dK/dV kernel runs two warpgroups on the same 64 keys, one for dV
//   and one for dK (dkv_roles; against a grid over D halves, see PERF.md).
//   The wgmma and cp.async pieces are shared with the forward, in
//   flash_wgmma.cuh.
// - float32: the CUDA cores, fp32 FMA (no TF32), register-tiled like the
//   forward's fp32 kernel (F32Tiling): a lane owns an R x C slice of the
//   scores (s and dp, or s^T and dp^T) and the accumulators of its R rows
//   at D / 8 columns. Every tile sits in shared memory d-major in a
//   swizzle that keeps a lane's 16-byte loads free of bank conflicts; the
//   streamed tiles come through a two-stage cp.async ring. p, p keep and ds
//   stay in the registers of the lane that computed them and reach the
//   lanes that multiply them into k, dO or q by warp shuffles: no score
//   passes through shared memory. p = exp2 of one FMA, and one group_bits
//   call a 2 x 2 group, as in the tensor-core kernels. What bounds them:
//   fp32 operations at 67 TFLOP/s (6 Sq Sk D and 8 Sq Sk D a head).
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
// [B,H,Sq] fp32. In bf16 and fp16, q, k, v, o and dout must start on 16
// bytes and have strides that are multiples of 8 elements (cp.async moves
// 16-byte chunks); the wrapper copies an input that does not. keep
// (uint8, 1 = keep) selects mask mode, seed (one int64 in device memory)
// seed mode.
// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16. Returns the
// cudaError_t of the launch (0 on success).
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

// keys [0, n) are visible to query row `row`; none past Sq
__device__ __forceinline__ int visible_keys(const BwdParams& p, int row) {
  if (row >= p.Sq) return 0;
  return p.causal ? max(0, min(p.Sk, row + (p.Sk - p.Sq) + 1)) : p.Sk;
}

// queries [n, Sq) see key `key`; none (Sq) past Sk
__device__ __forceinline__ int first_query(const BwdParams& p, int key) {
  if (key >= p.Sk) return p.Sq;
  return p.causal ? max(0, key - (p.Sk - p.Sq)) : 0;
}

// key tiles of COLS that a block of `rows` queries from q0 needs: up to
// the last key its last row can see
template <int COLS = kBlockK>
__device__ __forceinline__ int visible_k_tiles(const BwdParams& p, int q0,
                                               int rows) {
  return (visible_keys(p, min(q0 + rows, p.Sq) - 1) + COLS - 1) / COLS;
}

// the first query tile of COLS that can see a key tile starting at k0
template <int COLS = kBlockQ>
__device__ __forceinline__ int first_q_tile(const BwdParams& p, int k0) {
  return p.causal ? max(k0 - (p.Sk - p.Sq), 0) / COLS : 0;
}

// ---------------------------------------------------------------------------
// float32: register-tiled CUDA-core kernels
// ---------------------------------------------------------------------------

// Tiling a head dim. A CTA of W warps owns ROWS = 4 R W rows (queries in
// the dQ kernel, keys in the dK/dV kernel) and streams tiles of COLS = 8 C
// columns (keys, queries); a warp owns 4 R rows, and lane (rg, cg) =
// (lane / 8, lane % 8) the scores of rows R rg .. R rg + R - 1 of the warp
// and columns C cg .. C cg + C - 1 of the tile, and the accumulators of its
// rows at columns 8 c + cg, c < D / 8. Every tile sits in shared memory
// d-major, so a lane reads its R rows and C columns of one d in one or two
// 16-byte loads. Two stages of the streamed tiles; the shared memory of a
// CTA is 4 (2 ROWS + 4 COLS) D bytes. D 64: 64 rows and 32 columns, 64 KB,
// three CTAs an SM; on the H100 (PERF.md, §6) this beat 64 columns
// (96 KB, two CTAs: dQ 13% and dK/dV 3% slower) and R = 2 with 8 warps
// (1.6x slower), and unrolling further gained nothing: latency, not
// issue, limits these kernels. D 128: R = 2 and 8 warps (192 KB, one
// CTA); D 256: 32 rows and 32 columns, so that two stages fit.
template <int D>
struct F32Tiling;
template <>
struct F32Tiling<64> {
  static constexpr int R = 4, C = 4, W = 4;
};
template <>
struct F32Tiling<128> {
  static constexpr int R = 2, C = 8, W = 8;
};
template <>
struct F32Tiling<256> {
  static constexpr int R = 2, C = 4, W = 4;
};

template <int D>
struct F32Bwd : F32Tiling<D> {
  using T = F32Tiling<D>;
  static constexpr int kThreads = 32 * T::W;
  static constexpr int ROWS = 4 * T::R * T::W;
  static constexpr int COLS = 8 * T::C;
  // float offsets: two fixed d-major [D][ROWS] tiles, two stages of two
  // streamed d-major [D][COLS] tiles, then two stages of COLS floats for
  // each of two vectors (the dQ kernel: the [B,1,1,S] bias; the dK/dV
  // kernel: lse and delta) and ROWS floats (delta of the dQ kernel's rows)
  static constexpr int A0 = 0, A1 = D * ROWS;
  static constexpr int S0 = 2 * D * ROWS;  // stage st, tile t: + (2st + t)
  static constexpr int kStreamed = D * COLS;
  static constexpr int V0 = S0 + 4 * kStreamed;  // vector v, stage st:
  static constexpr int V1 = V0 + 2 * COLS;       //   Vv + st COLS
  static constexpr int rows_vec = V1 + 2 * COLS;
  static constexpr int bytes = 4 * (rows_vec + ROWS);
};

// rows [0, valid) of an NR x D fp32 tile (rows of D floats row_stride
// apart) into shared memory at dst, d-major: element (r, d) at float
// d * NR + (r ^ 4 (d % 8)), the rest zero. A warp moves 8 rows x 4 columns
// a pass (16-byte runs of device memory). The swizzle keeps a group of 4
// rows from a multiple of 4 contiguous, and makes the 8 lanes that read
// 4 rows of d = 8 c + cg (cg = 0 .. 7) read 32 distinct banks.
template <int NR, int D, int THREADS>
__device__ __forceinline__ void dmajor_async(uint32_t dst, const float* src,
                                             int64_t row_stride, int valid) {
  constexpr int kRowBlocks = NR / 8;
  const int lane = threadIdx.x % 32;
  const int r_lo = lane % 8, d_lo = lane / 8;
#pragma unroll 4
  for (int blk = threadIdx.x / 32; blk < kRowBlocks * (D / 4);
       blk += THREADS / 32) {
    const int r = (blk % kRowBlocks) * 8 + r_lo;
    const int d = (blk / kRowBlocks) * 4 + d_lo;
    const bool in = r < valid;
    cp_async4(dst + 4 * (d * NR + (r ^ (4 * (d % 8)))),
              in ? src + r * row_stride + d : src, in);
  }
}

// N values of column d of a d-major tile from row (or column) r (a
// multiple of N when N < 4, of 4 otherwise): the swizzled place of every
// group of 4
template <int N, int NR>
__device__ __forceinline__ void dmajor_run(const float* tile, int d, int r,
                                           float (&out)[N]) {
  const float* col = tile + d * NR;
  const int sw = 4 * (d % 8);
  if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(col + (r ^ sw));
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int g = 0; g < N / 4; ++g) {
      const float4 v =
          *reinterpret_cast<const float4*>(col + ((r + 4 * g) ^ sw));
      out[4 * g] = v.x; out[4 * g + 1] = v.y;
      out[4 * g + 2] = v.z; out[4 * g + 3] = v.w;
    }
  }
}

// s += a b^T and t += c e^T over D for a lane's R x C slice: a and c are
// the fixed d-major tiles (rows from r0), b and e the streamed ones
// (columns from c0); per d four loads for 2 R C FMAs
template <int D, int R, int C, int NR, int NC>
__device__ __forceinline__ void slice_products(float (&s)[R][C],
                                               float (&t)[R][C],
                                               const float* a, const float* c,
                                               const float* b, const float* e,
                                               int r0, int c0) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[R], cv[R], bv[C], ev[C];
    dmajor_run<R, NR>(a, d, r0, av);
    dmajor_run<R, NR>(c, d, r0, cv);
    dmajor_run<C, NC>(b, d, c0, bv);
    dmajor_run<C, NC>(e, d, c0, ev);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        t[i][j] = fmaf(cv[i], ev[j], t[i][j]);
      }
  }
}

// acc[i][c] += sum over the tile's COLS columns j of x[row i][j] times
// column j's value at d = 8 c + cg of the d-major tile t (and, with
// SECOND, acc2 += x2 t2 alike). x[row i][j] lives in lane (rg, j / C) as its
// x[i][j % C]: four columns at a time reach this lane by shuffles, and one
// 16-byte load of t gives their values at one d.
template <int D, int R, int C, int NC, bool SECOND>
__device__ __forceinline__ void slice_accumulate(
    float (&acc)[R][D / 8], const float (&x)[R][C], const float* t,
    float (&acc2)[R][D / 8], const float (&x2)[R][C], const float* t2,
    int rg, int cg) {
  const int sw = 4 * cg;  // d % 8 == cg for every column of this lane
#pragma unroll 2
  for (int src = 0; src < 8; ++src) {
#pragma unroll
    for (int g = 0; g < C / 4; ++g) {
      const int j0 = C * src + 4 * g;  // the tile's first column of four
      float xv[R][4], xv2[R][4];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          xv[i][jj] = __shfl_sync(0xffffffffu, x[i][4 * g + jj], rg * 8 + src);
          if (SECOND)
            xv2[i][jj] =
                __shfl_sync(0xffffffffu, x2[i][4 * g + jj], rg * 8 + src);
        }
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const int off = (8 * c + cg) * NC + (j0 ^ sw);
        const float4 tv = *reinterpret_cast<const float4*>(t + off);
#pragma unroll
        for (int i = 0; i < R; ++i)
          acc[i][c] = fmaf(xv[i][3], tv.w, fmaf(xv[i][2], tv.z,
                      fmaf(xv[i][1], tv.y, fmaf(xv[i][0], tv.x, acc[i][c]))));
        if (SECOND) {
          const float4 uv = *reinterpret_cast<const float4*>(t2 + off);
#pragma unroll
          for (int i = 0; i < R; ++i)
            acc2[i][c] = fmaf(xv2[i][3], uv.w, fmaf(xv2[i][2], uv.z,
                         fmaf(xv2[i][1], uv.y,
                              fmaf(xv2[i][0], uv.x, acc2[i][c]))));
        }
      }
    }
  }
}

// delta = rowsum(dO * o) of fp32 rows [q0, q0 + valid) of this (b, h), 4
// threads a row (THREADS / 4 rows at a time); into delta_s[0, ROWS) and
// device memory
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void row_delta(const BwdParams& p, const float* o,
                                          const float* dout, int b, int h,
                                          int q0, int valid,
                                          float* delta_s) {
  for (int base = 0; base < ROWS; base += THREADS / 4) {
    const int r = base + threadIdx.x / 4, part = threadIdx.x % 4;
    float s = 0.f;
    if (r < valid) {
      const float* orow = o + (q0 + r) * p.o_ss;
      const float* drow = dout + (q0 + r) * p.do_ss;
#pragma unroll 4
      for (int c = part; c < D; c += 4) s = fmaf(orow[c], drow[c], s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0 && r < ROWS) {
      delta_s[r] = s;
      if (r < valid)
        p.delta[(static_cast<int64_t>(b) * p.H + h) * p.Sq + q0 + r] = s;
    }
  }
}

// The fp32 dQ kernel: a CTA owns ROWS queries and walks the key tiles they
// can see; Q and dO are fixed, K and V stream (with a [B,1,1,S] bias).
// ds = p (dp keep - delta) scale stays in the registers of the lane that
// computed it and reaches the lanes of dQ += ds k by shuffles.
template <int D, int DROP, bool FULL_BIAS>
__global__ void __launch_bounds__(F32Bwd<D>::kThreads)
flash_bwd_dq_f32_kernel(const BwdParams p) {
  using L = F32Bwd<D>;
  constexpr int R = L::R, C = L::C, ROWS = L::ROWS, COLS = L::COLS;
  constexpr int kThreads = L::kThreads;
  extern __shared__ __align__(16) float smem[];
  const uint32_t base = smem_u32(smem);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / 8, cg = lane % 8;
  const int q0 = blockIdx.x * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* o = static_cast<const float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* bias =
      p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const bool row_bias = !FULL_BIAS && bias != nullptr;
  const uint2 seed = read_seed(p.drop);
  const int valid_q = min(ROWS, p.Sq - q0);
  const int n_tiles = visible_k_tiles<COLS>(p, q0, ROWS);

  // the fixed tiles and the first streamed one in one group
  dmajor_async<ROWS, D, kThreads>(base + 4 * L::A0, q + q0 * p.q_ss, p.q_ss,
                                  valid_q);
  dmajor_async<ROWS, D, kThreads>(base + 4 * L::A1, dout + q0 * p.do_ss,
                                  p.do_ss, valid_q);
  auto issue = [&](int kt) {
    const int st = kt & 1, k0 = kt * COLS, valid = p.Sk - k0;
    dmajor_async<COLS, D, kThreads>(base + 4 * (L::S0 + 2 * st * L::kStreamed),
                                    k + k0 * p.k_ss, p.k_ss, valid);
    dmajor_async<COLS, D, kThreads>(
        base + 4 * (L::S0 + (2 * st + 1) * L::kStreamed), v + k0 * p.v_ss,
        p.v_ss, valid);
    if (row_bias)
      vec_async<kThreads, COLS>(base + 4 * (L::V0 + st * COLS),
                                bias + k0 * p.bias_sk, p.bias_sk, valid);
  };
  if (n_tiles > 0) issue(0);
  cp_async_commit();

  const int r0 = warp * 4 * R + R * rg;  // this lane's first row
  int kmax[R];
  float lse2[R];
  const float* brow[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + r0 + i;
    kmax[i] = visible_keys(p, row);
    lse2[i] = row < p.Sq ? p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq +
                                 row] * kLog2e
                         : 0.f;
    brow[i] = FULL_BIAS ? bias + row * p.bias_sq : nullptr;
  }
  float* delta_s = smem + L::rows_vec;
  row_delta<D, ROWS, kThreads>(p, o, dout, b, h, q0, valid_q, delta_s);
  __syncthreads();  // delta_s
  float dsc[R];  // delta * scale: ds = p (dp keep scale - delta scale)
#pragma unroll
  for (int i = 0; i < R; ++i) dsc[i] = delta_s[r0 + i] * p.scale;
  const float scale_log2 = p.scale * kLog2e;
  const float kept = (DROP == kNoDrop ? 1.f : p.drop.rinv) * p.scale;

  float acc[R][D / 8];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) issue(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile kt (and Q, dO) landed
    __syncthreads();
    const int st = kt & 1, k0 = kt * COLS;
    const float* Ks = smem + L::S0 + 2 * st * L::kStreamed;
    const float* Vs = Ks + L::kStreamed;
    const float* bias_tile = smem + L::V0 + st * COLS;

    float s[R][C], dp[R][C];
    slice_products<D, R, C, ROWS, COLS>(s, dp, smem + L::A0, smem + L::A1,
                                        Ks, Vs, r0, C * cg);
    uint32_t keep = 0xFFFFFFFFu;
    if (DROP != kNoDrop)
      keep = slice_keep_bits<DROP, R, C, false>(p.drop, seed, b, h, q0 + r0,
                                                k0 + C * cg, p.Sq, p.Sk);
    // p = exp2(s scale log2(e) + (bias - lse) log2(e)), 0 where masked;
    // ds = p (dp keep - delta) scale, into s
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int kc = k0 + C * cg + j;
      const float bl = row_bias ? bias_log2(bias_tile[C * cg + j]) : 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const bool vis = kc < kmax[i];
        float x = bl - lse2[i];
        if (FULL_BIAS && vis) x += bias_log2(brow[i][kc * p.bias_sk]);
        const float pv = vis ? fast_exp2(fmaf(s[i][j], scale_log2, x)) : 0.f;
        const float fs = (keep >> (i * C + j)) & 1u ? kept : 0.f;
        s[i][j] = pv * fmaf(dp[i][j], fs, -dsc[i]);
      }
    }
    // dQ += ds k
    slice_accumulate<D, R, C, COLS, false>(acc, s, Ks, acc, s, Ks, rg, cg);
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

  float* dq = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + r0 + i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dq[row * p.dq_ss + 8 * c + cg] = acc[i][c];
  }
}

// The fp32 dK/dV kernel: a CTA owns ROWS keys and walks the query tiles
// that can see them, on transposed scores s^T = k q^T (rows are keys); K
// and V are fixed, Q, dO, lse and delta stream. p keep and ds stay in
// registers and reach the lanes of dV += (p keep)^T dO and dK += ds^T q by
// shuffles.
template <int D, int DROP, bool FULL_BIAS>
__global__ void __launch_bounds__(F32Bwd<D>::kThreads)
flash_bwd_dkv_f32_kernel(const BwdParams p) {
  using L = F32Bwd<D>;
  constexpr int R = L::R, C = L::C, ROWS = L::ROWS, COLS = L::COLS;
  constexpr int kThreads = L::kThreads;
  extern __shared__ __align__(16) float smem[];
  const uint32_t base = smem_u32(smem);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / 8, cg = lane % 8;
  const int k0 = blockIdx.x * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* bias =
      p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const bool row_bias = !FULL_BIAS && bias != nullptr;
  const float* lse = p.lse + (static_cast<int64_t>(b) * p.H + h) * p.Sq;
  const float* delta = p.delta + (static_cast<int64_t>(b) * p.H + h) * p.Sq;
  const uint2 seed = read_seed(p.drop);
  const int valid_k = min(ROWS, p.Sk - k0);
  const int qt0 = first_q_tile<COLS>(p, k0);
  const int n_tiles = (p.Sq + COLS - 1) / COLS - qt0;

  dmajor_async<ROWS, D, kThreads>(base + 4 * L::A0, k + k0 * p.k_ss, p.k_ss,
                                  valid_k);
  dmajor_async<ROWS, D, kThreads>(base + 4 * L::A1, v + k0 * p.v_ss, p.v_ss,
                                  valid_k);
  auto issue = [&](int i) {
    const int st = i & 1, q0 = (qt0 + i) * COLS, valid = p.Sq - q0;
    dmajor_async<COLS, D, kThreads>(base + 4 * (L::S0 + 2 * st * L::kStreamed),
                                    q + q0 * p.q_ss, p.q_ss, valid);
    dmajor_async<COLS, D, kThreads>(
        base + 4 * (L::S0 + (2 * st + 1) * L::kStreamed),
        dout + q0 * p.do_ss, p.do_ss, valid);
    vec_async<kThreads, COLS>(base + 4 * (L::V0 + st * COLS), lse + q0, 1,
                              valid);
    vec_async<kThreads, COLS>(base + 4 * (L::V1 + st * COLS), delta + q0, 1,
                              valid);
  };
  if (n_tiles > 0) issue(0);
  cp_async_commit();

  const int r0 = warp * 4 * R + R * rg;  // this lane's first key
  int qmin[R];
  float bl[R];
  const float* bcol[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + r0 + i;
    qmin[i] = first_query(p, key);
    bl[i] = row_bias && key < p.Sk ? bias_log2(bias[key * p.bias_sk]) : 0.f;
    bcol[i] = FULL_BIAS ? bias + key * p.bias_sk : nullptr;
  }
  const float scale_log2 = p.scale * kLog2e;
  const float rinv = DROP == kNoDrop ? 1.f : p.drop.rinv;

  float dk[R][D / 8], dv[R][D / 8];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile it (and K, V) landed
    __syncthreads();
    const int st = it & 1, q0 = (qt0 + it) * COLS;
    const float* Qs = smem + L::S0 + 2 * st * L::kStreamed;
    const float* dOs = Qs + L::kStreamed;
    const float* lse_s = smem + L::V0 + st * COLS;
    const float* delta_s = smem + L::V1 + st * COLS;

    // s^T = k q^T and dp^T = v dO^T: key r0 + i, query q0 + C cg + j
    float s[R][C], dp[R][C];
    slice_products<D, R, C, ROWS, COLS>(s, dp, smem + L::A0, smem + L::A1,
                                        Qs, dOs, r0, C * cg);
    uint32_t keep = 0xFFFFFFFFu;
    if (DROP != kNoDrop)
      keep = slice_keep_bits<DROP, R, C, true>(p.drop, seed, b, h, k0 + r0,
                                               q0 + C * cg, p.Sq, p.Sk);
    // s becomes p keep, dp becomes ds = p (dp keep - delta) scale
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int qq = q0 + C * cg + j;
      const float l2 = lse_s[C * cg + j] * kLog2e;
      const float dsc = delta_s[C * cg + j] * p.scale;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const bool vis = qq >= qmin[i] && qq < p.Sq;
        float x = bl[i] - l2;
        if (FULL_BIAS && vis) x += bias_log2(bcol[i][qq * p.bias_sq]);
        const float pv = vis ? fast_exp2(fmaf(s[i][j], scale_log2, x)) : 0.f;
        const float f = (keep >> (i * C + j)) & 1u ? rinv : 0.f;
        dp[i][j] = pv * fmaf(dp[i][j], f * p.scale, -dsc);
        s[i][j] = pv * f;
      }
    }
    // dV += (p keep)^T dO, dK += ds^T q
    slice_accumulate<D, R, C, COLS, true>(dv, s, dOs, dk, dp, Qs, rg, cg);
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

  float* dkp = static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  float* dvp = static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + r0 + i;
    if (key >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      dkp[key * p.dk_ss + 8 * c + cg] = dk[i][c];
      dvp[key * p.dv_ss + 8 * c + cg] = dv[i][c];
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
template <int D, typename E>
__device__ __forceinline__ void rows_delta(const BwdParams& p, const E* o,
                                           const E* dout, int b, int h,
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
    const uint32_t* o2 = reinterpret_cast<const uint32_t*>(&ov[i]);
    const uint32_t* d2 = reinterpret_cast<const uint32_t*>(&dv[i]);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 of = unpack2<E>(o2[k]);
      const float2 df = unpack2<E>(d2[k]);
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
// tiles they can see. E is the input type (bf16 or fp16), DROP the
// dropout mode, and FULL_BIAS says the bias has a stride along the
// queries (read per score); a [B,1,1,S] bias is staged per key tile.
template <typename E, int D, int DROP, bool FULL_BIAS>
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
  const E* q = static_cast<const E*>(p.q) + b * p.q_sb + h * p.q_sh;
  const E* k = static_cast<const E*>(p.k) + b * p.k_sb + h * p.k_sh;
  const E* v = static_cast<const E*>(p.v) + b * p.v_sb + h * p.v_sh;
  const E* o = static_cast<const E*>(p.o) + b * p.o_sb + h * p.o_sh;
  const E* dout = static_cast<const E*>(p.dout) + b * p.do_sb + h * p.do_sh;
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
    kmax[hr] = visible_keys(p, rows[hr]);
    brow[hr] = FULL_BIAS ? bias + rows[hr] * p.bias_sq : nullptr;
  }
  rows_delta<D, E>(p, o, dout, b, h, q0, valid_q, delta_s);
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
    scores<D, E>(s, base + L::Q, kb);
    wgmma_commit();
    scores<D, E>(dp, base + L::dO, vb);
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
    to_a_frags<E>(a, s);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<E>(acc, a[kk], mnmajor_desc(kb, kk));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

  // element 4n + 2hr + e of acc: row rows[hr], column 8n + 2t + e
  E* dq = static_cast<E*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (rows[hr] >= p.Sq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dq + rows[hr] * p.dq_ss + 8 * n + 2 * t) =
          pack2<E>(acc[4 * n + 2 * hr], acc[4 * n + 2 * hr + 1]);
  }
}

// Warpgroups of the dK/dV kernel: one up to D 128. At D 256 a thread's
// dK and dV (2 x 128 fp32) fit no single warpgroup, so two warpgroups own
// the same 64 keys: the first accumulates dV from p^T, the second dK from
// ds^T, and both compute s^T (only the second dp^T).
__host__ __device__ constexpr int dkv_roles(int D) { return D > 128 ? 2 : 1; }

// The dK/dV kernel: one CTA owns 64 keys and walks the query tiles that
// can see them, on transposed scores (rows are keys).
template <typename E, int D, int DROP, bool FULL_BIAS>
__global__ void __launch_bounds__(dkv_roles(D) * kWarpgroup)
flash_bwd_dkv_wgmma_kernel(const BwdParams p) {
  using L = DkvSmem<D>;
  constexpr int kRoles = dkv_roles(D);
  constexpr int kCta = kRoles * kWarpgroup;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t base = aligned_smem(smem_raw, sm);

  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // with two roles: warpgroup 0 accumulates dV, warpgroup 1 dK
  const int wg = threadIdx.x / kWarpgroup;
  const bool does_dv = kRoles == 1 || wg == 0;
  const bool does_dk = kRoles == 1 || wg == 1;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const E* q = static_cast<const E*>(p.q) + b * p.q_sb + h * p.q_sh;
  const E* k = static_cast<const E*>(p.k) + b * p.k_sb + h * p.k_sh;
  const E* v = static_cast<const E*>(p.v) + b * p.v_sb + h * p.v_sh;
  const E* dout = static_cast<const E*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* bias =
      p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const bool row_bias = !FULL_BIAS && bias != nullptr;
  const float* lse = p.lse + (static_cast<int64_t>(b) * p.H + h) * p.Sq;
  const float* delta = p.delta + (static_cast<int64_t>(b) * p.H + h) * p.Sq;
  const uint2 seed = read_seed(p.drop);
  const int valid_k = min(kTile, p.Sk - k0);
  const int qt0 = first_q_tile(p, k0);
  const int n_tiles = (p.Sq + kTile - 1) / kTile - qt0;

  tile_async<D, kCta>(base + L::K, k + k0 * p.k_ss, p.k_ss, valid_k);
  tile_async<D, kCta>(base + L::V, v + k0 * p.v_ss, p.v_ss, valid_k);
  if (row_bias)
    vec_async<kCta>(base + L::bias, bias + k0 * p.bias_sk, p.bias_sk,
                    valid_k);
  auto issue = [&](int i) {
    const int st = i % kStages, q0 = (qt0 + i) * kTile;
    const int valid = min(kTile, p.Sq - q0);
    tile_async<D, kCta>(base + L::Q + st * L::kTileBytes, q + q0 * p.q_ss,
                        p.q_ss, valid);
    tile_async<D, kCta>(base + L::dO + st * L::kTileBytes,
                        dout + q0 * p.do_ss, p.do_ss, valid);
    vec_async<kCta>(base + L::lse + st * kTile * 4, lse + q0, 1, valid);
    vec_async<kCta>(base + L::delta + st * kTile * 4, delta + q0, 1, valid);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  // this thread's keys: g and g + 8 of its warp's 16
  const int r_loc = (threadIdx.x % kWarpgroup) / 32 * 16 + g;
  int keys[2], qmin[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    keys[hr] = k0 + r_loc + 8 * hr;
    qmin[hr] = first_query(p, keys[hr]);
  }
  const float scale_log2 = p.scale * kLog2e;
  const float rinv = DROP == kNoDrop ? 1.f : p.drop.rinv;

  // one role: dV, then dK; two: this warpgroup's one
  float acc[kRoles == 1 ? 2 : 1][D / 2];
#pragma unroll
  for (int r = 0; r < (kRoles == 1 ? 2 : 1); ++r)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[r][i] = 0.f;
  float(&dv)[D / 2] = acc[0];
  float(&dk)[D / 2] = acc[kRoles == 1 ? 1 : 0];

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
    scores<D, E>(s, base + L::K, qb);
    wgmma_commit();
    if (does_dk) {
      scores<D, E>(dp, base + L::V, ob);
      wgmma_commit();
    }
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
    if (does_dk)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
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
    if (does_dk) {
      wgmma_wait<0>();
      pin(dp);
    }
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
          if (does_dk) dp[i] = s[i] * fmaf(dp[i], f * p.scale, -dsc);
          s[i] *= f;
        }
      }
    if constexpr (kRoles == 1) {
      uint32_t ap[4][4], ads[4][4];
      to_a_frags<E>(ap, s);
      to_a_frags<E>(ads, dp);
      pin(dv);
      pin(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<E>(dv, ap[kk], mnmajor_desc(ob, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<E>(dk, ads[kk], mnmajor_desc(qb, kk));
      wgmma_commit();
      wgmma_wait<0>();
      pin(dv);
      pin(dk);
    } else {  // dV += (p keep)^T dO or dK += ds^T q
      uint32_t a[4][4];
      if (does_dk)
        to_a_frags<E>(a, dp);
      else
        to_a_frags<E>(a, s);
      const uint32_t bb = does_dk ? qb : ob;
      pin(acc[0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<E>(acc[0], a[kk], mnmajor_desc(bb, kk));
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc[0]);
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

  E* dkp = static_cast<E*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  E* dvp = static_cast<E*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (keys[hr] >= p.Sk) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      if (does_dk)
        *reinterpret_cast<uint32_t*>(dkp + keys[hr] * p.dk_ss + 8 * n +
                                     2 * t) =
            pack2<E>(dk[4 * n + 2 * hr], dk[4 * n + 2 * hr + 1]);
      if (does_dv)
        *reinterpret_cast<uint32_t*>(dvp + keys[hr] * p.dv_ss + 8 * n +
                                     2 * t) =
            pack2<E>(dv[4 * n + 2 * hr], dv[4 * n + 2 * hr + 1]);
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
  if (dtype < 0 || dtype > 2) return false;
  if (dtype != 0) {
    // cp.async and the delta pass move 16-byte chunks of q, k, v, o, dout
    const void* ins[5] = {q, k, v, o, dout};
    for (const void* ptr : ins)
      if (!aligned16(ptr)) return false;
    for (int i = 0; i < 15; ++i)
      if (st[i] % 8 != 0) return false;
    // the epilogues store pairs: gradient rows 4-byte aligned
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
template <typename E, int D, int DROP, bool FULL_BIAS>
int launch_wgmma(bool dq, const BwdParams& p, cudaStream_t stream) {
  if (dq)
    return launch(flash_bwd_dq_wgmma_kernel<E, D, DROP, FULL_BIAS>, kThreads,
                  DqSmem<D>::bytes, (p.Sq + kTile - 1) / kTile, p, stream);
  return launch(flash_bwd_dkv_wgmma_kernel<E, D, DROP, FULL_BIAS>,
                dkv_roles(D) * kWarpgroup, DkvSmem<D>::bytes,
                (p.Sk + kTile - 1) / kTile, p, stream);
}

// the fp32 dQ (dq) or dK/dV kernel in its instance
template <int D, int DROP, bool FULL_BIAS>
int launch_f32(bool dq, const BwdParams& p, cudaStream_t stream) {
  using L = F32Bwd<D>;
  if (dq)
    return launch(flash_bwd_dq_f32_kernel<D, DROP, FULL_BIAS>, L::kThreads,
                  L::bytes, (p.Sq + L::ROWS - 1) / L::ROWS, p, stream);
  return launch(flash_bwd_dkv_f32_kernel<D, DROP, FULL_BIAS>, L::kThreads,
                L::bytes, (p.Sk + L::ROWS - 1) / L::ROWS, p, stream);
}

// the instance of the kernel of input type E (float: the fp32 kernels)
// for this dropout mode and bias layout
template <typename E, int D>
int launch_instance(bool dq, const BwdParams& p, cudaStream_t stream) {
  const bool full = p.bias != nullptr && p.bias_sq != 0;
#define PT_BWD_CASE(N, DROP, FULL)                                  \
  case N:                                                           \
    if constexpr (std::is_same<E, float>::value)                    \
      return launch_f32<D, DROP, FULL>(dq, p, stream);              \
    else                                                            \
      return launch_wgmma<E, D, DROP, FULL>(dq, p, stream);
  switch (p.drop.mode * 2 + full) {
    PT_BWD_CASE(0, kNoDrop, false)
    PT_BWD_CASE(1, kNoDrop, true)
    PT_BWD_CASE(2, kMaskDrop, false)
    PT_BWD_CASE(3, kMaskDrop, true)
    PT_BWD_CASE(4, kSeedDrop, false)
    PT_BWD_CASE(5, kSeedDrop, true)
  }
#undef PT_BWD_CASE
  return cudaErrorInvalidValue;
}

// the kernel for this dtype and D
int launch_bwd(bool dq, int dtype, int D, const BwdParams& p,
               cudaStream_t s) {
#define PT_BWD_D(E)                                          \
  if (D == 64) return launch_instance<E, 64>(dq, p, s);      \
  if (D == 128) return launch_instance<E, 128>(dq, p, s);    \
  if (D == 256) return launch_instance<E, 256>(dq, p, s);    \
  return cudaErrorInvalidValue;
  if (dtype == 0) { PT_BWD_D(float) }
  if (dtype == 1) { PT_BWD_D(bf16) }
  PT_BWD_D(f16)
#undef PT_BWD_D
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
  return launch_bwd(true, dtype, D, p, static_cast<cudaStream_t>(stream));
}

extern "C" int pt_flash_attention_bwd_dkv(PT_FLASH_BWD_ARGS) {
  BwdParams p;
  if (!make_params(p, q, k, v, o, dout, lse, delta, bias, keep, seed,
                   nullptr, dk, dv, B, H, Sq, Sk, strides, scale, causal,
                   thresh, rinv, dtype))
    return cudaErrorInvalidValue;
  return launch_bwd(false, dtype, D, p, static_cast<cudaStream_t>(stream));
}
