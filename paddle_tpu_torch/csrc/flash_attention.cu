// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/kernels/flash_attention.py:_fwd_kernel
// (launcher _fwd, which reaches pl.pallas_call), with its attention-probs
// dropout (_drop_keep_tile; see flash_common.cuh). For q [B,H,Sq,D], k and
// v [B,H,Sk,D] and an optional additive fp32 bias that broadcasts to
// [B,H,Sq,Sk]:
//   s = (q k^T) * scale + bias, causal mask bottom-right aligned (key j is
//   visible to query i when i + Sk - Sq >= j),
//   p = softmax(s), o = (p * keep / keep_prob) v in q's dtype,
//   lse = logsumexp(s) in fp32.
// Dropout multiplies only the value accumulation: the softmax denominator
// and lse stay undropped, as in the TPU kernel. The keep pattern comes
// from an explicit [B,H,Sq,Sk] keep mask read through strides (the JAX
// package's HBM-mask path) or from Philox run in the kernel (its seed
// path), with no mask in memory. A row that sees no key (causal with
// Sq > Sk, or every key masked by the bias) writes o = 0 and lse = 0, as
// the TPU kernel does: the running max starts at -1e30, so a score below
// it adds nothing to the sum. A bias below -2e30 (a finfo.min padding
// mask) counts as -2e30.
//
// What bounds it on the H100: at BERT-base (S = 512, D = 64) the work is
// 4*S*D = 131k flops for every 4*D elements of q, k, v, o a row moves. In
// bf16 on the tensor cores (989 TFLOP/s) that sits just under the ridge,
// so bytes and operations bound it about equally; in fp32 on the CUDA cores
// (67 TFLOP/s) operations bound it. Both kernels keep the [Sq, Sk] score
// matrix out of device memory: a block owns a tile of queries of one
// (b, h), walks the key tiles of 64 keys its rows can see (a causal tile
// wholly past its last visible key is never loaded), streams K and V
// through a ring of shared-memory stages by cp.async, the next tile in
// flight while this one is computed, and keeps the running max, sum and
// accumulator on chip, in fp32. The softmax runs in base 2:
// p = exp2(s scale log2(e) + bias log2(e) - m) with the running max m kept
// in the same units, one FMA (plus an add with a bias) and one ex2.approx
// a score. q, k, v, o and the bias are read through strides, so a
// [B,S,H,D] projection output needs no transpose and a [B,1,1,S] padding
// mask (strides 0) is never materialised; that mask arrives per key tile in
// the ring, a full bias is read per score. Only a tile that reaches past
// a row's last visible key pays for the mask. Seed-mode dropout runs
// Philox once per 2 x 2 group and uses all four words; l sums p before
// the dropout, and 1 / keep_prob is applied once, with 1 / l.
//
// - bfloat16 and float16: the dQ kernel's loop without dP
//   (flash_attention_bwd.cu), one template for both input types, built
//   from flash_wgmma.cuh. One warpgroup a CTA owns 64 queries; Q is
//   loaded once, K and V tiles stream through kFwdStages stages in the
//   128-byte swizzle. S = Q K^T is a wgmma with both operands K-major in
//   shared memory; the online softmax runs on the accumulator registers (a
//   row's values in the four lanes of a quad); P becomes the A fragments of
//   O += P V in registers, with V read MN-major from the same swizzled
//   tile, never transposed. While the tensor cores compute S a lane runs
//   Philox for its half of a pair of 2 x 2 groups and trades the bits with
//   lane ^ 4. Compiled per dropout mode (none, mask, seed), bias layout
//   (none, [B,1,1,S], full), D (64, 128, 256) and input type (bf16,
//   fp16): no score pays for a branch it does not take. At D 256 the
//   accumulator is 128 fp32 a thread and O += P V one m64n256k16 a
//   k-step; bf16 there multiplies p in as two bf16 terms (kSplitP). Tiling
//   measured on the H100 (bf16): see kFwdWarpgroups.
// - float32: the CUDA cores, fp32 FMA (the TPU kernel's fp32 numerics; no
//   TF32). A warp owns 4 R queries; a lane the scores of R rows x 8 keys
//   and the accumulator of those rows at D / 8 columns (R = 4 up to D 128,
//   2 at D 256: see SimtTiling). Q and K sit in shared memory d-major, so
//   per column d one load gives R rows of q and two 16-byte loads give 8
//   keys of k: 32 FMAs for 3 loads at R = 4. A row's 8 lanes share one
//   warp, so its max and sum are shuffles and p reaches the lanes that
//   multiply it into V by shuffles too: the scores never pass through
//   shared memory. A CTA owns 64 queries.
//
// C interface, loaded with ctypes (paddle_tpu_torch/kernels/flash_attention.py):
//   int pt_flash_attention_fwd(q, k, v, bias, keep, seed, o, lse, B, H, Sq,
//                              Sk, D, strides, scale, causal, thresh, rinv,
//                              dtype, stream)
//   int pt_flash_dropout_keep_mask(seed, B, H, Sq, Sk, thresh, out, stream)
// strides points to 20 int64 in host memory, in elements: q, k, v and o
// (batch, head, row), then bias and keep (batch, head, query, key). The
// last dim of q, k, v and o is contiguous; q, k, v and o start on 16 bytes
// and have strides of whole 16-byte chunks (cp.async and the fp32
// epilogue move 16 bytes), a bf16 or fp16 o at least on 4 bytes; the
// wrapper copies an input that does not. scale must be positive. keep
// (uint8, 1 = keep) selects mask mode, seed (one int64 in device memory)
// seed mode; with neither there is no dropout. thresh and
// rinv = 1 / keep_prob define the dropout. pt_flash_dropout_keep_mask
// writes the seed-mode pattern as a contiguous uint8 [B,H,Sq,Sk] mask
// through group_bits, the kernels' own word selection, for checking it
// against the plain version.
// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16. Returns the
// cudaError_t of the launch (0 on success).
#include "flash_wgmma.cuh"

using namespace flash;

namespace {

enum BiasLayout { kNoBias = 0, kRowBias = 1, kFullBias = 2 };

constexpr float kLn2 = 0.6931471805599453f;

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
  Dropout drop;
};

// keys [0, n) are visible to query row `row`; none past Sq
__device__ __forceinline__ int visible_keys(const Params& p, int row) {
  if (row >= p.Sq) return 0;
  return p.causal ? max(0, min(p.Sk, row + (p.Sk - p.Sq) + 1)) : p.Sk;
}

// key tiles that rows [q0, q0 + rows) need: up to the last key their last
// row can see
__device__ __forceinline__ int k_tiles(const Params& p, int q0, int rows) {
  return (visible_keys(p, min(q0 + rows, p.Sq) - 1) + kTile - 1) / kTile;
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma kernel fed by a cp.async ring
// ---------------------------------------------------------------------------

// One warpgroup and two stages. Measured on the H100 (chip_smoke.py's
// time_flash on copies with the constant changed) against two warpgroups,
// 128 queries a CTA with each streamed tile feeding both: 10% slower at
// the train shape [32,12,512,64], 4% at [8,12,512,64] with the padding
// mask, 37% at B=1 S=384 (half the CTAs), and 3% faster only with seed
// dropout; and against three stages: 12% slower at the train shape (more
// shared memory, fewer CTAs an SM; the loads are not the limit).
constexpr int kFwdWarpgroups = 1;
constexpr int kFwdStages = 2;
constexpr int kFwdRows = kFwdWarpgroups * kTile;       // queries a CTA
constexpr int kFwdThreads = kFwdWarpgroups * kWarpgroup;

template <int D>
struct FwdSmem {  // byte offsets from a 1024-byte-aligned base
  static constexpr int kTileBytes = kTile * D * 2;
  static constexpr int Q = 0;  // a tile a warpgroup
  static constexpr int K = Q + kFwdWarpgroups * kTileBytes;  // a ring of
  static constexpr int V = K + kFwdStages * kTileBytes;      // kFwdStages
  static constexpr int bias = V + kFwdStages * kTileBytes;   // stages each
  static constexpr int bytes = bias + kFwdStages * kTile * 4 + 1024;
};

// The tile's scores s (element 4j + 2hr + e: row hr, key k0 + 8j + 2t + e)
// become y: the raw score without a bias, the base-2 exponent
// s scale log2(e) + bias log2(e) with one; -inf where the key is not
// visible (MASKED: a tile that reaches past a row's last visible key). A
// full bias is read from brow, the bias row of row 0 (row 1 lies 8 rows
// on): one pointer, not two, kept the D 256 instances free of spills.
template <int BIAS, bool MASKED>
__device__ __forceinline__ void exponents(float (&s)[32], float scale_log2,
                                          const float* bias_tile,
                                          const float* brow, int64_t bias_sq,
                                          int64_t bias_sk, int k0, int t,
                                          const int (&kmax)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * t + e, kc = k0 + c;
      const float bl = BIAS == kRowBias ? bias_log2(bias_tile[c]) : 0.f;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = 4 * j + 2 * hr + e;
        const bool vis = !MASKED || kc < kmax[hr];
        float y = s[i];
        if (BIAS == kRowBias) y = fmaf(y, scale_log2, bl);
        if (BIAS == kFullBias)
          y = fmaf(y, scale_log2,
                   vis ? bias_log2(brow[8 * hr * bias_sq + kc * bias_sk])
                       : 0.f);
        s[i] = vis ? y : -INFINITY;
      }
    }
}

// bf16 rounds p at 2^-9 before p v, an error of up to 2^-9 of a row's
// largest |v| where few keys are visible; at D 256 a row holds 256 values
// of v, and that error passed FLASH_TOL's 2^-9 + 2^-6 |o| (chip_smoke.py)
// where |o| was small. There p enters as two bf16 terms, p = hi + lo
// (rounding at 2^-17), for a second p v product: the tensor cores' share of
// the work grows by half. fp16 rounds p at 2^-12, within its tolerance.
template <typename E, int D>
constexpr bool kSplitP = D == 256 && !kIsF16<E>;

// One CTA (kFwdWarpgroups warpgroups) owns kFwdRows queries and walks the
// key tiles they can see. E is the input type (bf16 or fp16), DROP the
// dropout mode, BIAS the bias layout.
template <typename E, int D, int DROP, int BIAS>
__global__ void __launch_bounds__(kFwdThreads)
flash_fwd_wgmma_kernel(const Params p) {
  using L = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t base = aligned_smem(smem_raw, sm);
  const float* bias_s = reinterpret_cast<const float*>(sm + L::bias);

  const int wg = threadIdx.x / kWarpgroup;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kFwdRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const E* q = static_cast<const E*>(p.q) + b * p.q_sb + h * p.q_sh;
  const E* k = static_cast<const E*>(p.k) + b * p.k_sb + h * p.k_sh;
  const E* v = static_cast<const E*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bias =
      BIAS == kNoBias ? nullptr : p.bias + b * p.bias_sb + h * p.bias_sh;
  const uint2 seed = read_seed(p.drop);
  const int n_tiles = k_tiles(p, q0, kFwdRows);

  // the Q tiles, then the first kFwdStages - 1 streamed ones, one group
  // each
#pragma unroll
  for (int w = 0; w < kFwdWarpgroups; ++w)
    tile_async<D, kFwdThreads>(base + L::Q + w * L::kTileBytes,
                               q + (q0 + w * kTile) * p.q_ss, p.q_ss,
                               p.Sq - q0 - w * kTile);
  auto issue = [&](int kt) {
    const int st = kt % kFwdStages, k0 = kt * kTile;
    tile_async<D, kFwdThreads>(base + L::K + st * L::kTileBytes,
                               k + k0 * p.k_ss, p.k_ss, p.Sk - k0);
    tile_async<D, kFwdThreads>(base + L::V + st * L::kTileBytes,
                               v + k0 * p.v_ss, p.v_ss, p.Sk - k0);
    if (BIAS == kRowBias)
      vec_async<kFwdThreads>(base + L::bias + st * kTile * 4,
                             bias + k0 * p.bias_sk, p.bias_sk, p.Sk - k0);
  };
#pragma unroll
  for (int i = 0; i < kFwdStages - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  // this thread's rows: g and g + 8 of its warp's 16
  const int r_loc = wg * kTile + (threadIdx.x % kWarpgroup) / 32 * 16 + g;
  int rows[2], kmax[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rows[hr] = q0 + r_loc + 8 * hr;
    kmax[hr] = visible_keys(p, rows[hr]);
  }
  const float* brow =
      BIAS == kFullBias ? bias + (q0 + r_loc) * p.bias_sq : nullptr;
  const int kmin = min(kmax[0], kmax[1]);
  const float scale_log2 = p.scale * kLog2e;
  // y (exponents) times mult is the base-2 exponent
  const float mult = BIAS == kNoBias ? scale_log2 : 1.f;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // running max, base-2 exponent; it starts at the TPU kernel's -1e30
  float m[2] = {kNegInf * kLog2e, kNegInf * kLog2e};
  float l[2] = {0.f, 0.f};              // this lane's part of the sum

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + kFwdStages - 1 < n_tiles) issue(kt + kFwdStages - 1);
    cp_async_commit();
    cp_async_wait<kFwdStages - 1>();  // tile kt (and Q) landed
    fence_proxy_async();
    __syncthreads();
    const int st = kt % kFwdStages, k0 = kt * kTile;
    const uint32_t kb = base + L::K + st * L::kTileBytes;
    const uint32_t vb = base + L::V + st * L::kTileBytes;

    // element 4j + 2hr + e: query rows[hr], key k0 + 8j + 2t + e
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    pin(s);
    wgmma_fence();
    scores<D, E>(s, base + L::Q + wg * L::kTileBytes, kb);
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
    wgmma_wait<0>();
    pin(s);
    const float* bias_tile = bias_s + st * kTile;
    if (__any_sync(0xffffffffu, k0 + kTile > kmin))
      exponents<BIAS, true>(s, scale_log2, bias_tile, brow, p.bias_sq,
                            p.bias_sk, k0, t, kmax);
    else
      exponents<BIAS, false>(s, scale_log2, bias_tile, brow, p.bias_sq,
                             p.bias_sk, k0, t, kmax);

    // online softmax; a row's 64 values lie in the 4 lanes of its quad
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx * mult);
      const float alpha = fast_exp2(m[hr] - m_new);
      m[hr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hr + e;
          const float pv = fast_exp2(fmaf(s[i], mult, -m_new));
          sum += pv;
          // dropout scales the value accumulation only
          s[i] = DROP == kNoDrop || (keep >> i) & 1u ? pv : 0.f;
        }
      l[hr] = fmaf(l[hr], alpha, sum);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n + 2 * hr] *= alpha;
        acc[4 * n + 2 * hr + 1] *= alpha;
      }
    }

    // O += P V: P from registers, V MN-major from the same stage; bf16 at
    // D 256 (kSplitP) as P_hi V + P_lo V
    uint32_t a[4][4], lo[kSplitP<E, D> ? 4 : 1][4];
    to_a_frags<E>(a, s);
    if constexpr (kSplitP<E, D>)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 hi = unpack2<E>(a[kk][i]);
          lo[kk][i] = pack2<E>(s[8 * kk + 2 * i] - hi.x,
                               s[8 * kk + 2 * i + 1] - hi.y);
        }
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<E>(acc, a[kk], mnmajor_desc(vb, kk));
      if constexpr (kSplitP<E, D>)
        wgmma_rs<E>(acc, lo[kk], mnmajor_desc(vb, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

  // element 4n + 2hr + e of acc: row rows[hr], column 8n + 2t + e
  const float rinv = DROP == kNoDrop ? 1.f : p.drop.rinv;
  E* o = static_cast<E*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    if (rows[hr] >= p.Sq) continue;
    const bool empty = lt <= 0.f;
    const float f = empty ? 0.f : rinv / lt;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(o + rows[hr] * p.o_ss + 8 * n + 2 * t) =
          pack2<E>(acc[4 * n + 2 * hr] * f, acc[4 * n + 2 * hr + 1] * f);
    if (t == 0)
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + rows[hr]] =
          empty ? 0.f : (m[hr] + log2f(lt)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// float32: register-tiled CUDA-core kernel
// ---------------------------------------------------------------------------

// Tiling a head dim. A CTA owns kTile queries, a warp 4 R of them, a lane
// the scores of R rows x 8 keys and the accumulator of those rows at D / 8
// columns. D 64 and 128: R = 4 (4 warps; 82 KB of shared memory at D 64:
// two CTAs an SM). On the H100 this beat 32 queries a CTA (twice the CTAs)
// at B=8 S=512 and at the serving request B=1 S=384, though 64 leaves 72
// CTAs for 132 SMs there; it also beat 8 x 8 scores a lane (a third fewer
// loads and shuffles a FMA, 2 warps a CTA) at both shapes. One V stage
// (three CTAs an SM) gained a few percent at B=8 only. D 256: a lane's 4
// rows would hold 128 accumulator floats and two stages of K and V would
// need 328 KB, so R = 2 (8 warps, 64 floats a lane) and one stage each of
// K and V (192 KB): K's next tile loads while this one's softmax and
// p v run, V's while the next scores run.
template <int D>
struct SimtTiling {
  static constexpr int R = D <= 128 ? 4 : 2;
  static constexpr int kWarps = kTile / (4 * R);
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kStages = D <= 128 ? 2 : 1;
};

template <int D>
struct SimtSmem {  // float offsets
  static constexpr int kStages = SimtTiling<D>::kStages;
  static constexpr int Q = 0;                       // q^T [D][kTile]
  static constexpr int K = Q + D * kTile;           // stages of k^T [D][kTile]
  static constexpr int V = K + kStages * D * kTile;  // stages of v [kTile][D]
  static constexpr int bias = V + kStages * kTile * D;  // 2 stages of kTile
  static constexpr int bytes = 4 * (bias + 2 * kTile);
};

// rows [0, valid) of a kTile x D fp32 tile into shared memory at dst,
// d-major: element (r, d) at float d * kTile + (r ^ 8 (d % 4)), the rest
// zero. A warp moves 8 rows x 4 columns a pass: 16-byte runs of device
// memory, 32 distinct banks of shared memory. The swizzle keeps a group of
// 4 rows from a multiple of 4 (8 from a multiple of 8) contiguous.
template <int D>
__device__ __forceinline__ void tile_t_async(uint32_t dst, const float* src,
                                             int64_t row_stride, int valid) {
  constexpr int kRowBlocks = kTile / 8;
  constexpr int kThreads = SimtTiling<D>::kThreads;
  const int lane = threadIdx.x % 32;
  const int r_lo = lane % 8, d_lo = lane / 8;
#pragma unroll 4
  for (int blk = threadIdx.x / 32; blk < kRowBlocks * (D / 4);
       blk += kThreads / 32) {
    const int r = (blk % kRowBlocks) * 8 + r_lo;
    const int d = (blk / kRowBlocks) * 4 + d_lo;
    const bool in = r < valid;
    cp_async4(dst + 4 * (d * kTile + (r ^ (8 * d_lo))),
              in ? src + r * row_stride + d : src, in);
  }
}

// rows [0, valid) of a kTile x D fp32 tile into shared memory at dst, row
// major, the rest zero
template <int D>
__device__ __forceinline__ void tile_rows_async(uint32_t dst,
                                                const float* src,
                                                int64_t row_stride,
                                                int valid) {
  constexpr int kChunks = D / 4;
  constexpr int kThreads = SimtTiling<D>::kThreads;
#pragma unroll 4
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool in = r < valid;
    cp_async16(dst + 4 * (r * D + c), in ? src + r * row_stride + c : src,
               in);
  }
}

// R consecutive fp32 values from p (R = 4: 16 bytes, R = 2: 8)
template <int R>
__device__ __forceinline__ void load_rows(const float* p, float (&out)[R]) {
  if constexpr (R == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  }
}

// A warp owns 4 R queries of the CTA's kTile; lane (rg, cg) =
// (lane / 8, lane % 8) the scores of rows R rg .. R rg + R - 1 of the warp
// and keys 8 cg .. 8 cg + 7 of a tile, and the accumulator of those rows
// at columns 32 c + 4 cg .. 32 c + 4 cg + 3.
template <int D>
__global__ void __launch_bounds__(SimtTiling<D>::kThreads)
flash_fwd_simt_kernel(const Params p) {
  using L = SimtSmem<D>;
  constexpr int R = SimtTiling<D>::R;
  constexpr int kThreads = SimtTiling<D>::kThreads;
  constexpr bool kSplit = SimtTiling<D>::kStages == 1;
  constexpr int DC = D / 32;  // 16-byte column groups of a lane
  extern __shared__ __align__(16) float smem[];
  const uint32_t base = smem_u32(smem);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / 8, cg = lane % 8;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bias =
      p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const bool row_bias = bias != nullptr && p.bias_sq == 0;
  const uint2 seed = read_seed(p.drop);
  const int n_tiles = k_tiles(p, q0, kTile);

  // two stages: K, V and the bias of a tile in one group. One stage (kSplit):
  // K and the bias in one group, V in the next.
  auto issue_k = [&](int kt) {
    const int st = kSplit ? 0 : kt & 1, k0 = kt * kTile;
    tile_t_async<D>(base + 4 * (L::K + st * D * kTile), k + k0 * p.k_ss,
                    p.k_ss, p.Sk - k0);
    if (row_bias)
      vec_async<kThreads>(base + 4 * (L::bias + (kt & 1) * kTile),
                          bias + k0 * p.bias_sk, p.bias_sk, p.Sk - k0);
  };
  auto issue_v = [&](int kt) {
    const int st = kSplit ? 0 : kt & 1, k0 = kt * kTile;
    tile_rows_async<D>(base + 4 * (L::V + st * kTile * D), v + k0 * p.v_ss,
                       p.v_ss, p.Sk - k0);
  };
  tile_t_async<D>(base + 4 * L::Q, q + q0 * p.q_ss, p.q_ss, p.Sq - q0);
  if (n_tiles > 0) issue_k(0);
  if (!kSplit && n_tiles > 0) issue_v(0);
  cp_async_commit();
  if (kSplit) {
    if (n_tiles > 0) issue_v(0);
    cp_async_commit();
  }

  const int r0 = warp * 4 * R + R * rg;  // this lane's first row
  int kmax[R];
  const float* brow[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    kmax[i] = visible_keys(p, q0 + r0 + i);
    brow[i] = bias && !row_bias ? bias + (q0 + r0 + i) * p.bias_sq : nullptr;
  }
  int kmin = kmax[0];
#pragma unroll
  for (int i = 1; i < R; ++i) kmin = min(kmin, kmax[i]);
  const float scale_log2 = p.scale * kLog2e;
  const float mult = bias ? 1.f : scale_log2;

  float acc[R][4 * DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4 * DC; ++c) acc[i][c] = 0.f;
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf * kLog2e;  // as in the bf16 kernel
    l[i] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (!kSplit) {
      if (kt + 1 < n_tiles) {
        issue_k(kt + 1);
        issue_v(kt + 1);
      }
      cp_async_commit();
    }
    cp_async_wait<1>();  // tile kt's K (and V with two stages, and Q) landed
    __syncthreads();
    const int st = kSplit ? 0 : kt & 1, k0 = kt * kTile;
    const float* Qs = smem + L::Q;
    const float* Ks = smem + L::K + st * D * kTile;
    const float* Vs = smem + L::V + st * kTile * D;
    const float* bias_tile = smem + L::bias + (kt & 1) * kTile;

    // s = q k^T: per column d one load of R rows, two of 8 keys
    float s[R][8];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const int sw = 8 * (d % 4);
      float qv[R];
      load_rows<R>(Qs + d * kTile + (r0 ^ sw), qv);
      const float* krow = Ks + d * kTile + ((8 * cg) ^ sw);
      const float4 ka = *reinterpret_cast<const float4*>(krow);
      const float4 kb = *reinterpret_cast<const float4*>(krow + 4);
      const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    if (kSplit) {  // K is read: the next tile's K (and bias) may land
      __syncthreads();
      if (kt + 1 < n_tiles) issue_k(kt + 1);
      cp_async_commit();
    }

    // y: the raw score without a bias, the base-2 exponent with one; -inf
    // where the key is not visible
    const bool edge = __any_sync(0xffffffffu, k0 + kTile > kmin);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kc = k0 + 8 * cg + j;
      const float bl = row_bias ? bias_log2(bias_tile[8 * cg + j]) : 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const bool vis = !edge || kc < kmax[i];
        float y = s[i][j];
        if (bias)
          y = fmaf(y, scale_log2,
                   row_bias ? bl
                            : vis ? bias_log2(brow[i][kc * p.bias_sk]) : 0.f);
        s[i][j] = vis ? y : -INFINITY;
      }
    }

    uint32_t keep = 0xFFFFFFFFu;
    if (p.drop.mode == kSeedDrop)
      keep = slice_keep_bits<kSeedDrop, R, 8, false>(
          p.drop, seed, b, h, q0 + r0, k0 + 8 * cg, p.Sq, p.Sk);
    else if (p.drop.mode == kMaskDrop)
      keep = slice_keep_bits<kMaskDrop, R, 8, false>(
          p.drop, seed, b, h, q0 + r0, k0 + 8 * cg, p.Sq, p.Sk);

    // online softmax; a row's 64 values lie in the 8 lanes of its rg
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 1; off < 8; off *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx * mult);
      const float alpha = fast_exp2(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pv = fast_exp2(fmaf(s[i][j], mult, -m_new));
        sum += pv;
        // dropout scales the value accumulation only
        s[i][j] = (keep >> (8 * i + j)) & 1u ? pv : 0.f;
      }
      l[i] = fmaf(l[i], alpha, sum);
#pragma unroll
      for (int c = 0; c < 4 * DC; ++c) acc[i][c] *= alpha;
    }

    if (kSplit) {  // tile kt's V landed (the next K may still be loading)
      cp_async_wait<1>();
      __syncthreads();
    }
    // acc += p v: p of key 8 kc8 + j for this lane's rows is held by lane
    // (rg, kc8), as its s[i][j]
#pragma unroll 2
    for (int kc8 = 0; kc8 < 8; ++kc8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float pv[R];
#pragma unroll
        for (int i = 0; i < R; ++i)
          pv[i] = __shfl_sync(0xffffffffu, s[i][j], rg * 8 + kc8);
        const float* vrow = Vs + (8 * kc8 + j) * D + 4 * cg;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 32 * c);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc[i][4 * c] = fmaf(pv[i], vv.x, acc[i][4 * c]);
            acc[i][4 * c + 1] = fmaf(pv[i], vv.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(pv[i], vv.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(pv[i], vv.w, acc[i][4 * c + 3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (kSplit) {  // V is read: the next tile's V may land
      if (kt + 1 < n_tiles) issue_v(kt + 1);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  const float rinv = p.drop.mode == kNoDrop ? 1.f : p.drop.rinv;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 1; off < 8; off *= 2)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int row = q0 + r0 + i;
    if (row >= p.Sq) continue;
    const bool empty = lt <= 0.f;
    const float f = empty ? 0.f : rinv / lt;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      *reinterpret_cast<float4*>(o + row * p.o_ss + 32 * c + 4 * cg) =
          make_float4(acc[i][4 * c] * f, acc[i][4 * c + 1] * f,
                      acc[i][4 * c + 2] * f, acc[i][4 * c + 3] * f);
    if (cg == 0)
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + row] =
          empty ? 0.f : (m[i] + log2f(lt)) * kLn2;
  }
}

template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, int rows,
           const Params& p, cudaStream_t stream) {
  const cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Sq + rows - 1) / rows, p.H, p.B);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int D, int DROP, int BIAS>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  return launch(flash_fwd_wgmma_kernel<E, D, DROP, BIAS>, kFwdThreads,
                FwdSmem<D>::bytes, kFwdRows, p, stream);
}

// the tensor-core kernel in its instance for this dropout mode and bias
// layout
template <typename E, int D>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  const int bias = p.bias == nullptr ? kNoBias
                   : p.bias_sq == 0  ? kRowBias
                                     : kFullBias;
  switch (p.drop.mode * 3 + bias) {
    case 0: return launch_wgmma<E, D, kNoDrop, kNoBias>(p, stream);
    case 1: return launch_wgmma<E, D, kNoDrop, kRowBias>(p, stream);
    case 2: return launch_wgmma<E, D, kNoDrop, kFullBias>(p, stream);
    case 3: return launch_wgmma<E, D, kMaskDrop, kNoBias>(p, stream);
    case 4: return launch_wgmma<E, D, kMaskDrop, kRowBias>(p, stream);
    case 5: return launch_wgmma<E, D, kMaskDrop, kFullBias>(p, stream);
    case 6: return launch_wgmma<E, D, kSeedDrop, kNoBias>(p, stream);
    case 7: return launch_wgmma<E, D, kSeedDrop, kRowBias>(p, stream);
    case 8: return launch_wgmma<E, D, kSeedDrop, kFullBias>(p, stream);
  }
  return cudaErrorInvalidValue;
}

template <int D>
int launch_simt(const Params& p, cudaStream_t stream) {
  return launch(flash_fwd_simt_kernel<D>, SimtTiling<D>::kThreads,
                SimtSmem<D>::bytes, kTile, p, stream);
}

// one thread a 2 x 2 group of the seed-mode pattern, through group_bits,
// the word selection of every forward and bf16 backward kernel
__global__ void keep_mask_kernel(Dropout d, int B, int H, int Sq, int Sk,
                                 uint8_t* out) {
  const uint2 seed = read_seed(d);
  const int gq = (Sq + 1) / 2, gk = (Sk + 1) / 2;
  const int64_t n = static_cast<int64_t>(B) * H * gq * gk;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int k = 2 * static_cast<int>(i % gk);
    const int q = 2 * static_cast<int>((i / gk) % gq);
    const int h = static_cast<int>((i / gk / gq) % H);
    const int b = static_cast<int>(i / gk / gq / H);
    const uint32_t bits = group_bits<kSeedDrop>(d, seed, b, h, q, k, Sq, Sk);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (q + e >= Sq) continue;
      uint8_t* row =
          out + ((static_cast<int64_t>(b) * H + h) * Sq + q + e) * Sk;
      row[k] = (bits >> (2 * e)) & 1u;
      if (k + 1 < Sk) row[k + 1] = (bits >> (2 * e + 1)) & 1u;
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
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || H > 65535 || B > 65535 ||
      !(scale > 0.f))
    return cudaErrorInvalidValue;
  if (keep != nullptr && seed != nullptr) return cudaErrorInvalidValue;
  if (dtype < 0 || dtype > 2) return cudaErrorInvalidValue;
  const int64_t* st = static_cast<const int64_t*>(strides);
  // cp.async moves 16-byte chunks of q, k, v; the fp32 epilogue stores 16
  // bytes of o, the bf16 and fp16 one 4
  const int esize = dtype == 0 ? 4 : 2;
  const int o_bytes = dtype == 0 ? 16 : 4;
  const void* ins[3] = {q, k, v};
  for (const void* ptr : ins)
    if (!aligned16(ptr)) return cudaErrorInvalidValue;
  for (int i = 0; i < 9; ++i)
    if (st[i] % (16 / esize) != 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(o) % o_bytes != 0)
    return cudaErrorInvalidValue;
  for (int i = 9; i < 12; ++i)
    if (st[i] % (o_bytes / esize) != 0) return cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_simt<64>(p, s);
  if (dtype == 0 && D == 128) return launch_simt<128>(p, s);
  if (dtype == 0 && D == 256) return launch_simt<256>(p, s);
  if (dtype == 1 && D == 64) return launch_wgmma<bf16, 64>(p, s);
  if (dtype == 1 && D == 128) return launch_wgmma<bf16, 128>(p, s);
  if (dtype == 1 && D == 256) return launch_wgmma<bf16, 256>(p, s);
  if (dtype == 2 && D == 64) return launch_wgmma<f16, 64>(p, s);
  if (dtype == 2 && D == 128) return launch_wgmma<f16, 128>(p, s);
  if (dtype == 2 && D == 256) return launch_wgmma<f16, 256>(p, s);
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
