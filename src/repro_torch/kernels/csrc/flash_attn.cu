// Flash attention forward for Hopper (sm_90a): K5.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attn.py, body `_fa_body`): softmax attention
// over (B, H, S, D) q/k/v with an online softmax, computed per query
// tile against a sweep of key/value tiles
//
//   s[i, j] = scale * (q[i] . k[j])          scale = 1 / sqrt(D)
//   o[i]    = sum_j softmax_j(s[i, :])[j] * v[j]
//
// with the causal mask (key j visible to query i when j <= i) taken only
// for Sq == Sk, the TPU kernel's own validity condition.  The running
// max, the running sum and the accumulator are f32; tiles entirely above
// the diagonal are skipped; rows with no visible key yet keep m = -inf
// and contribute 0 (the TPU kernel's guard); the output divides by
// max(l, 1e-30) and is written once, in the input's type.  Differences
// from the TPU kernel's contract:
//   * k/v may carry Hkv heads with H % Hkv == 0 (grouped-query
//     attention): q head h reads kv head h / (H / Hkv), so the caller
//     never expands k/v;
//   * any S >= 1: keys past Sk are masked and query rows past Sq are
//     computed but never written, so no host-side padding copy is made;
//   * strides over (batch, head, sequence), with the head dim
//     unit-stride: the LM hands (B, S, H, D) activations in as transposed
//     views and gets its output in the same layout.
//
// The dtype picks one of two kernels; neither falls back on the other.
//
// bf16, the serving dtype: `flash_attn_wgmma_kernel`, both products on
// the tensor cores.  What bounds it on the H100: at the serving shape
// (B 4, H 32, S 4080, D 160, causal) the useful work is 2 * B * H * D *
// S * (S + 1) = 6.8e11 operations, 0.690 ms at the 989 TFLOP/s of the
// bf16 tensor cores; the bytes (q, k, v read once, o written once, 0.42
// GB) take 0.125 ms at 3.35 TB/s, so it is bound by operations.  P is
// split in two (below), which makes the P.V product twice as long: 1.5x
// the useful work, 1.035 ms at the same rate.  The design:
//   * one block per (128 query rows, head, sample), 384 threads: two
//     consumer warpgroups of 64 rows each and a producer warpgroup whose
//     first warp issues every load (setmaxnreg moves registers from the
//     producer, 24 a thread, to the consumers, 240);
//   * q (once per block) and each tile of BK keys of k and v come in by
//     TMA, four-dimensional tensor maps (D, S, H, B) over the caller's
//     strides, built on the host per launch; rows past S and head dims
//     past D arrive as zeros; kv head h / (H / Hkv) is a coordinate of
//     the map, so grouped heads are read in place;
//   * k/v tiles go through a ring of two stages with full and empty
//     mbarriers, so the next tile's loads run under this tile's products;
//     BK is 128 where q and two stages fit in shared memory (D <= 160:
//     200 KB at D 160), else 64 (three or four stages measured no faster);
//   * shared tiles are cut into blocks of 32 head dims (64 bytes a row)
//     with the 64-byte swizzle, the one that divides D = 160; the TMA
//     maps and every wgmma descriptor use that same swizzle;
//   * S = Q K^T is `wgmma m64n{BK}k16` with both operands K-major from
//     shared memory, k16 steps over D rounded up to 32, fully unrolled (a
//     loop with a run-time count made ptxas serialize every wgmma of the
//     kernel); the mask is applied only on a tile that crosses the
//     diagonal or Sk (TMA's zero rows past Sk would score 0, not -inf);
//   * softmax in f32 registers: one multiply by scale * log2(e), exp2f,
//     the row max and sum over the four threads that share a row;
//   * O += P V is `wgmma m64n64k16` per 64 head dims (n32 for an odd last
//     block), A = P from registers (the score accumulator's layout is the
//     A fragment's), B = V MN-major from shared memory (the descriptor's
//     transpose bit);
//   * P is split as p_hi = bf16(p), p_lo = bf16(p - p_hi) and both go
//     through the same V tile into one f32 accumulator; l sums the
//     unrounded p.  One bf16 rounding of P before P.V breaks the
//     element-by-element gate (|d| <= 2^-7 |ref| + 1e-4 max|ref|) by 4x
//     (causal) to 16x (full) in a CPU restatement of this schedule
//     (tests/test_torch_lm.py::test_k5_bf16_needs_p_split); the pair
//     carries p to 16 bits of mantissa and holds it, for 1.5x the tensor
//     work;
//   * the grid is one-dimensional, the longest query tiles (the last
//     ones of a causal sweep) first over all heads and samples, so the
//     tail of the launch is short tiles.
//
// f32, the precision path: `flash_attn_kernel`, both products on the TF32
// tensor cores in 3xTF32 (`mma.sync.m16n8k8`).  One TF32 rounding keeps
// 10 mantissa bits and cannot hold the 2e-5 f32 gate, so every operand
// is split as hi = tf32(x), lo = tf32(x - hi) and each product is taken
// as lo*hi + hi*lo + hi*hi into f32 accumulators (`sd_igemm.cuh`'s
// `igemm::split` and `igemm::mma_tf32`, the arithmetic of K1-K4).  What
// bounds it on the H100: at the serving shape the useful work is 6.8e11
// operations, 10.2 ms at the 67 TFLOP/s of the CUDA cores; its 3xTF32
// work, three times that at the 495 TFLOP/s TF32 tensor cores, takes 4.1
// ms; the bytes (0.84 GB in f32) take 0.25 ms, so it is bound by
// operations.  It reaches about 0.29 of that 3xTF32 bound; what holds it
// there is not measured.  Its registers (204 a thread at D 160) allow
// one block of 8 warps per SM, which leaves little to hide mma.sync and
// shared-memory latency behind, and a block's warps reach the softmax
// together, when no mma issues.  The design:
//   * one block per (query tile, head, sample) with warps that own 16
//     query rows each: 8 warps and 128 rows up to D 192, 4 warps and 64
//     rows above (so that q and two k/v stages fit in shared memory); the
//     grid is one-dimensional, the longest causal query tiles first, as
//     the bf16 kernel's;
//   * the query tile is staged once in shared memory as f32, already
//     multiplied by the scale; tiles of 32 keys of k and v go through a
//     cp.async ring of 3 stages (2 where 3 do not fit: D > 160), so the
//     next tiles' copies run under this tile's products: 16-byte copies
//     where the base and the batch, head and sequence strides allow
//     them, 4-byte copies otherwise (`igemm::cp_async16`/`cp_async4`);
//     rows past Sk and head dims past D are zero-filled up to the
//     instantiation's width DP (a multiple of 8), so the k8 steps over D
//     need no mask;
//   * S = Q K^T is, per k8 step over DP, one A fragment of the warp's 16
//     rows and four B fragments of the tile's 32 keys, each split in
//     registers, three mma each, the small products first.  Within a k8
//     step the mma's k index t stands for head dim 2t and t + 4 for 2t +
//     1 (both operands alike), so each fragment pair is one 8-byte load;
//     q and k rows are DP | 8 floats apart (8 mod 16), which makes those
//     loads free of bank conflicts;
//   * the softmax stays in registers on the S accumulator: the row max
//     and sum over the four lanes that share a row, expf, the mask only
//     on a tile that crosses the diagonal or Sk;
//   * O += P V: the S accumulator holds keys 2t and 2t + 1 of each 8-key
//     group, which is where the A fragment of P wants k indices t and t +
//     4 if the mma's k index t stands for key 2t and t + 4 for key 2t + 1.
//     So P enters the product as it lies (split hi/lo like every other
//     operand), with neither shuffles nor a trip through shared memory,
//     and the B fragment reads v rows 2t and 2t + 1, DP + 4 floats apart
//     (4 mod 8): free of bank conflicts too;
//   * O stays in the mma accumulators across the key sweep, rescaled in
//     place each tile, with no promoted register sum.  The tensor cores
//     add with truncation (the shared GEMM promotes its 4,608-deep sums
//     for that, sd_igemm.cuh), but in a CPU restatement of this schedule
//     with a truncating accumulator (tests/test_torch_lm.py::
//     test_k5_f32_needs_3xtf32, S 129 and 257) the chained O reads at
//     most 0.0091 of the 2e-5 gate, as a per-tile promoted sum does,
//     while 1xTF32 reads 1.9-20x; a promoted sum would cost 80 more
//     registers a thread at D 160;
//   * K and V are split at each use, by each warp: five ALU instructions
//     per element per use.  Splitting them once per block
//     into hi/lo shared tiles instead (one raw cp.async stage and one
//     split stage, two barriers a tile: all that fits beside q at D 160,
//     and nothing past it) removes about a third of the instructions
//     (counted from the code), but a probe of it on the card ran only
//     slightly faster, so the simpler ring was kept.
// Why mma.sync and not wgmma: wgmma takes tf32 operands only K-major, and
// v arrives MN-major (keys x D, D contiguous), so P V would need v
// transposed in shared memory; that, and the hi/lo split in shared
// memory that wgmma would need too, are a later design's questions.

#include <cuda.h>            // CUtensorMap and its enums; no link to libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "sd_igemm.cuh"   // igemm::split, igemm::mma_tf32, cp.async copies

namespace {

constexpr int kMaxD = 256;

// ---------------------------------------------------------------------------
// f32: mma.sync 3xTF32 + cp.async
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kBK = 32;                   // keys per tile
constexpr int kSmemMax = 232448;          // the opt-in limit

struct Args {
  int B, H, Hkv, Sq, Sk, D, causal, nq;
  int vec_q, vec_k, vec_v;                // 16-byte loads / copies
  long long qb, qh, qs;                   // element strides over (batch,
  long long kb, kh, ks;                   // head, sequence)
  long long vb, vh, vs;
  long long ob, oh, os;
  float scale;
};

// One instantiation: NDT n-tiles of 8 head dims, DP = 8 NDT dims (zero
// past D).  Row strides in floats: q and k DP | 8 (8 mod 16: the 8-byte
// fragment loads of a half warp hit 32 banks), v DP + 4 (4 mod 8: the
// B fragment's rows 2t and 2t + 1 hit 32 banks).  The block's rows, 128
// up to D 192 and 64 above, are kernels/flash_attn.py's kernel_tile.
template <int NDT> struct Cfg {
  static constexpr int DP = 8 * NDT;
  static constexpr int SQK = DP | 8;
  static constexpr int SV = DP + 4;
  static constexpr int warps = NDT <= 24 ? 8 : 4;
  static constexpr int BQ = 16 * warps;             // query rows per block
  static constexpr int threads = 32 * warps;
  static constexpr int q = BQ * SQK;                // floats
  static constexpr int stage = kBK * (SQK + SV);    // one k and one v tile
  static constexpr int stages =
      (q + 3 * stage) * 4 <= kSmemMax ? 3 : 2;
  static constexpr int bytes = (q + stages * stage) * 4;
  static_assert(bytes <= kSmemMax, "tiles exceed shared memory");
};

// Rows [row0, row0 + kBK) of one (batch, head) slice into a shared tile
// with rows LD floats apart, by cp.async: 16-byte copies when `vec`, else
// 4-byte ones; rows at or past `nrows` and dims at or past D are zero.
template <int DP, int LD, int NTHREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int row0,
                                          int nrows, int D, int vec) {
  if (vec) {
    constexpr int W = DP / 4;
    for (int i = threadIdx.x; i < kBK * W; i += NTHREADS) {
      const int r = i / W, c = (i - r * W) * 4;
      const bool ok = row0 + r < nrows && c < D;
      igemm::cp_async16(dst + r * LD + c,
                        ok ? src + (row0 + r) * stride + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kBK * DP; i += NTHREADS) {
      const int r = i / DP, c = i - r * DP;
      const bool ok = row0 + r < nrows && c < D;
      igemm::cp_async4(dst + r * LD + c,
                       ok ? src + (row0 + r) * stride + c : src, ok);
    }
  }
}

// Accumulator layout of an m16n8 tile: a lane (g = lane / 4, t = lane % 4)
// holds (row g, columns 2t, 2t + 1) in c0, c1 and row g + 8 in c2, c3.
template <int NDT>
__global__ void __launch_bounds__(Cfg<NDT>::threads, 1)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  const Args a) {
  using C = Cfg<NDT>;
  constexpr int DP = C::DP, SQK = C::SQK, SV = C::SV, BQ = C::BQ;
  constexpr int NT = kBK / 8;             // key n-tiles of S, k8 steps of PV
  constexpr int NC = NDT % 4 == 0 ? 4 : 2;    // head-dim n-tiles per batch
  constexpr int S = C::stages;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [BQ][SQK], scaled
  float* ring = smem + C::q;              // S x (k [kBK][SQK], v [kBK][SV])

  // Longest query tiles first, over every head and sample.
  const int hb = a.H * a.B;
  const int qt = a.nq - 1 - static_cast<int>(blockIdx.x) / hb;
  const int h = static_cast<int>(blockIdx.x) % hb % a.H;
  const int b = static_cast<int>(blockIdx.x) % hb / a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = qt * BQ;
  const int kend = a.causal ? min(a.Sk, q0 + BQ) : a.Sk;
  const int ntiles = (kend + kBK - 1) / kBK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  const float* kp = k + b * a.kb + hk * a.kh;
  const float* vp = v + b * a.vb + hk * a.vh;
  auto load_kv = [&](int st, int tile) {
    float* ks = ring + st * C::stage;
    load_rows<DP, SQK, C::threads>(ks, kp, a.ks, tile * kBK, a.Sk, a.D,
                                   a.vec_k);
    load_rows<DP, SV, C::threads>(ks + kBK * SQK, vp, a.vs, tile * kBK,
                                  a.Sk, a.D, a.vec_v);
  };
  for (int st = 0; st < S - 1; ++st) {
    if (st < ntiles) load_kv(st, st);
    igemm::cp_async_commit();
  }

  // The query tile, times the scale, under the first tiles' copies.
  {
    const float* qp = q + b * a.qb + h * a.qh;
    constexpr int W = DP / 4;
    for (int i = tid; i < BQ * W; i += C::threads) {
      const int r = i / W, c = (i - r * W) * 4;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (q0 + r < a.Sq) {
        const float* src = qp + (q0 + r) * a.qs + c;
        if (a.vec_q) {
          if (c < a.D) {
            const float4 f = *reinterpret_cast<const float4*>(src);
            x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c + e < a.D) x[e] = src[e];
        }
      }
      *reinterpret_cast<float4*>(qs + r * SQK + c) =
          make_float4(x[0] * a.scale, x[1] * a.scale, x[2] * a.scale,
                      x[3] * a.scale);
    }
  }

  const int first = q0 + 16 * warp;       // the warp's first row
  const int row0 = first + g;             // this lane's rows: row0, row0 + 8
  const float* qw = qs + 16 * warp * SQK + 2 * t;
  float o[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int tile = 0; tile < ntiles; ++tile) {
    igemm::cp_async_wait<S - 2>();   // tile has landed (this thread's copies)
    __syncthreads();                 // everyone's; the oldest stage is free
    if (tile + S - 1 < ntiles) load_kv((tile + S - 1) % S, tile + S - 1);
    igemm::cp_async_commit();

    const int k0 = tile * kBK;
    if (a.causal && k0 > first + 15) continue;   // above the warp's diagonal
    const float* ks = ring + (tile % S) * C::stage;
    const float* vs = ks + kBK * SQK;

    // S = Q K^T: k index t is head dim 2t of the k8 step, t + 4 is 2t + 1
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const float* kw = ks + g * SQK + 2 * t;
#pragma unroll 4
    for (int kd = 0; kd < NDT; ++kd) {
      const float2 x0 =
          *reinterpret_cast<const float2*>(qw + g * SQK + 8 * kd);
      const float2 x1 =
          *reinterpret_cast<const float2*>(qw + (g + 8) * SQK + 8 * kd);
      uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
      igemm::split<float>(x0.x, ah[0], al[0]);
      igemm::split<float>(x1.x, ah[1], al[1]);
      igemm::split<float>(x0.y, ah[2], al[2]);
      igemm::split<float>(x1.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 y =
            *reinterpret_cast<const float2*>(kw + 8 * j * SQK + 8 * kd);
        igemm::split<float>(y.x, bh[j][0], bl[j][0]);
        igemm::split<float>(y.y, bh[j][1], bl[j][1]);
      }
      // Pass by pass, so that consecutive mma never share an accumulator.
#pragma unroll
      for (int j = 0; j < NT; ++j) igemm::mma_tf32(s[j], al, bh[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j) igemm::mma_tf32(s[j], ah, bl[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j) igemm::mma_tf32(s[j], ah, bh[j]);
    }

    if ((a.causal && k0 + kBK - 1 > first) || k0 + kBK > a.Sk) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          const int qpos = row0 + 8 * (e >> 1);
          if (kpos >= a.Sk || (a.causal && kpos > qpos)) s[j][e] = -INFINITY;
        }
    }

    // Online softmax on rows row0 (r = 0) and row0 + 8 (r = 1); l holds
    // this lane's part of the row sum until the end.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float safe[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      safe[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = m[r] == -INFINITY ? 0.f : expf(m[r] - safe[r]);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - safe[e >> 1]);   // masked: 0
        l[e >> 1] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int n = 0; n < NDT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];

    // O += P V over the tile's keys in k8 steps: k index t is key 2t of
    // the step, t + 4 is key 2t + 1, so P's A fragment is the S
    // accumulator as it lies (c0, c2, c1, c3)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ph[4], pl[4];
      igemm::split<float>(s[j][0], ph[0], pl[0]);
      igemm::split<float>(s[j][2], ph[1], pl[1]);
      igemm::split<float>(s[j][1], ph[2], pl[2]);
      igemm::split<float>(s[j][3], ph[3], pl[3]);
      const float* vr = vs + (8 * j + 2 * t) * SV + g;
#pragma unroll
      for (int n0 = 0; n0 < NDT; n0 += NC) {
        uint32_t bh[NC][2], bl[NC][2];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          igemm::split<float>(vr[8 * (n0 + c)], bh[c][0], bl[c][0]);
          igemm::split<float>(vr[SV + 8 * (n0 + c)], bh[c][1], bl[c][1]);
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) igemm::mma_tf32(o[n0 + c], pl, bh[c]);
#pragma unroll
        for (int c = 0; c < NC; ++c) igemm::mma_tf32(o[n0 + c], ph, bl[c]);
#pragma unroll
        for (int c = 0; c < NC; ++c) igemm::mma_tf32(o[n0 + c], ph, bh[c]);
      }
    }
  }
  igemm::cp_async_wait<0>();

  // o = O / max(l, 1e-30), rows past Sq and dims past D not written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + 8 * r;
    if (qpos >= a.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* op = out + b * a.ob + h * a.oh + qpos * a.os;
#pragma unroll
    for (int n = 0; n < NDT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        if (col < a.D) op[col] = o[n][2 * r + e] / denom;
      }
  }
}

template <int NDT>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   Args a, cudaStream_t stream) {
  using C = Cfg<NDT>;
  a.nq = (a.Sq + C::BQ - 1) / C::BQ;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<NDT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::bytes);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)a.nq * a.H * a.B;
  if (grid > INT_MAX) return cudaErrorInvalidConfiguration;
  flash_attn_kernel<NDT><<<(unsigned)grid, C::threads, C::bytes, stream>>>(
      q, k, v, o, a);
  return cudaGetLastError();
}

// 16-byte accesses to an operand: D a multiple of 4, the base on a 16-byte
// boundary, and every stride a dim of more than one steps over a multiple
// of 4 elements.
bool vec16(const void* p, int D, int n0, long long s0, int n1, long long s1,
           int n2, long long s2) {
  return D % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (n0 == 1 || s0 % 4 == 0) && (n1 == 1 || s1 % 4 == 0) &&
         (n2 == 1 || s2 % 4 == 0);
}

cudaError_t dispatch(const float* q, const float* k, const float* v,
                     float* o, Args a, cudaStream_t s) {
  a.vec_q = vec16(q, a.D, a.B, a.qb, a.H, a.qh, a.Sq, a.qs);
  a.vec_k = vec16(k, a.D, a.B, a.kb, a.Hkv, a.kh, a.Sk, a.ks);
  a.vec_v = vec16(v, a.D, a.B, a.vb, a.Hkv, a.vh, a.Sk, a.vs);
  const int n8 = (a.D + 7) / 8;
  if (n8 <= 2) return launch<2>(q, k, v, o, a, s);
  if (n8 <= 4) return launch<4>(q, k, v, o, a, s);
  if (n8 <= 6) return launch<6>(q, k, v, o, a, s);
  if (n8 <= 8) return launch<8>(q, k, v, o, a, s);
  if (n8 <= 12) return launch<12>(q, k, v, o, a, s);
  if (n8 <= 16) return launch<16>(q, k, v, o, a, s);
  if (n8 <= 20) return launch<20>(q, k, v, o, a, s);
  if (n8 <= 24) return launch<24>(q, k, v, o, a, s);
  return launch<32>(q, k, v, o, a, s);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBQ = 128;            // query rows per block, 64 per consumer
constexpr int kCols = 32;           // head dims per swizzled block (64 B rows)
constexpr int kRowBytes = kCols * 2;
constexpr int kStages = 2;          // k/v ring depth
constexpr int kThreads = 384;       // consumers: warps 0-7; producer: 8-11
constexpr int kConsumers = 256;
constexpr int kSmemMax = 232448 - 1024;   // the opt-in limit, less alignment

struct Args {
  int B, H, Hkv, Sq, Sk, D, causal, nq, pairs;
  long long ob, oh, os;             // output strides in elements
  float scale_log2;                 // scale * log2(e)
};

// The shape of one instantiation: NC = ceil(D / 32) blocks of 32 head
// dims, and BK keys per tile: 128 where the q tile and two stages of k and
// v fit in shared memory (D <= 160), else 64.
template <int NC> struct Cfg {
  static constexpr int q = NC * kBQ * kRowBytes;       // q tile bytes
  static constexpr int BK =
      q + 2 * kStages * NC * 128 * kRowBytes <= kSmemMax ? 128 : 64;
  static constexpr int kv = NC * BK * kRowBytes;       // one k or v tile
  static constexpr int bytes = q + 2 * kStages * kv;
  static_assert(bytes <= kSmemMax, "tiles exceed shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A wait still open after about 2^36 cycles (30 s or more) traps, so a
// fault in the pipeline ends the launch with an error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1LL << 36)) __trap();
  }
}

// One box of the map (32 head dims x its rows) into shared memory at
// `dst`, counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(d0), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// wgmma descriptor of a 64-byte-swizzled operand at shared address
// `addr`: rows of 64 bytes, 8-row atoms of 512 bytes, `sbo` bytes from one
// 8-row group to the next (along M/N for a K-major operand, along K for
// an MN-major one) and, for an MN-major operand wider than one swizzle
// block, `lbo` bytes from one 32-column block to the next (K-major
// operands here never cross a block within a k16 step).
__device__ __forceinline__ uint64_t desc64(uint32_t addr, uint32_t lbo,
                                           uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);              // 64-byte swizzle
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Pin a register's value at this point of the program: the compiler may
// not move its reads or writes across the asynchronous products that use
// it (called before the fence that opens them and after the wait that
// closes them).
__device__ __forceinline__ void keep(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}
__device__ __forceinline__ void keep(uint32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}
template <int N> __device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) keep(r[i]);
}
template <int N> __device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) keep(r[i][j]);
}

// d (64 x 64, f32) = A (64 x 16) B^T (64 x 16) [+ d]: both bf16, K-major,
// from shared memory.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) = A (64 x 16) B^T (128 x 16) [+ d]: both bf16, K-major,
// from shared memory.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 32, f32) += A (64 x 16, bf16 in registers) B (16 x 32, bf16,
// MN-major in shared memory: the transpose bit).
__device__ __forceinline__ void wgmma_pv(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %21, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same over 64 columns, two swizzle blocks: d0 holds columns 0-31,
// d1 columns 32-63.
__device__ __forceinline__ void wgmma_pv(float (&d0)[16], float (&d1)[16],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]),
        "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]), "+f"(d0[8]), "+f"(d0[9]),
        "+f"(d0[10]), "+f"(d0[11]), "+f"(d0[12]), "+f"(d0[13]),
        "+f"(d0[14]), "+f"(d0[15]), "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]),
        "+f"(d1[3]), "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]), "+f"(d1[12]),
        "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator layout of a wgmma m64nN tile: warp w of the warpgroup owns
// rows 16w..16w+15; a lane holds, for each 8-column group j, elements
// 4j+0/1 at row lane/4 and 4j+2/3 at row lane/4 + 8, columns 8j + 2
// (lane % 4) + 0/1.
template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                        __grid_constant__ const CUtensorMap tk,
                        __grid_constant__ const CUtensorMap tv,
                        __nv_bfloat16* __restrict__ o, const Args a) {
  constexpr int BK = Cfg<NC>::BK;
  constexpr int KVB = BK * kRowBytes;       // one 32-dim block of a k/v tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  // swizzle atoms must sit on 512-byte boundaries; 1024 keeps it simple
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + Cfg<NC>::q;
  const uint32_t sv = sk + kStages * Cfg<NC>::kv;
  const uint32_t qbar = smem_addr(&bars[0]);
  const uint32_t full0 = smem_addr(&bars[1]);              // + 8 * stage
  const uint32_t empty0 = smem_addr(&bars[1 + kStages]);

  // Longest query tiles first, over every head and sample.
  const int hb = a.H * a.B;
  const int qt = a.nq - 1 - static_cast<int>(blockIdx.x) / hb;
  const int h = static_cast<int>(blockIdx.x) % hb % a.H;
  const int b = static_cast<int>(blockIdx.x) % hb / a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = qt * kBQ;
  const int kend = a.causal ? min(a.Sk, q0 + kBQ) : a.Sk;
  const int ntiles = (kend + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // ---- producer: one thread issues every TMA load -------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == kConsumers / 32 && lane == 0) {
      mbar_expect_tx(qbar, Cfg<NC>::q);
      for (int c = 0; c < NC; ++c)
        tma_load(sq + c * kBQ * kRowBytes, &tq, qbar, c * kCols, q0, h, b);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(empty0 + 8 * st, (t / kStages - 1) & 1);
        const uint32_t full = full0 + 8 * st;
        mbar_expect_tx(full, 2 * Cfg<NC>::kv);
        const uint32_t ks = sk + st * Cfg<NC>::kv;
        const uint32_t vs = sv + st * Cfg<NC>::kv;
        for (int c = 0; c < NC; ++c) {
          tma_load(ks + c * KVB, &tk, full, c * kCols, t * BK, hk, b);
          tma_load(vs + c * KVB, &tv, full, c * kCols, t * BK, hk, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. + 63 ---------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp / 4;
    const int first = q0 + 64 * wg;                  // warpgroup's first row
    const int row0 = first + 16 * (warp % 4) + lane / 4;   // and row0 + 8
    const int cq = 2 * (lane % 4);
    const uint32_t qa = sq + wg * 64 * kRowBytes;

    float acc[NC][16];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[c][i] = 0.f;
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    uint32_t phi[BK / 16][4], plo[BK / 16][4];

    mbar_wait(qbar, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % kStages;
      const int k0 = t * BK;
      mbar_wait(full0 + 8 * st, (t / kStages) & 1);
      if (a.causal && k0 > first + 63) {     // above this warpgroup's diagonal
        mbar_arrive(empty0 + 8 * st);
        continue;
      }
      const uint32_t ks = sk + st * Cfg<NC>::kv;
      const uint32_t vs = sv + st * Cfg<NC>::kv;

      // S = Q K^T over D in k16 steps (two per 32-dim block)
      keep(s);
      wg_fence();
#pragma unroll
      for (int kd = 0; kd < 2 * NC; ++kd) {
        const uint32_t off = (kd & 1) * 32;          // bytes into the row
        wgmma_qk(s, desc64(qa + (kd >> 1) * kBQ * kRowBytes + off, 512, 512),
                 desc64(ks + (kd >> 1) * KVB + off, 512, 512), kd);
      }
      wg_commit();
      wg_wait();
      keep(s);

      if ((a.causal && k0 + BK - 1 > first) || k0 + BK > a.Sk) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int kpos = k0 + 8 * (i / 4) + cq + (i & 1);
          const int qpos = row0 + 8 * ((i >> 1) & 1);
          if (kpos >= a.Sk || (a.causal && kpos > qpos)) s[i] = -INFINITY;
        }
      }

      // online softmax in the log2 domain: x = s * scale * log2(e)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float safe[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * a.scale_log2);
        safe[r] = m_new == -INFINITY ? 0.f : m_new;
        corr[r] = exp2f(m[r] - safe[r]);          // m = -inf: 0
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        const float p = exp2f(fmaf(s[i], a.scale_log2, -safe[r]));
        l[r] += p;
        s[i] = p;
      }
      // P as bf16 hi + lo, in the A-fragment layout: for keys 16kb..+15,
      // registers (row, cols 0-7), (row + 8, 0-7), (row, 8-15), (row + 8,
      // 8-15) are accumulator pairs 8kb + 0/1, 2/3, 4/5, 6/7
#pragma unroll
      for (int kb = 0; kb < BK / 16; ++kb)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = s[8 * kb + 2 * r], y = s[8 * kb + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
          phi[kb][r] = *reinterpret_cast<const uint32_t*>(&hi);
          plo[kb][r] = pack_bf16(x - __low2float(hi), y - __high2float(hi));
        }
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[c][i] *= corr[(i >> 1) & 1];

      // O += P_hi V + P_lo V over the tile's keys in k16 steps, 64 head
      // dims (two swizzle blocks, BK * 64 bytes apart) per wgmma
#pragma unroll
      for (int c = 0; c < NC; ++c) keep(acc[c]);
      keep(phi);
      keep(plo);
      wg_fence();
#pragma unroll
      for (int kb = 0; kb < BK / 16; ++kb) {
#pragma unroll
        for (int c = 0; c < NC; c += 2) {
          const uint64_t dv = desc64(vs + c * KVB + kb * 16 * kRowBytes,
                                     KVB, 512);
          if (c + 1 < NC) {
            wgmma_pv(acc[c], acc[c + 1], phi[kb], dv);
            wgmma_pv(acc[c], acc[c + 1], plo[kb], dv);
          } else {
            wgmma_pv(acc[c], phi[kb], dv);
            wgmma_pv(acc[c], plo[kb], dv);
          }
        }
      }
      wg_commit();
      wg_wait();
#pragma unroll
      for (int c = 0; c < NC; ++c) keep(acc[c]);
      keep(phi);
      keep(plo);
      mbar_arrive(empty0 + 8 * st);
    }

    // o = acc / max(l, 1e-30), rows past Sq and dims past D not written
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      if (qpos >= a.Sq) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* op = o + b * a.ob + h * a.oh + qpos * a.os;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c * kCols + 8 * j + cq;
          const float x = acc[c][4 * j + 2 * r] / denom;
          const float y = acc[c][4 * j + 2 * r + 1] / denom;
          if (a.pairs && col + 1 < a.D) {
            *reinterpret_cast<__nv_bfloat162*>(op + col) =
                __floats2bfloat162_rn(x, y);
          } else {
            if (col < a.D) op[col] = __float2bfloat16_rn(x);
            if (col + 1 < a.D) op[col + 1] = __float2bfloat16_rn(y);
          }
        }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver that the runtime loaded.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (D, S, heads, B) map of one operand, boxes of 32 dims x `rows`,
// 64-byte swizzle, zeros out of bounds.  Strides in elements.
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int D,
                  int S, int heads, int B, long long ss, long long sh,
                  long long sb, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kCols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// q, k and v: base pointers and (batch, head, sequence) strides.
struct Operands {
  const void* ptr[3];
  long long stride[3][3];
};

// Returns a cudaError_t, or 1000 + the CUresult with which
// cuTensorMapEncodeTiled refused a tensor map.
template <int NC>
int launch(EncodeTiled enc, const Operands& in, void* o, const Args& a,
           cudaStream_t stream) {
  CUtensorMap maps[3];
  const int rows[3] = {kBQ, Cfg<NC>::BK, Cfg<NC>::BK};
  const int seq[3] = {a.Sq, a.Sk, a.Sk}, heads[3] = {a.H, a.Hkv, a.Hkv};
  for (int i = 0; i < 3; ++i) {
    const CUresult r = make_map(enc, &maps[i], in.ptr[i], a.D, seq[i],
                                heads[i], a.B, in.stride[i][2],
                                in.stride[i][1], in.stride[i][0], rows[i]);
    if (r != CUDA_SUCCESS) return 1000 + (int)r;
  }
  const int smem = Cfg<NC>::bytes + 1024;   // + the 1024-byte alignment
  auto kern = flash_attn_wgmma_kernel<NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (long long)a.nq * a.H * a.B;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), a);
  return (int)cudaGetLastError();
}

int dispatch(const Operands& in, void* o, int B, int H, int Hkv, int Sq,
             int Sk, int D, int causal, long long ob, long long oh,
             long long os, float scale, cudaStream_t stream) {
  // TMA: 16-byte aligned bases, strides a positive multiple of 16 bytes
  for (int i = 0; i < 3; ++i) {
    if (reinterpret_cast<uintptr_t>(in.ptr[i]) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    for (int j = 0; j < 3; ++j)
      if (in.stride[i][j] <= 0 || in.stride[i][j] % 8 != 0)
        return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  Args a;
  a.B = B; a.H = H; a.Hkv = Hkv; a.Sq = Sq; a.Sk = Sk; a.D = D;
  a.causal = causal; a.nq = (Sq + kBQ - 1) / kBQ;
  a.ob = ob; a.oh = oh; a.os = os;
  a.pairs = ((ob | oh | os) % 2 == 0 &&
             reinterpret_cast<uintptr_t>(o) % 4 == 0);
  a.scale_log2 = scale * 1.4426950408889634f;
  switch ((D + kCols - 1) / kCols) {
    case 1: return launch<1>(enc, in, o, a, stream);
    case 2: return launch<2>(enc, in, o, a, stream);
    case 3: return launch<3>(enc, in, o, a, stream);
    case 4: return launch<4>(enc, in, o, a, stream);
    case 5: return launch<5>(enc, in, o, a, stream);
    case 6: return launch<6>(enc, in, o, a, stream);
    case 7: return launch<7>(enc, in, o, a, stream);
    default: return launch<8>(enc, in, o, a, stream);
  }
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (the 3xTF32 mma.sync kernel), 1 = bfloat16 (the
// wgmma + TMA kernel), q, k, v and o alike; a causal launch needs Sq ==
// Sk.  Strides are in elements, over (batch, head, sequence); the head dim is
// unit-stride.  bf16 also needs q, k, v on 16-byte boundaries with every
// stride a positive multiple of 8 elements (what a TMA map can describe).
// Returns a cudaError_t, or 1000 + the CUresult with which
// cuTensorMapEncodeTiled refused a tensor map.
extern "C" int flash_attn_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int Hkv, int Sq, int Sk, int D, int causal, long long qb,
    long long qh, long long qs, long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs, long long ob, long long oh,
    long long os, float scale, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1 ||
      D < 1 || D > kMaxD || H > 65535 || B > 65535 ||
      (causal && Sq != Sk))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const tc::Operands in = {{q, k, v},
                             {{qb, qh, qs}, {kb, kh, ks}, {vb, vh, vs}}};
    return tc::dispatch(in, o, B, H, Hkv, Sq, Sk, D, causal, ob, oh, os,
                        scale, s);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  f32::Args a;
  a.B = B; a.H = H; a.Hkv = Hkv; a.Sq = Sq; a.Sk = Sk; a.D = D;
  a.causal = causal;
  a.qb = qb; a.qh = qh; a.qs = qs;
  a.kb = kb; a.kh = kh; a.ks = ks;
  a.vb = vb; a.vh = vh; a.vs = vs;
  a.ob = ob; a.oh = oh; a.os = os;
  a.scale = scale;
  return (int)f32::dispatch(static_cast<const float*>(q),
                            static_cast<const float*>(k),
                            static_cast<const float*>(v),
                            static_cast<float*>(o), a, s);
}
