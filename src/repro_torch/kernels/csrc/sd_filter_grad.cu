// Filter-gradient kernel of the SD backward for Hopper (sm_90a), f32: K3.
//
// Replaces the Pallas TPU kernel `sd_filter_grad_pallas`
// (src/repro/kernels/sd_conv.py, body `_sd_filter_grad_body`): the
// gradient of y1 = conv_valid(pad(x, P_I), ws) with respect to the split
// filters ws,
//
//   dws[kh, kw, ci, co] = sum_{b, v, u}
//       xpad[b, v + kh, u + kw, ci] * dy1[b, v, u, co]
//   xpad[b, r, c, ci] = x[b, r - plo_h, c - plo_w, ci] inside x, else 0
//
// with the P_I pad done by masked reads (no padded copy of x exists).
// It is one GEMM,
//
//   C[(tap, ci), co] = sum_m A[(tap, ci), m] * dy1[m, co],
//   A[(tap, ci), m] = xpad[b, v + kh, u + kw, ci],  m = (b*O1h + v)*O1w + u,
//
// of KTh*KTw*Cin rows, NCo columns and a contraction over the M = B *
// O1h * O1w positions of the cotangent (DCGAN d1 at batch 16: 2,304 x 512
// x 1,600; d3: 576 x 12 x 18,496).
//
// What bounds it on the H100: the output is small and the contraction
// long; in f32 on the CUDA cores the 67 TFLOP/s of FFMA cap it.  So it
// runs on the tensor cores in 3xTF32, with the arithmetic of K1/K2's
// mainloop (sd_igemm.cuh): each f32 operand split into TF32 hi + lo,
// lo*hi + hi*lo + hi*hi on mma.sync m16n8k8 into f32 accumulators, each
// k-tile's mma sum promoted into an f32 register sum on the CUDA cores
// (the accumulator truncates), split-K into f32 slabs summed in split
// order by igemm_reduce_kernel, so the result is the same on every run.
//
// The design, K1/K2's tile shapes on the transposed problem:
//   * a block of 4 warps computes a 64 x BN tile of C (BN 16, 32 or 64:
//     DCGAN d3's 12 channels take 16) whose 64 rows are input channels of
//     one tap (a tap's Cin is rounded up to whole row tiles, the tail
//     masked), so a k-tile of A is 32 positions x 64 channels of x
//     shifted by the block's tap;
//   * both operands arrive k-major: A as [position][ci], staged by
//     16-byte cp.async along ci (4-byte copies where Cin is not a
//     multiple of 4) with the P_I halo zero-filled by a source size of 0,
//     B (dy1) as [position][co], as load_b reads the filters;
//   * A's fragments are read transposed out of shared memory (ldmatrix
//     .trans does not move 32-bit elements): rows padded to 72 floats
//     (72 = 8 mod 32), so a warp's reads of tig * 72 + gid hit 32
//     distinct banks; B's rows pad to BN + 8 as in sd_igemm.cuh;
//   * each position's (b, v, u) is worked out once per k-tile row by the
//     16 threads that copy its channels, with divisions by invariant
//     integers (multiply-high and shift), not per element;
//   * a 3-stage cp.async ring keeps the next k-tiles in flight;
//   * where the row x column tiles cannot fill the 132 SMs (d3 has 9),
//     the positions are split over blockIdx.z (split-K).

#include "sd_igemm.cuh"

namespace {

using igemm::cp_async16;
using igemm::kBK;
using igemm::kBM;
using igemm::kStages;
using igemm::kThreads;

constexpr int kAS = kBM + 8;   // A row: 64 input channels + pad (= 8 mod 32)

// n / d for 0 <= n < 2^31 as multiply-high and shift (the divisor is
// invariant across the launch): mul = ceil(2^p / d), p = 31 + ceil(log2 d).
struct FastDiv {
  int d;
  unsigned mul, shr;
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)(__umulhi((unsigned)n, mul) >> shr);
  }
};

FastDiv make_div(int d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    int l = 0;
    while ((1LL << l) < d) ++l;
    const int p = 31 + l;
    f.mul = (unsigned)(((1ULL << p) + (unsigned long long)d - 1) / d);
    f.shr = (unsigned)(p - 32);
  }
  return f;
}

struct Geom {
  int B, H, W, Cin, NCo, KTh, KTw;
  int plo_h, plo_w, O1h, O1w;
  int M;              // B * O1h * O1w, the contraction
  int nci;            // row tiles (64 input channels) per tap
  int vec_x, vec_d;   // 16-byte copies of x rows / dy1 rows
  int kt_per_split;
  FastDiv per_sample, per_row;   // by O1h * O1w and by O1w
};

// C[row, co] straight into dws (KTh, KTw, Cin, NCo): row = tap * Cin + ci.
struct StoreEpi {
  float* out;
  int n;
  __device__ __forceinline__ void store(int m, int c, float v, int) const {
    out[(long long)m * n + c] = v;
  }
};

template <int BN, class Epi>
__global__ void __launch_bounds__(kThreads)
sd_filter_grad_kernel(const float* __restrict__ x,
                      const float* __restrict__ dy, Geom g, Epi epi) {
  constexpr int WARPS_M = BN == 16 ? 4 : 2;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WM = kBM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int BS = igemm::b_stride<BN>();
  constexpr int A_STAGE = kBK * kAS, B_STAGE = kBK * BS;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);   // [stage][pos][ci]
  float* Bs = As + kStages * A_STAGE;                // [stage][pos][co]

  const int tid = threadIdx.x;
  const int tap = blockIdx.x / g.nci;
  const int ci0 = (blockIdx.x - tap * g.nci) * kBM;
  const int kh = tap / g.KTw, kw = tap - kh * g.KTw;
  const int n0 = blockIdx.y * BN;
  const int nk = (g.M + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * g.kt_per_split;
  const int ntiles = max(0, min(nk, kt0 + g.kt_per_split) - kt0);

  // A tile: kBK positions x kBM channels.  A thread keeps one channel
  // group (4 channels, or 1 for element copies) and walks positions.
  const int a_width = g.vec_x ? 4 : 1;
  const int a_per_row = kBM / a_width;
  const int a_col = (tid % a_per_row) * a_width;
  const int a_step = kThreads / a_per_row;
  const bool a_cok = ci0 + a_col < g.Cin;
  const float* xc0 = x + ci0 + a_col;
  auto load_a = [&](int stage, int kt) {
    float* dst = As + stage * A_STAGE + a_col;
    for (int r = tid / a_per_row; r < kBK; r += a_step) {
      const int m = kt * kBK + r;
      const int b = g.per_sample.div(m), rem = m - b * g.per_sample.d;
      const int v = g.per_row.div(rem), u = rem - v * g.O1w;
      const int xr = v + kh - g.plo_h, xc = u + kw - g.plo_w;
      const bool ok = a_cok && m < g.M && xr >= 0 && xr < g.H && xc >= 0 &&
                      xc < g.W;
      const float* src =
          ok ? xc0 + ((long long)(b * g.H + xr) * g.W + xc) * g.Cin : x;
      if (g.vec_x)
        cp_async16(dst + r * kAS, src, ok);
      else
        igemm::copy_elem(dst + r * kAS, src, ok);
    }
  };
  // B tile: kBK positions x BN channels of dy1 (M x NCo, row-major).
  auto load_b = [&](int stage, int kt) {
    float* dst = Bs + stage * B_STAGE;
    if (g.vec_d) {
      constexpr int PER = BN / 4;
      for (int i = tid; i < kBK * PER; i += kThreads) {
        const int r = i / PER, col = (i - r * PER) * 4;
        const int m = kt * kBK + r, n = n0 + col;
        const bool ok = m < g.M && n < g.NCo;
        cp_async16(dst + r * BS + col,
                   ok ? dy + (long long)m * g.NCo + n : dy, ok);
      }
    } else {
      for (int i = tid; i < kBK * BN; i += kThreads) {
        const int r = i / BN, col = i - r * BN;
        const int m = kt * kBK + r, n = n0 + col;
        const bool ok = m < g.M && n < g.NCo;
        igemm::copy_elem(dst + r * BS + col,
                         ok ? dy + (long long)m * g.NCo + n : dy, ok);
      }
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int gid = lane / 4, tig = lane % 4;

  // acc: the mma accumulator of the current k-tile; sum: the k-tiles'
  // sums, added in f32 on the CUDA cores.
  float acc[MT][NT][4], sum[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = sum[i][j][e] = 0.f;

  constexpr int S = kStages;
  for (int s = 0; s < S - 1; ++s) {
    if (s < ntiles) {
      load_a(s, kt0 + s);
      load_b(s, kt0 + s);
    }
    igemm::cp_async_commit();
  }

  for (int t = 0; t < ntiles; ++t) {
    igemm::cp_async_wait<S - 2>();   // tile t has landed (this thread's)
    __syncthreads();                 // everyone's; stage (t-1)%S is free
    const int next = t + S - 1;
    if (next < ntiles) {
      load_a(next % S, kt0 + next);
      load_b(next % S, kt0 + next);
    }
    igemm::cp_async_commit();

    // a0..a3 of row (channel) gid / gid + 8, column (position) tig /
    // tig + 4: As[tig][gid], As[tig][gid + 8], As[tig + 4][gid], ...
    const float* a_s = As + (t % S) * A_STAGE + tig * kAS + wm * WM + gid;
    const float* b_s = Bs + (t % S) * B_STAGE + tig * BS + wn * WN + gid;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* p = a_s + kk * kAS + i * 16;
        const float v[4] = {p[0], p[8], p[4 * kAS], p[4 * kAS + 8]};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          igemm::split<float>(v[e], ah[i][e], al[i][e]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* p = b_s + kk * BS + j * 8;
        igemm::split<float>(p[0], bh[j][0], bl[j][0]);
        igemm::split<float>(p[4 * BS], bh[j][1], bl[j][1]);
      }
      // Pass by pass, so that consecutive mma never share an accumulator.
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) igemm::mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) igemm::mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) igemm::mma_tf32(acc[i][j], ah[i], bh[j]);
    }
    // Promote the tile's sum out of the tensor cores' accumulator.
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sum[i][j][e] += acc[i][j][e];
          acc[i][j][e] = 0.f;
        }
  }
  igemm::cp_async_wait<0>();

  // c0, c1 at (gid, 2*tig + {0, 1}); c2, c3 eight rows down.
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = ci0 + wm * WM + i * 16 + gid + (e >= 2 ? 8 : 0);
        const int n = n0 + wn * WN + j * 8 + tig * 2 + (e & 1);
        if (ci < g.Cin && n < g.NCo)
          epi.store(tap * g.Cin + ci, n, sum[i][j][e], blockIdx.z);
      }
}

template <int BN, class Epi>
cudaError_t launch_gemm(const float* x, const float* dy, const Geom& g,
                        int splits, Epi epi, cudaStream_t stream) {
  constexpr size_t smem =
      (size_t)kStages * kBK * (kAS + igemm::b_stride<BN>()) * sizeof(float);
  if constexpr (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sd_filter_grad_kernel<BN, Epi>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(g.KTh * g.KTw * g.nci, (g.NCo + BN - 1) / BN, splits);
  sd_filter_grad_kernel<BN, Epi><<<grid, kThreads, smem, stream>>>(
      x, dy, g, epi);
  return cudaGetLastError();
}

template <int BN>
cudaError_t run_bn(const float* x, const float* dy, const Geom& g,
                   int splits, float* part, float* out,
                   cudaStream_t stream) {
  const StoreEpi epi{out, g.NCo};
  if (splits == 1) return launch_gemm<BN>(x, dy, g, 1, epi, stream);
  const int rows = g.KTh * g.KTw * g.Cin;
  const long long mn = (long long)rows * g.NCo;
  const cudaError_t err = launch_gemm<BN>(
      x, dy, g, splits, igemm::PartialEpi{part, mn, g.NCo}, stream);
  if (err != cudaSuccess) return err;
  const long long blocks = (mn + 255) / 256;
  igemm::igemm_reduce_kernel<StoreEpi>
      <<<(int)(blocks < 1056 ? blocks : 1056), 256, 0, stream>>>(
          part, splits, rows, g.NCo, epi);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, Cin), dy (B, O1h, O1w, NCo), out (KTh, KTw, Cin, NCo), all
// f32 and contiguous.  The plan: bn (16, 32 or 64) output channels per
// block and `splits` runs of whole 32-position k-tiles; `part` is a
// workspace of splits * |out| floats, used (and then summed into `out` in
// split order) only when splits > 1.  Returns the first CUDA error of the
// launches (0 on success).
extern "C" int sd_filter_grad_launch(const void* x, const void* dy,
                                     void* part, void* out, int B, int H,
                                     int W, int Cin, int NCo, int KTh,
                                     int KTw, int plo_h, int plo_w, int O1h,
                                     int O1w, int bn, int splits,
                                     void* stream) {
  Geom g;
  g.B = B; g.H = H; g.W = W; g.Cin = Cin; g.NCo = NCo;
  g.KTh = KTh; g.KTw = KTw; g.plo_h = plo_h; g.plo_w = plo_w;
  g.O1h = O1h; g.O1w = O1w;
  if (B < 1 || O1h < 1 || O1w < 1 || Cin < 1 || NCo < 1 || KTh < 1 ||
      KTw < 1 || splits < 1 || splits > 65535 ||
      (long long)B * O1h * O1w >= (1LL << 31) ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  g.M = B * O1h * O1w;
  g.nci = (Cin + kBM - 1) / kBM;
  const int nk = (g.M + kBK - 1) / kBK;
  g.kt_per_split = (nk + splits - 1) / splits;
  g.vec_x = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.vec_d = NCo % 4 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  g.per_sample = make_div(O1h * O1w);
  g.per_row = make_div(O1w);
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(dy);
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 16: return (int)run_bn<16>(xf, df, g, splits, pf, of, s);
    case 32: return (int)run_bn<32>(xf, df, g, splits, pf, of, s);
    case 64: return (int)run_bn<64>(xf, df, g, splits, pf, of, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
