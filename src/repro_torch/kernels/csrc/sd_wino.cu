// Fused Winograd split-deconvolution kernel for Hopper (sm_90a), float.
//
// Replaces the Pallas TPU kernel `sd_wino_pallas`
// (src/repro/kernels/winograd.py, body `_wino_fused_body`): the split
// stride-1 conv over the logically P_I-zero-padded input computed with
// F(m, K_T) minimal filtering per dim (m = 2, or 1 for a 1-tap dim),
// then K1's tail -- the sh x sw pixel-shuffle interleave, per-oc bias,
// linear/relu/tanh and the P_K + user-padding crop -- written once in
// final output geometry.  Per Winograd tile of m_h x m_w conv positions
// and phase channel c:
//
//   V[k]   = B_h^T d B_w          (d: the alpha_h x alpha_w input window)
//   M[k,c] = sum_ic V[k, ic] * U[k, ic, c]      k = 0 .. alpha_h*alpha_w-1
//   Y      = A_h^T M A_w
//
// with U = G g G^T transformed once at bind (repro_torch.kernels.winograd
// .transform_filters).  f32 or bf16 operands, the input converted to f32
// before the transform, f32 sums, output in the input's type.  The
// Toom-Cook constants are not derived here: the wrapper hands the port's
// f32 `winograd_matrices` values in, as a kernel argument.  The conv
// positions are K1's (sd_fused.cu): position (v, u) of sample b reads
// input (v + r0 + kh, u + c0 + kw), r0 = q - plo, and phase channel
// c = oc*sh*sw + py*sw + px of it lands on output (v*sh + py - res_h,
// u*sw + px - res_w) when inside; a tile's positions past the output's
// need read the zero halo and are dropped.
//
// What bounds it on the H100: at DCGAN's widths (F(2,3), Cin 64..256,
// 12..512 phase channels) the alpha^2 products do 16 multiply-adds per
// 2x2 tile and channel pair where the split conv does 36; in f32 on the
// CUDA cores their 67 TFLOP/s cap them.  So the products run on the
// tensor cores in 3xTF32, with K1/K2's arithmetic (sd_igemm.cuh): V and
// U split into TF32 hi + lo, lo*hi + hi*lo + hi*hi on mma.sync m16n8k8
// into f32 accumulators, each Cin chunk's mma sum promoted into an f32
// register sum on the CUDA cores.  A bf16 U is exact in TF32 and V is an
// f32 transform, so bf16 takes V_lo*U + V_hi*U: two passes.  The design:
//   * a block of 16 warps takes a band of nth x ntw Winograd tiles in nb
//     consecutive samples (up to 32 tile slots, two m16 row fragments)
//     x 32 or 16 phase channels, every transform point: DCGAN d1 holds
//     two whole samples (2 x 4 x 4 tiles) per block;
//   * warps own transform points (warp w: points w, w + 16, w + 32), so
//     each point's M tile stays in the owning warp's registers across
//     the Cin loop: one point per warp for alpha^2 <= 16; three, on 16
//     slots x 16 channels, for F(2,5)'s 36 (and any alpha^2 past 16);
//   * Cin runs in chunks of CK channels (16; 8 on 16 slots) through
//     cp.async double buffers: the input band two chunks ahead (16-byte
//     copies along Cin, the halo zero-filled by a source size of 0, each
//     band position's source offset worked out once per block), the U
//     chunk (CK x channels per point, loaded by the warp that owns the
//     point) one ahead, and V = B^T d B (f32, rows of CK + 4 floats read
//     by ldmatrix as the A operand) formed one chunk ahead of its
//     products;
//   * so one barrier per chunk separates the phases, and within a chunk
//     even warps multiply chunk c (their points' V, tiles x CK, by U,
//     CK x channels) while odd warps transform chunk c + 1, then the
//     other way round; each warp issues the next chunk's copies behind
//     its own work (its points' U after its products, its share of the
//     band after its transform).  Copies issued by every thread at the
//     top of a chunk stalled every warp there until they drained, and
//     loads, transform and products then took turns (knock-out variants
//     of the kernel each saved their own share of DCGAN d1's time);
//     staggered, the copies stream in while other warps compute;
//   * the input transform has an unrolled path for F(2,3) x F(2,3)
//     (alpha 4 x 4, DCGAN's); other alphas take loops bounded by the
//     block-uniform alpha;
//   * after the loop M goes to shared memory over the buffers, and each
//     thread takes (tile, channel) pairs through A^T M A, adds the bias,
//     applies the activation and writes each conv position's output
//     element through the interleave and crop, dropping what falls
//     outside the output; threads take output channels fastest within a
//     phase, so a warp's stores are contiguous.

#include "sd_igemm.cuh"

#include <cstring>

namespace {

using igemm::cp_async16;
using igemm::copy_elem;
using igemm::split;
using igemm::to_f32;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAlpha = 6;     // F(2,5)
constexpr int kMaxM = 2;

// The transforms as the wrapper hands them: rows of kMaxAlpha floats.
struct Mats {
  float bt_h[kMaxAlpha * kMaxAlpha];   // B_h^T [x][a]
  float bt_w[kMaxAlpha * kMaxAlpha];   // B_w^T [x][a]
  float at_h[kMaxM * kMaxAlpha];       // A_h^T [o][x]
  float at_w[kMaxM * kMaxAlpha];       // A_w^T [o][x]
};

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch does
}

struct Geom {
  int B, H, W, Cin, NC, Cout;
  int KTh, KTw, sh, sw, mh, mw, ah, aw, kk;
  int r0, c0;            // input row / col of conv position (0, 0)
  int res_h, res_w, OH, OW;
  int MH, MW;            // conv positions per sample the output needs
  int nth, ntw, nb;      // the block: band of tiles, samples
  int nbw;               // bands along a row of tiles
  int band_w, band_p;    // band columns, positions per sample
  int act;               // 0 linear, 1 relu, 2 tanh
  int vec_x, vec_u;      // 16-byte copies of x rows / U rows
};

// Shared memory of one block, in bytes from the start: the band
// positions' source offsets, two band buffers, two U buffers, two V
// buffers (f32); M (f32) reuses everything after the offsets.
template <typename T, int TM, int TC, int CK>
struct Layout {
  static constexpr int BX = CK + 8;    // band row, elements
  static constexpr int US = TC + 8;    // U row, elements
  static constexpr int VS = CK + 4;    // V row, f32 (ldmatrix, no conflict)
  static constexpr int MS = TC + 4;    // M row, f32
  size_t off, band, u, v, total;
  __host__ __device__ Layout(int positions, int kk) {
    off = 0;
    band = ((size_t)positions * sizeof(long long) + 15) / 16 * 16;
    const size_t band_b = (size_t)positions * BX * sizeof(T);
    u = band + 2 * band_b;
    const size_t u_b = (size_t)kk * CK * US * sizeof(T);
    v = u + 2 * u_b;
    const size_t v_b = (size_t)kk * TM * VS * 4;
    const size_t m_b = band + (size_t)kk * TM * MS * 4;
    total = v + 2 * v_b > m_b ? v + 2 * v_b : m_b;
  }
};

// V = B_h^T d B_w of one (tile, channel) into vout[k * vstep]; d's rows
// are band_w * BX elements apart.  AH, AW: the alphas at compile time,
// or 0 for the block-uniform ones, looping to kMaxAlpha.
template <int AH, int AW, int BX, typename T>
__device__ __forceinline__ void wino_in(const T* d0, int band_w, int ah_rt,
                                        int aw_rt, const Mats& mt,
                                        float* vout, int vstep) {
  constexpr int NH = AH ? AH : kMaxAlpha, NW = AW ? AW : kMaxAlpha;
  const int ah = AH ? AH : ah_rt, aw = AW ? AW : aw_rt;
  float d[NH][NW];
#pragma unroll
  for (int a1 = 0; a1 < NH; ++a1) {
    if (!AH && a1 >= ah) break;
#pragma unroll
    for (int a2 = 0; a2 < NW; ++a2) {
      if (!AW && a2 >= aw) break;
      d[a1][a2] = to_f32(d0[(a1 * band_w + a2) * BX]);
    }
  }
#pragma unroll
  for (int x1 = 0; x1 < NH; ++x1) {
    if (!AH && x1 >= ah) break;
    float row[NW];
#pragma unroll
    for (int a2 = 0; a2 < NW; ++a2) {
      if (!AW && a2 >= aw) break;
      float s = 0.f;
#pragma unroll
      for (int a1 = 0; a1 < NH; ++a1) {
        if (!AH && a1 >= ah) break;
        s = fmaf(mt.bt_h[x1 * kMaxAlpha + a1], d[a1][a2], s);
      }
      row[a2] = s;
    }
#pragma unroll
    for (int x2 = 0; x2 < NW; ++x2) {
      if (!AW && x2 >= aw) break;
      float s = 0.f;
#pragma unroll
      for (int a2 = 0; a2 < NW; ++a2) {
        if (!AW && a2 >= aw) break;
        s = fmaf(mt.bt_w[x2 * kMaxAlpha + a2], row[a2], s);
      }
      vout[(x1 * aw + x2) * vstep] = s;
    }
  }
}

// MT m16 row fragments of tile slots, NT n8 fragments of phase channels,
// PPW transform points per warp, CK input channels per chunk.
template <typename T, int MT, int NT, int PPW, int CK>
__global__ void __launch_bounds__(kThreads, 1)
sd_wino_kernel(const T* __restrict__ x, const T* __restrict__ u,
               const float* __restrict__ bias, T* __restrict__ y, Geom g,
               Mats mt) {
  constexpr int TM = MT * 16, TC = NT * 8;
  using L = Layout<T, TM, TC, CK>;
  constexpr int BX = L::BX, US = L::US, VS = L::VS, MS = L::MS;
  constexpr int V = 16 / sizeof(T);        // elements per 16-byte copy
  constexpr bool F32 = sizeof(T) == 4;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int positions = g.nb * g.band_p;
  const L lay(positions, g.kk);
  long long* band_off = reinterpret_cast<long long*>(smem_raw);
  T* bands = reinterpret_cast<T*>(smem_raw + lay.band);
  T* us = reinterpret_cast<T*>(smem_raw + lay.u);
  float* vs = reinterpret_cast<float*>(smem_raw + lay.v);
  const int band_elems = positions * BX, u_elems = g.kk * CK * US;
  const int v_elems = g.kk * TM * VS;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TC;
  const int bi = blockIdx.y / g.nbw, bj = blockIdx.y - bi * g.nbw;
  const int tr0 = bi * g.nth, tc0 = bj * g.ntw;
  const int b0 = blockIdx.z * g.nb;
  const int per = g.nth * g.ntw;            // tiles per sample of the band
  const int live = g.nb * per;              // slots that hold a tile
  const int nchunks = (g.Cin + CK - 1) / CK;

  // Each band position's offset in x (-1 outside x: the zero halo).
  for (int p = tid; p < positions; p += kThreads) {
    const int sb = p / g.band_p, rem = p - sb * g.band_p;
    const int br = rem / g.band_w, bc = rem - br * g.band_w;
    const int b = b0 + sb;
    const int xr = tr0 * g.mh + g.r0 + br, xc = tc0 * g.mw + g.c0 + bc;
    band_off[p] = (b < g.B && xr >= 0 && xr < g.H && xc >= 0 && xc < g.W)
                      ? (((long long)b * g.H + xr) * g.W + xc) * g.Cin
                      : -1LL;
  }
  __syncthreads();

  auto load_band = [&](int c, int s) {
    T* band = bands + s * band_elems;
    const int ci0 = c * CK;
    if (g.vec_x) {
      constexpr int PER = CK / V;
      for (int i = tid; i < positions * PER; i += kThreads) {
        const int p = i / PER, col = (i - p * PER) * V;
        const long long o = band_off[p];
        const bool ok = o >= 0 && ci0 + col < g.Cin;
        cp_async16(band + p * BX + col, ok ? x + o + ci0 + col : x, ok);
      }
    } else {
      for (int i = tid; i < positions * CK; i += kThreads) {
        const int p = i / CK, col = i - p * CK;
        const long long o = band_off[p];
        const bool ok = o >= 0 && ci0 + col < g.Cin;
        copy_elem(band + p * BX + col, ok ? x + o + ci0 + col : x, ok);
      }
    }
  };
  // The U chunk of this warp's transform points: CK rows x TC phase
  // channels each (only the owning warp reads them).
  const int warp = tid / 32, lane = tid % 32;
  auto load_u = [&](int c, int s) {
    const int ci0 = c * CK;
#pragma unroll
    for (int q = 0; q < PPW; ++q) {
      const int k = warp + q * kWarps;
      if (k >= g.kk) break;
      T* dst = us + s * u_elems + k * CK * US;
      const T* src = u + ((long long)k * g.Cin + ci0) * g.NC + n0;
      if (g.vec_u) {
        constexpr int PER = TC / V;
        for (int i = lane; i < CK * PER; i += 32) {
          const int r = i / PER, col = (i - r * PER) * V;
          const bool ok = ci0 + r < g.Cin && n0 + col < g.NC;
          cp_async16(dst + r * US + col,
                     ok ? src + (long long)r * g.NC + col : u, ok);
        }
      } else {
        for (int i = lane; i < CK * TC; i += 32) {
          const int r = i / TC, col = i - r * TC;
          const bool ok = ci0 + r < g.Cin && n0 + col < g.NC;
          copy_elem(dst + r * US + col,
                    ok ? src + (long long)r * g.NC + col : u, ok);
        }
      }
    }
  };

  // V of chunk c (band buffer s) into V buffer s: vs[k][slot][channel];
  // slots without a tile get 0.
  const bool a44 = g.ah == 4 && g.aw == 4;
  auto transform = [&](int s) {
    const T* band = bands + s * band_elems;
    float* v_s = vs + s * v_elems;
    constexpr int vstep = TM * VS;            // between transform points
    for (int i = tid; i < TM * CK; i += kThreads) {
      const int ci = i % CK, t = i / CK;
      float* vout = v_s + t * VS + ci;
      if (t >= live) {
        for (int k = 0; k < g.kk; ++k) vout[k * vstep] = 0.f;
        continue;
      }
      const int sb = t / per, rem = t - sb * per;
      const int tr = rem / g.ntw, tcl = rem - tr * g.ntw;
      const T* d0 = band + (sb * g.band_p + tr * g.mh * g.band_w +
                            tcl * g.mw) * BX + ci;
      if (a44)
        wino_in<4, 4, BX>(d0, g.band_w, 4, 4, mt, vout, vstep);
      else
        wino_in<0, 0, BX>(d0, g.band_w, g.ah, g.aw, mt, vout, vstep);
    }
  };

  const int gid = lane / 4, tig = lane % 4;

  // sum: M of this warp's points, the chunks' mma sums added in f32.
  float sum[PPW][MT][NT][4];
#pragma unroll
  for (int q = 0; q < PPW; ++q)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[q][i][j][e] = 0.f;

  // This warp's points of chunk c: V buffer s (tiles x CK) times U
  // buffer s (CK x TC), promoted into sum.  V's fragments of the whole
  // chunk are read and split once; then each n8 column of U takes its
  // own short accumulator, so few registers hold partial sums.
  auto products = [&](int s) {
    const float* v_s = vs + s * v_elems;
    const T* u_s = us + s * u_elems + tig * US + gid;
#pragma unroll
    for (int q = 0; q < PPW; ++q) {
      const int k = warp + q * kWarps;
      if (k >= g.kk) break;      // warp-uniform
      const float* vk = v_s + k * TM * VS;
      const T* uk = u_s + k * CK * US;
      constexpr int KS = CK / 8;
      uint32_t ah[KS][MT][4], al[KS][MT][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          float v[4];
          igemm::ldmatrix_a<VS>(v, vk + i * 16 * VS + ks * 8, lane);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split<float>(v[e], ah[ks][i][e], al[ks][i][e]);
        }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float acc[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const T* p = uk + ks * 8 * US + j * 8;
          uint32_t bh[2], bl[2];
          split<T>(to_f32(p[0]), bh[0], bl[0]);
          split<T>(to_f32(p[4 * US]), bh[1], bl[1]);
          // A bf16 U has no lo part: two passes.
#pragma unroll
          for (int i = 0; i < MT; ++i) igemm::mma_tf32(acc[i], al[ks][i], bh);
          if constexpr (F32) {
#pragma unroll
            for (int i = 0; i < MT; ++i)
              igemm::mma_tf32(acc[i], ah[ks][i], bl);
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) igemm::mma_tf32(acc[i], ah[ks][i], bh);
        }
        // Promote the chunk's sum out of the tensor cores' accumulator.
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[q][i][j][e] += acc[i][e];
      }
    }
  };

  // Prologue: band 0, then U 0 and band 1; V of chunk 0.
  load_band(0, 0);
  igemm::cp_async_commit();
  load_u(0, 0);
  if (nchunks > 1) load_band(1, 1);
  igemm::cp_async_commit();
  igemm::cp_async_wait<1>();
  __syncthreads();
  transform(0);
  // Each warp issues the next chunk's copies behind its own work of this
  // one: its points' U after its products, its share of the band after
  // its transform; the copies then stream in while other warps compute
  // instead of stalling every warp at the top of the chunk.
  for (int c = 0; c < nchunks; ++c) {
    igemm::cp_async_wait<0>();   // U(c) and band(c + 1) have landed
    __syncthreads();             // and V(c); chunk c-1 is done with
    for (int step = 0; step < 2; ++step) {
      if ((step ^ (warp & 1)) == 0) {
        products(c & 1);
        if (c + 1 < nchunks) load_u(c + 1, (c + 1) & 1);
      } else {
        if (c + 1 < nchunks) transform((c + 1) & 1);
        if (c + 2 < nchunks) load_band(c + 2, c & 1);
      }
    }
    igemm::cp_async_commit();
  }
  igemm::cp_async_wait<0>();
  __syncthreads();               // the buffers are free

  // M to shared memory, ms[k][slot][channel], after the offsets.  c0, c1
  // at (gid, 2*tig + {0, 1}); c2, c3 eight rows down.
  float* ms = reinterpret_cast<float*>(smem_raw + lay.band);
#pragma unroll
  for (int q = 0; q < PPW; ++q) {
    const int k = warp + q * kWarps;
    if (k >= g.kk) break;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ms[(k * TM + i * 16 + gid + (e >= 2 ? 8 : 0)) * MS + j * 8 +
             tig * 2 + (e & 1)] = sum[q][i][j][e];
  }
  __syncthreads();

  // Epilogue: Y = A_h^T M A_w per (tile, phase channel), each conv
  // position's value through K1's interleave and crop.  Where the tile
  // holds whole output channels, thread c' takes channel (c' % noc) *
  // ss + c' / noc: output channels fastest, phase by phase.
  const int ss = g.sh * g.sw;
  const int noc = TC % ss == 0 ? TC / ss : 0;
  for (int p = tid; p < live * TC; p += kThreads) {
    const int cp = p % TC, t = p / TC;
    const int c = noc ? (cp % noc) * ss + cp / noc : cp;
    const int gc = n0 + c;
    const int sb = t / per, rem = t - sb * per;
    const int b = b0 + sb;
    if (gc >= g.NC || b >= g.B) continue;
    const int tr = tr0 + rem / g.ntw, tcl = tc0 + rem % g.ntw;
    float m[kMaxAlpha][kMaxAlpha];
#pragma unroll
    for (int x1 = 0; x1 < kMaxAlpha; ++x1) {
      if (x1 >= g.ah) break;
#pragma unroll
      for (int x2 = 0; x2 < kMaxAlpha; ++x2) {
        if (x2 >= g.aw) break;
        m[x1][x2] = ms[((x1 * g.aw + x2) * TM + t) * MS + c];
      }
    }
    const int oc = gc / ss, ph = gc - oc * ss;
    const int py = ph / g.sw, px = ph - py * g.sw;
    const float bv = bias[oc];
#pragma unroll
    for (int o1 = 0; o1 < kMaxM; ++o1) {
      const int v = tr * g.mh + o1;
      if (o1 >= g.mh || v >= g.MH) break;
      float z[kMaxAlpha];
#pragma unroll
      for (int x2 = 0; x2 < kMaxAlpha; ++x2) {
        if (x2 >= g.aw) break;
        float s = 0.f;
#pragma unroll
        for (int x1 = 0; x1 < kMaxAlpha; ++x1) {
          if (x1 >= g.ah) break;
          s = fmaf(mt.at_h[o1 * kMaxAlpha + x1], m[x1][x2], s);
        }
        z[x2] = s;
      }
#pragma unroll
      for (int o2 = 0; o2 < kMaxM; ++o2) {
        const int uu = tcl * g.mw + o2;
        if (o2 >= g.mw || uu >= g.MW) break;
        float r = 0.f;
#pragma unroll
        for (int x2 = 0; x2 < kMaxAlpha; ++x2) {
          if (x2 >= g.aw) break;
          r = fmaf(mt.at_w[o2 * kMaxAlpha + x2], z[x2], r);
        }
        const int oy = v * g.sh + py - g.res_h;
        const int ox = uu * g.sw + px - g.res_w;
        if (oy < 0 || oy >= g.OH || ox < 0 || ox >= g.OW) continue;
        r += bv;
        if (g.act == 1) r = fmaxf(r, 0.f);
        else if (g.act == 2) r = tanhf(r);
        y[(((long long)b * g.OH + oy) * g.OW + ox) * g.Cout + oc] =
            from_f32<T>(r);
      }
    }
  }
}

template <typename T, int MT, int NT, int PPW, int CK>
cudaError_t launch(const void* x, const void* u, const float* bias, void* y,
                   const Geom& g, const Mats& mt, int bands,
                   cudaStream_t stream) {
  const Layout<T, MT * 16, NT * 8, CK> lay(g.nb * g.band_p, g.kk);
  const size_t smem = lay.total;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sd_wino_kernel<T, MT, NT, PPW, CK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((g.NC + NT * 8 - 1) / (NT * 8), bands,
                  (g.B + g.nb - 1) / g.nb);
  sd_wino_kernel<T, MT, NT, PPW, CK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(u), bias,
      static_cast<T*>(y), g, mt);
  return cudaGetLastError();
}

// The block shape for alpha^2 transform points and tc phase channels:
// one point per warp on 32 slots x tc in chunks of 16 channels, or three
// on 16 slots x 16 in chunks of 8.
template <typename T>
cudaError_t dispatch(const void* x, const void* u, const float* bias,
                     void* y, const Geom& g, const Mats& mt, int tc,
                     int bands, cudaStream_t stream) {
  if (g.kk <= kWarps && tc == 32)
    return launch<T, 2, 4, 1, 16>(x, u, bias, y, g, mt, bands, stream);
  if (g.kk <= kWarps && tc == 16)
    return launch<T, 2, 2, 1, 16>(x, u, bias, y, g, mt, bands, stream);
  if (g.kk <= 3 * kWarps && tc == 16)
    return launch<T, 1, 2, 3, 8>(x, u, bias, y, g, mt, bands, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, u and y share it; bias is f32).
// mats: host pointer to 96 floats, B_h^T, B_w^T (6x6 each), A_h^T, A_w^T
// (2x6 each), zero-filled past alpha and m; copied into the launch.  The
// plan: a band of nth x ntw Winograd tiles in nb samples per block (at
// most 32 tiles, 16 past 16 transform points) x tc (16 or 32; 16 past 16
// points) phase channels.  Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int sd_wino_launch(
    const void* x, const void* u, const void* bias, void* y,
    const void* mats, int dtype, int B, int H, int W, int Cin, int Cout,
    int KTh, int KTw, int sh, int sw, int mh, int mw, int q_h, int q_w,
    int plo_h, int plo_w, int res_h, int res_w, int OH, int OW, int nth,
    int ntw, int nb, int tc, int act, void* stream) {
  Geom g;
  g.B = B; g.H = H; g.W = W; g.Cin = Cin; g.Cout = Cout;
  g.NC = Cout * sh * sw;
  g.KTh = KTh; g.KTw = KTw; g.sh = sh; g.sw = sw; g.mh = mh; g.mw = mw;
  g.ah = mh + KTh - 1; g.aw = mw + KTw - 1; g.kk = g.ah * g.aw;
  g.r0 = q_h - plo_h; g.c0 = q_w - plo_w;
  g.res_h = res_h; g.res_w = res_w; g.OH = OH; g.OW = OW;
  g.act = act;
  if (mh < 1 || mh > kMaxM || mw < 1 || mw > kMaxM || KTh < 1 || KTw < 1 ||
      g.ah > kMaxAlpha || g.aw > kMaxAlpha || sh < 1 || sw < 1 || B < 1 ||
      Cin < 1 || Cout < 1 || OH < 1 || OW < 1 || nth < 1 || ntw < 1 ||
      nb < 1 || nb * nth * ntw > (g.kk <= kWarps ? 32 : 16) || act < 0 ||
      act > 2)
    return (int)cudaErrorInvalidValue;
  g.MH = (OH + res_h + sh - 1) / sh;
  g.MW = (OW + res_w + sw - 1) / sw;
  const int nt_h = (g.MH + mh - 1) / mh, nt_w = (g.MW + mw - 1) / mw;
  g.nth = nth; g.ntw = ntw; g.nb = nb;
  g.nbw = (nt_w + ntw - 1) / ntw;
  const long long bands = (long long)((nt_h + nth - 1) / nth) * g.nbw;
  if (bands > 65535 || (B + nb - 1) / nb > 65535)
    return (int)cudaErrorInvalidValue;
  g.band_w = ntw * mw + KTw - 1;
  g.band_p = (nth * mh + KTh - 1) * g.band_w;
  Mats mt;
  std::memcpy(&mt, mats, sizeof(Mats));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  if (dtype == 0) {
    g.vec_x = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    g.vec_u = g.NC % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0;
    return (int)dispatch<float>(x, u, bp, y, g, mt, tc, (int)bands, s);
  }
  if (dtype == 1) {
    g.vec_x = Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    g.vec_u = g.NC % 8 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0;
    return (int)dispatch<__nv_bfloat16>(x, u, bp, y, g, mt, tc, (int)bands,
                                        s);
  }
  return (int)cudaErrorInvalidValue;
}
