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
//   Y      = A_h^T M A_w          (trimmed to the rows the block writes)
//
// with U = G g G^T transformed once at bind (repro_torch.kernels.winograd
// .transform_filters).  f32 or bf16 operands, the input converted to f32
// before the transform, f32 accumulation, output in the input's type.
// The Toom-Cook constants are not derived here: the wrapper hands the
// port's f32 `winograd_matrices` values in, as a kernel argument, so the
// kernel transforms with exactly the numbers the reference uses.
//
// What bounds it on the H100: at DCGAN's widths (F(2,3), Cin 64..256,
// 12..512 phase channels) the alpha^2 products do 16 multiply-adds per
// 2x2 tile and channel pair where the split conv does 36, so in f32 it is
// bound by the CUDA cores' 67 TFLOP/s on that reduced count; the input
// and output are read and written once.  The design:
//   * one block per (batch, band of nth x ntw Winograd tiles, tile of tc
//     phase channels); the TPU grid's sequential Cin axis is a loop in
//     the block;
//   * per Cin step the block stages the zero-masked input band
//     (nth*m_h + K_Th - 1 rows, P_I and the high side as masked reads,
//     channel planes of odd stride) and the (alpha^2, tcin, tc) block of
//     U in shared memory as f32, forms V = B^T d B for every (cin, tile)
//     into shared memory, and accumulates the alpha^2 small GEMMs
//     V[k] (tiles x tcin) . U[k] (tcin x tc) in f32 registers: each
//     thread owns up to two 4-tile x 4-channel register tiles of one k,
//     fed by two float4 shared loads per 16 FFMA (no TF32);
//   * the epilogue spills M to shared memory, and each thread takes
//     (tile, channel) pairs through A^T M A, drops the over-computed rows
//     (tiles round up to whole m), and maps each output straight to its
//     interleaved, cropped element with bias and activation, masking the
//     ragged edge as K1 does.
// wgmma, TMA and bf16 tensor cores are later work; int8 is rejected by
// the wrapper (the reference has no int8 Winograd).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kMicro = 4;
constexpr int kItems = 2;      // register tiles per thread
constexpr int kMaxAlpha = 6;   // F(2,5)
constexpr int kMaxM = 2;

// The transforms as the wrapper hands them: rows of kMaxAlpha floats.
struct Mats {
  float bt_h[kMaxAlpha * kMaxAlpha];   // B_h^T [x][a]
  float bt_w[kMaxAlpha * kMaxAlpha];   // B_w^T [x][a]
  float at_h[kMaxM * kMaxAlpha];       // A_h^T [o][x]
  float at_w[kMaxM * kMaxAlpha];       // A_w^T [o][x]
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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
  int q_h, q_w, plo_h, plo_w, res_h, res_w;
  int OH, OW;
  int th, tw, rh, rw, nth, ntw, nt, tp, tcin, tc, nw;
  int band_h, band_w, plane, band_words;
  int act;  // 0 linear, 1 relu, 2 tanh
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
sd_wino_kernel(const T* __restrict__ x, const T* __restrict__ u,
               const float* __restrict__ bias, T* __restrict__ y, Geom g,
               Mats mt) {
  extern __shared__ __align__(16) float smem[];
  float* band = smem;                               // [tcin][plane]
  float* vs = smem + g.band_words;                  // [kk][tcin][tp]
  float* us = vs + g.kk * g.tcin * g.tp;            // [kk][tcin][tc]

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * g.tc;
  const int tile_i = blockIdx.y / g.nw, tile_j = blockIdx.y % g.nw;
  const int b = blockIdx.z;
  // Band row 0 sits at padded row tile_i*th + q_h, i.e. input row
  // tile_i*th + q_h - plo_h (negative and >= H rows are the zero pad).
  const int xr0 = tile_i * g.th + g.q_h - g.plo_h;
  const int xc0 = tile_j * g.tw + g.q_w - g.plo_w;

  // This thread's register tiles: transform point k, tiles 4*wt.., phase
  // channels 4*wc.. of the block.
  const int cgroups = g.tc / kMicro, tgroups = g.tp / kMicro;
  int wk[kItems], wt[kItems], wc[kItems];
  bool wv[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int w = tid + r * kThreads;
    wc[r] = w % cgroups;
    wt[r] = (w / cgroups) % tgroups;
    wk[r] = w / cgroups / tgroups;
    wv[r] = wk[r] < g.kk;
    if (!wv[r]) wk[r] = 0;
  }
  float acc[kItems][kMicro][kMicro];
#pragma unroll
  for (int r = 0; r < kItems; ++r)
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) acc[r][i][j] = 0.f;

  const int vstride = g.tcin * g.tp;     // between transform points in vs
  for (int ci0 = 0; ci0 < g.Cin; ci0 += g.tcin) {
    const int nb = g.tcin * g.band_h * g.band_w;
    for (int idx = tid; idx < nb; idx += kThreads) {
      const int ic = idx % g.tcin;
      const int rest = idx / g.tcin;
      const int bc = rest % g.band_w;
      const int br = rest / g.band_w;
      const int xr = xr0 + br, xc = xc0 + bc, gi = ci0 + ic;
      float v = 0.f;
      if (xr >= 0 && xr < g.H && xc >= 0 && xc < g.W && gi < g.Cin)
        v = to_f32(x[(((long long)b * g.H + xr) * g.W + xc) * g.Cin + gi]);
      band[ic * g.plane + br * g.band_w + bc] = v;
    }
    const int nu = g.kk * g.tcin * g.tc;
    for (int idx = tid; idx < nu; idx += kThreads) {
      const int c = idx % g.tc;
      const int rest = idx / g.tc;
      const int ic = rest % g.tcin;
      const int k = rest / g.tcin;
      const int gc = c0 + c, gi = ci0 + ic;
      float v = 0.f;
      if (gc < g.NC && gi < g.Cin)
        v = to_f32(u[((long long)k * g.Cin + gi) * g.NC + gc]);
      us[idx] = v;
    }
    __syncthreads();

    // V = B_h^T d B_w for every (cin, tile); padding tile slots get 0.
    for (int idx = tid; idx < g.tcin * g.tp; idx += kThreads) {
      const int t = idx % g.tp;
      const int ic = idx / g.tp;
      float* vout = vs + ic * g.tp + t;
      if (t >= g.nt) {
        for (int k = 0; k < g.kk; ++k) vout[k * vstride] = 0.f;
        continue;
      }
      const int tr = t / g.ntw, tcl = t % g.ntw;
      const float* d0 =
          band + ic * g.plane + tr * g.mh * g.band_w + tcl * g.mw;
      // Loops run to kMaxAlpha so the arrays stay in registers; each
      // stops at the block-uniform alpha.
      float d[kMaxAlpha][kMaxAlpha];
#pragma unroll
      for (int a1 = 0; a1 < kMaxAlpha; ++a1) {
        if (a1 >= g.ah) break;
#pragma unroll
        for (int a2 = 0; a2 < kMaxAlpha; ++a2) {
          if (a2 >= g.aw) break;
          d[a1][a2] = d0[a1 * g.band_w + a2];
        }
      }
#pragma unroll
      for (int x1 = 0; x1 < kMaxAlpha; ++x1) {
        if (x1 >= g.ah) break;
        float row[kMaxAlpha];
#pragma unroll
        for (int a2 = 0; a2 < kMaxAlpha; ++a2) {
          if (a2 >= g.aw) break;
          float s = 0.f;
#pragma unroll
          for (int a1 = 0; a1 < kMaxAlpha; ++a1) {
            if (a1 >= g.ah) break;
            s = fmaf(mt.bt_h[x1 * kMaxAlpha + a1], d[a1][a2], s);
          }
          row[a2] = s;
        }
#pragma unroll
        for (int x2 = 0; x2 < kMaxAlpha; ++x2) {
          if (x2 >= g.aw) break;
          float s = 0.f;
#pragma unroll
          for (int a2 = 0; a2 < kMaxAlpha; ++a2) {
            if (a2 >= g.aw) break;
            s = fmaf(mt.bt_w[x2 * kMaxAlpha + a2], row[a2], s);
          }
          vout[(x1 * g.aw + x2) * vstride] = s;
        }
      }
    }
    __syncthreads();

    // The alpha^2 GEMMs: M[k] += V[k] (tiles x tcin) . U[k] (tcin x tc).
    for (int ic = 0; ic < g.tcin; ++ic) {
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        if (!wv[r]) continue;
        const float4 vv = *reinterpret_cast<const float4*>(
            vs + (wk[r] * g.tcin + ic) * g.tp + wt[r] * kMicro);
        const float4 uv = *reinterpret_cast<const float4*>(
            us + (wk[r] * g.tcin + ic) * g.tc + wc[r] * kMicro);
        const float va[kMicro] = {vv.x, vv.y, vv.z, vv.w};
        const float ua[kMicro] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j)
            acc[r][i][j] = fmaf(va[i], ua[j], acc[r][i][j]);
      }
    }
    __syncthreads();
  }

  // M to shared memory, [kk][tp][tc], over the staging buffers.
  float* ms = smem;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (!wv[r]) continue;
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j)
        ms[(wk[r] * g.tp + wt[r] * kMicro + i) * g.tc + wc[r] * kMicro + j] =
            acc[r][i][j];
  }
  __syncthreads();

  // Epilogue: Y = A_h^T M A_w per (tile, phase channel).  Conv position
  // (pr, pc) of the block, phase channel c = oc*sh*sw + py*sw + px, lands
  // on row pr*sh + py - res_h of the block's th*sh-row output tile.
  const int ss = g.sh * g.sw;
  for (int p = tid; p < g.nt * g.tc; p += kThreads) {
    const int c = p % g.tc, t = p / g.tc;
    const int gc = c0 + c;
    if (gc >= g.NC) continue;
    const int tr = t / g.ntw, tcl = t % g.ntw;
    float m[kMaxAlpha][kMaxAlpha];
#pragma unroll
    for (int x1 = 0; x1 < kMaxAlpha; ++x1) {
      if (x1 >= g.ah) break;
#pragma unroll
      for (int x2 = 0; x2 < kMaxAlpha; ++x2) {
        if (x2 >= g.aw) break;
        m[x1][x2] = ms[((x1 * g.aw + x2) * g.tp + t) * g.tc + c];
      }
    }
    const int oc = gc / ss, ph = gc % ss;
    const int py = ph / g.sw, px = ph % g.sw;
    const float bv = bias[oc];
#pragma unroll
    for (int o1 = 0; o1 < kMaxM; ++o1) {
      const int pr = tr * g.mh + o1;
      if (o1 >= g.mh || pr >= g.rh) break;
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
        const int pc = tcl * g.mw + o2;
        if (o2 >= g.mw || pc >= g.rw) break;
        float r = 0.f;
#pragma unroll
        for (int x2 = 0; x2 < kMaxAlpha; ++x2) {
          if (x2 >= g.aw) break;
          r = fmaf(mt.at_w[o2 * kMaxAlpha + x2], z[x2], r);
        }
        const int ly = pr * g.sh + py - g.res_h;
        const int lx = pc * g.sw + px - g.res_w;
        if (ly < 0 || ly >= g.th * g.sh || lx < 0 || lx >= g.tw * g.sw)
          continue;
        const int oy = tile_i * g.th * g.sh + ly;
        const int ox = tile_j * g.tw * g.sw + lx;
        if (oy >= g.OH || ox >= g.OW) continue;
        r += bv;
        if (g.act == 1) r = fmaxf(r, 0.f);
        else if (g.act == 2) r = tanhf(r);
        y[(((long long)b * g.OH + oy) * g.OW + ox) * g.Cout + oc] =
            from_f32<T>(r);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* u, const float* bias, void* y,
                   const Geom& g, const Mats& mt, int nh,
                   cudaStream_t stream) {
  const size_t stage =
      (size_t)g.band_words + (size_t)g.kk * g.tcin * (g.tp + g.tc);
  const size_t mwords = (size_t)g.kk * g.tp * g.tc;
  const size_t smem = sizeof(float) * (stage > mwords ? stage : mwords);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sd_wino_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((g.NC + g.tc - 1) / g.tc, nh * g.nw, g.B);
  sd_wino_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(u), bias,
      static_cast<T*>(y), g, mt);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, u and y share it; bias is f32).
// mats: host pointer to 96 floats, B_h^T, B_w^T (6x6 each), A_h^T, A_w^T
// (2x6 each), zero-filled past alpha and m; copied into the launch.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int sd_wino_launch(
    const void* x, const void* u, const void* bias, void* y,
    const void* mats, int dtype, int B, int H, int W, int Cin, int Cout,
    int KTh, int KTw, int sh, int sw, int mh, int mw, int q_h, int q_w,
    int plo_h, int plo_w, int res_h, int res_w, int OH, int OW, int th,
    int tw, int nth, int ntw, int tcin, int tc, int act, void* stream) {
  Geom g;
  g.B = B; g.H = H; g.W = W; g.Cin = Cin; g.Cout = Cout;
  g.NC = Cout * sh * sw;
  g.KTh = KTh; g.KTw = KTw; g.sh = sh; g.sw = sw; g.mh = mh; g.mw = mw;
  g.ah = mh + KTh - 1; g.aw = mw + KTw - 1; g.kk = g.ah * g.aw;
  g.q_h = q_h; g.q_w = q_w; g.plo_h = plo_h; g.plo_w = plo_w;
  g.res_h = res_h; g.res_w = res_w; g.OH = OH; g.OW = OW;
  g.th = th; g.tw = tw;
  g.rh = th + (res_h ? 1 : 0);
  g.rw = tw + (res_w ? 1 : 0);
  g.nth = nth; g.ntw = ntw; g.nt = nth * ntw;
  g.tp = (g.nt + kMicro - 1) / kMicro * kMicro;
  g.tcin = tcin; g.tc = tc;
  const int nh = (OH + th * sh - 1) / (th * sh);
  g.nw = (OW + tw * sw - 1) / (tw * sw);
  g.band_h = nth * mh + KTh - 1;
  g.band_w = ntw * mw + KTw - 1;
  g.plane = (g.band_h * g.band_w) | 1;
  g.band_words = (tcin * g.plane + kMicro - 1) / kMicro * kMicro;
  g.act = act;
  const int items = g.kk * (g.tp / kMicro) * (tc / kMicro);
  if (mh < 1 || mh > kMaxM || mw < 1 || mw > kMaxM || g.ah > kMaxAlpha ||
      g.aw > kMaxAlpha || KTh < 1 || KTw < 1 || nth * mh < g.rh ||
      ntw * mw < g.rw || tc < kMicro || tc % kMicro ||
      items > kItems * kThreads || tcin < 1 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  Mats mt;
  std::memcpy(&mt, mats, sizeof(Mats));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  if (dtype == 0) return (int)launch<float>(x, u, bp, y, g, mt, nh, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, u, bp, y, g, mt, nh, s);
  return (int)cudaErrorInvalidValue;
}
