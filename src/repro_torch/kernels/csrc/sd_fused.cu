// Fused split-deconvolution kernel for Hopper (sm_90a), float branch.
//
// Replaces the Pallas TPU kernel `sd_fused_pallas`
// (src/repro/kernels/sd_conv.py, body `_sd_fused_body`): in one launch,
// the split stride-1 conv over the logically P_I-zero-padded input, the
// sh x sw pixel-shuffle interleave, per-oc bias, linear/relu/tanh and
// the P_K + user-padding crop, written once in final output geometry.
//
//   y[b, oy, ox, oc] = act(bias[oc] + sum_{th, tw, ic}
//       xpad[b, v + th, u + tw, ic] * ws[th, tw, ic, oc*sh*sw + py*sw + px])
//   with oy + crop_h = sh*v + py and ox + crop_w = sw*u + px,
//
// f32 or bf16 operands, f32 accumulation, output in the input's type.
//
// What bounds it on the H100: at DCGAN's widths (Cin 64..256, 4 phases
// x Cout 12..512 phase channels, 9 taps) every input element feeds
// hundreds of multiply-adds, so in f32 the kernel is bound by the
// 67 TFLOP/s of the CUDA cores, not by the 3.35 TB/s of HBM.  The
// design therefore keeps the operands of the FFMA stream in shared
// memory and registers:
//   * one block per (batch, tile of conv rows x cols, tile of phase
//     channels); the TPU grid's sequential Cin axis becomes a loop
//     inside the block (blocks run in no order and cannot carry a sum);
//   * per Cin step the block stages the zero-masked input band
//     ((rh + KTh - 1) x (rw + KTw - 1) x tcin, channel planes padded to
//     an odd stride so consecutive channels hit distinct banks) and the
//     (KTh, KTw, tcin, tc) filter block in shared memory, as f32;
//   * each thread keeps a 4 positions x 4 phase channels f32 register
//     tile and runs plain FFMA (no TF32: the f32 result must match the
//     reference to 1e-4 relative);
//   * the epilogue maps each (position, phase channel) register straight
//     to its interleaved, cropped output element, adds bias, applies the
//     activation and masks the ragged edge (the Pallas grid did that for
//     the TPU kernel; here the kernel does it).  Output-padding rows past
//     the shuffled support read fully masked input and come out as
//     act(bias).
// wgmma, TMA and bf16 tensor cores are later work; int8 is rejected by
// the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMicro = 4;

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
  int KTh, KTw, sh, sw;
  int q_h, q_w, plo_h, plo_w, res_h, res_w;
  int OH, OW;
  int th, tw, rh, rw, tcin, nw, bw, plane;
  int act;  // 0 linear, 1 relu, 2 tanh
};

template <typename T, int TX>
__global__ void __launch_bounds__(kThreads)
sd_fused_kernel(const T* __restrict__ x, const T* __restrict__ ws,
                const float* __restrict__ bias, T* __restrict__ y, Geom g) {
  constexpr int TY = kThreads / TX;   // threads along conv positions
  constexpr int TC = TX * kMicro;     // phase channels per block
  extern __shared__ __align__(16) float smem[];
  const int ntap = g.KTh * g.KTw;
  float* wf = smem;                           // [tap][tcin][TC]
  float* band = smem + ntap * g.tcin * TC;    // [tcin][plane]

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int c0 = blockIdx.x * TC;
  const int tile_i = blockIdx.y / g.nw, tile_j = blockIdx.y % g.nw;
  const int b = blockIdx.z;
  // Band row 0 sits at padded row tile_i*th + q_h, i.e. input row
  // tile_i*th + q_h - plo_h (negative and >= H rows are the zero pad).
  const int xr0 = tile_i * g.th + g.q_h - g.plo_h;
  const int xc0 = tile_j * g.tw + g.q_w - g.plo_w;

  int prow[kMicro], pcol[kMicro], pix[kMicro];
  bool pvalid[kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int p = ty + TY * i;
    pvalid[i] = p < g.rh * g.rw;
    prow[i] = pvalid[i] ? p / g.rw : 0;
    pcol[i] = pvalid[i] ? p % g.rw : 0;
    pix[i] = prow[i] * g.bw + pcol[i];
  }

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  const int bh = g.rh + g.KTh - 1;
  for (int ci0 = 0; ci0 < g.Cin; ci0 += g.tcin) {
    const int nf = ntap * g.tcin * TC;
    for (int idx = tid; idx < nf; idx += kThreads) {
      const int c = idx % TC;
      const int rest = idx / TC;
      const int ic = rest % g.tcin;
      const int tap = rest / g.tcin;
      const int gc = c0 + c, gi = ci0 + ic;
      float v = 0.f;
      if (gc < g.NC && gi < g.Cin)
        v = to_f32(ws[((long long)tap * g.Cin + gi) * g.NC + gc]);
      wf[idx] = v;
    }
    const int nb = g.tcin * bh * g.bw;
    for (int idx = tid; idx < nb; idx += kThreads) {
      const int ic = idx % g.tcin;
      const int rest = idx / g.tcin;
      const int bc = rest % g.bw;
      const int br = rest / g.bw;
      const int xr = xr0 + br, xc = xc0 + bc, gi = ci0 + ic;
      float v = 0.f;
      if (xr >= 0 && xr < g.H && xc >= 0 && xc < g.W && gi < g.Cin)
        v = to_f32(x[(((long long)b * g.H + xr) * g.W + xc) * g.Cin + gi]);
      band[ic * g.plane + br * g.bw + bc] = v;
    }
    __syncthreads();

    for (int kh = 0; kh < g.KTh; ++kh) {
      for (int kw = 0; kw < g.KTw; ++kw) {
        const float* wt = wf + (kh * g.KTw + kw) * g.tcin * TC + tx * kMicro;
        const float* bt = band + kh * g.bw + kw;
        for (int ic = 0; ic < g.tcin; ++ic) {
          const float4 wv = *reinterpret_cast<const float4*>(wt + ic * TC);
          const float* bp = bt + ic * g.plane;
#pragma unroll
          for (int i = 0; i < kMicro; ++i) {
            const float a = bp[pix[i]];
            acc[i][0] = fmaf(a, wv.x, acc[i][0]);
            acc[i][1] = fmaf(a, wv.y, acc[i][1]);
            acc[i][2] = fmaf(a, wv.z, acc[i][2]);
            acc[i][3] = fmaf(a, wv.w, acc[i][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // Epilogue: phase channel c = oc*sh*sw + py*sw + px of conv position
  // (prow, pcol) lands on row prow*sh + py - res_h of the block's
  // th*sh-row output tile (the residual crop is this static offset).
  const int ss = g.sh * g.sw;
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    if (!pvalid[i]) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int c = c0 + tx * kMicro + j;
      if (c >= g.NC) continue;
      const int oc = c / ss, ph = c % ss;
      const int ly = prow[i] * g.sh + ph / g.sw - g.res_h;
      const int lx = pcol[i] * g.sw + ph % g.sw - g.res_w;
      if (ly < 0 || ly >= g.th * g.sh || lx < 0 || lx >= g.tw * g.sw)
        continue;
      const int oy = tile_i * g.th * g.sh + ly;
      const int ox = tile_j * g.tw * g.sw + lx;
      if (oy >= g.OH || ox >= g.OW) continue;
      float r = acc[i][j] + bias[oc];
      if (g.act == 1) r = fmaxf(r, 0.f);
      else if (g.act == 2) r = tanhf(r);
      y[(((long long)b * g.OH + oy) * g.OW + ox) * g.Cout + oc] =
          from_f32<T>(r);
    }
  }
}

template <typename T, int TX>
cudaError_t launch(const void* x, const void* ws, const float* bias,
                   void* y, const Geom& g, int nh, cudaStream_t stream) {
  constexpr int TC = TX * kMicro;
  const size_t smem =
      sizeof(float) * ((size_t)g.KTh * g.KTw * g.tcin * TC +
                       (size_t)g.tcin * g.plane);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sd_fused_kernel<T, TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((g.NC + TC - 1) / TC, nh * g.nw, g.B);
  sd_fused_kernel<T, TX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ws), bias,
      static_cast<T*>(y), g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_tc(int tc, const void* x, const void* ws,
                        const float* bias, void* y, const Geom& g, int nh,
                        cudaStream_t stream) {
  switch (tc) {
    case 16: return launch<T, 4>(x, ws, bias, y, g, nh, stream);
    case 32: return launch<T, 8>(x, ws, bias, y, g, nh, stream);
    case 64: return launch<T, 16>(x, ws, bias, y, g, nh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, ws and y share it; bias is f32).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int sd_fused_launch(
    const void* x, const void* ws, const void* bias, void* y, int dtype,
    int B, int H, int W, int Cin, int Cout, int KTh, int KTw, int sh, int sw,
    int q_h, int q_w, int plo_h, int plo_w, int res_h, int res_w, int OH,
    int OW, int th, int tw, int tcin, int tc, int act, void* stream) {
  Geom g;
  g.B = B; g.H = H; g.W = W; g.Cin = Cin; g.Cout = Cout;
  g.NC = Cout * sh * sw;
  g.KTh = KTh; g.KTw = KTw; g.sh = sh; g.sw = sw;
  g.q_h = q_h; g.q_w = q_w; g.plo_h = plo_h; g.plo_w = plo_w;
  g.res_h = res_h; g.res_w = res_w; g.OH = OH; g.OW = OW;
  g.th = th; g.tw = tw;
  g.rh = th + (res_h ? 1 : 0);
  g.rw = tw + (res_w ? 1 : 0);
  g.tcin = tcin;
  const int nh = (OH + th * sh - 1) / (th * sh);
  g.nw = (OW + tw * sw - 1) / (tw * sw);
  g.bw = g.rw + KTw - 1;
  g.plane = ((g.rh + KTh - 1) * g.bw) | 1;
  g.act = act;
  if (g.rh * g.rw > kThreads * kMicro / (tc / kMicro) || tcin < 1 ||
      act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) return (int)dispatch_tc<float>(tc, x, ws, b, y, g, nh, s);
  if (dtype == 1)
    return (int)dispatch_tc<__nv_bfloat16>(tc, x, ws, b, y, g, nh, s);
  return (int)cudaErrorInvalidValue;
}
