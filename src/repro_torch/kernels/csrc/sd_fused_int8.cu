// Fused split-deconvolution kernel for Hopper (sm_90a), int8 branch.
//
// Replaces the quant branch of the Pallas TPU kernel `sd_fused_pallas`
// (src/repro/kernels/sd_conv.py, body `_sd_fused_body` with quant=True,
// :284-349): in one launch, the split stride-1 conv of int8 activations
// with int8 oc-major split filters over the logically P_I-zero-padded
// input, accumulated exactly in int32; the dequant by the combined
// (sample, phase channel) scale BEFORE the interleave; then the sh x sw
// pixel-shuffle, per-oc bias, linear/relu/tanh and the P_K +
// user-padding crop, written once in final output geometry.
//
//   acc[b, v, u, c] = sum_{th, tw, ic} xq[b, v + th, u + tw, ic]
//                                      * wq[th, tw, ic, c]        (int32)
//   r = act(bias[oc] + RN_f32(acc[b, v, u, c]) * scale[b * sstride + c])
//   y[b, oy, ox, oc] = r                          (f32 output), or
//   y[b, oy, ox, oc] = int8(clamp(rint(r), -127, 127))   (int8 output)
//   with c = oc*sh*sw + py*sw + px, oy + crop_h = sh*v + py and
//   ox + crop_w = sw*u + px.
//
// The scale row has a batch stride: NC for the dynamic (B, NC) scale of
// per-sample activation scales, 0 for the calibrated path's static
// (1, NC) row, which every sample reads in place (the TPU kernel binds
// it with a batch-independent index map).  The scale column is the phase
// channel c of the conv output, not the interleaved position: each
// (phase, oc) split filter has its own filter scale.
//
// int8 output is the chained epilogue of the calibrated path: the caller
// has folded the next layer's 1/sx into scale and bias, so the activated
// value is already in the next layer's code units; it is rounded half to
// even (rintf), clamped to +-127 in float (never a wrapping cast) and
// written as int8, so the inter-layer tensor crosses device memory as
// int8.  act is linear or relu there (the wrapper refuses tanh, which
// does not commute with the scale).
//
// The sum is exact (the wrapper refuses Cin*KTh*KTw*127^2 >= 2^31), and
// it is rounded to f32 once, by __int2float_rn; the multiply and the
// bias add are __fmul_rn / __fadd_rn, so nvcc cannot contract them into
// an FMA and the result is the plain version's (`sd_fused_ref` on an
// int8 pair) rounding for rounding: bit-identical for linear and relu,
// f32 or int8 out, within tanhf's ulps for tanh.
//
// What bounds it on the H100: each staged int8 feeds hundreds of
// multiply-adds at DCGAN's widths, so it is bound by arithmetic.  This
// first version runs that arithmetic on the CUDA cores with __dp4a (four
// int8 products summed into an int32 per instruction), far below the
// int8 tensor cores' rate.  Its design is K1's (sd_fused.cu):
//   * one block per (batch, tile of conv rows x cols, tile of phase
//     channels); the TPU grid's sequential Cin axis is a loop inside
//     the block;
//   * per Cin step the block stages the zero-masked input band and the
//     (KTh, KTw, tcin, tc) filter block in shared memory as int8, packed
//     four consecutive input channels to a 32-bit word (a Cin or tcin
//     tail that is not a multiple of 4 is zero-filled): 4x smaller than
//     K1's f32 staging;
//   * each thread keeps a 4 positions x 4 phase channels int32 register
//     tile and runs one __dp4a per (position, channel, word);
//   * the epilogue dequantizes each register with its sample's scale
//     row, then maps it to its interleaved, cropped output element, adds
//     bias, applies the activation, requantizes for int8 output and
//     masks the ragged edge as K1 does.  The output type is a template
//     parameter; an int8 output is a quarter of the f32 output's bytes.
// int8 mma/wgmma, TMA and cp.async are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMicro = 4;

struct Geom {
  int B, H, W, Cin, NC, Cout;
  int KTh, KTw, sh, sw;
  int q_h, q_w, plo_h, plo_w, res_h, res_w;
  int OH, OW;
  int th, tw, rh, rw, tcin, tcw, nw, bw, plane;
  int act;  // 0 linear, 1 relu, 2 tanh
  int sstride;  // scale row's batch stride: NC, or 0 for a static row
};

__device__ __forceinline__ void store(float* p, float r) { *p = r; }

// Round half to even, then clamp in float: never a wrapping cast.
__device__ __forceinline__ void store(int8_t* p, float r) {
  *p = static_cast<int8_t>(
      static_cast<int>(fminf(fmaxf(rintf(r), -127.f), 127.f)));
}

template <int TX, typename OutT>
__global__ void __launch_bounds__(kThreads)
sd_fused_int8_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ ws,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     OutT* __restrict__ y, Geom g) {
  constexpr int TY = kThreads / TX;   // threads along conv positions
  constexpr int TC = TX * kMicro;     // phase channels per block
  extern __shared__ __align__(16) int smem[];
  const int ntap = g.KTh * g.KTw;
  int* wf = smem;                             // [tap][tcw][TC] words
  int* band = smem + ntap * g.tcw * TC;       // [tcw][plane] words

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int c0 = blockIdx.x * TC;
  const int tile_i = blockIdx.y / g.nw, tile_j = blockIdx.y % g.nw;
  const int b = blockIdx.z;
  const int xr0 = tile_i * g.th + g.q_h - g.plo_h;
  const int xc0 = tile_j * g.tw + g.q_w - g.plo_w;
  // Four channels to a word can be read as one 32-bit load when every
  // word starts on a multiple of 4 of an NHWC row that is itself a
  // multiple of 4 bytes long, from a 4-byte aligned base.
  const bool vec = (g.Cin % 4 == 0) && (g.tcin % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(x) & 3) == 0);

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

  int acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0;

  const int bh = g.rh + g.KTh - 1;
  for (int ci0 = 0; ci0 < g.Cin; ci0 += g.tcin) {
    // Filter block: word (tap, icw, c) packs input channels ci0 + 4*icw
    // + k, k = 0..3, of phase channel c0 + c, lane k = bits 8k..8k+7.
    const int nf = ntap * g.tcw * TC;
    for (int idx = tid; idx < nf; idx += kThreads) {
      const int c = idx % TC;
      const int rest = idx / TC;
      const int icw = rest % g.tcw;
      const int tap = rest / g.tcw;
      const int gc = c0 + c;
      uint32_t word = 0;
      if (gc < g.NC) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ic = icw * 4 + k, gi = ci0 + ic;
          if (ic < g.tcin && gi < g.Cin)
            word |= (uint32_t)(uint8_t)
                        ws[((long long)tap * g.Cin + gi) * g.NC + gc]
                    << (8 * k);
        }
      }
      wf[idx] = (int)word;
    }
    // Input band: word (icw, row, col), the same packing; rows and cols
    // outside the input are the P_I zero pad.
    const int nb = g.tcw * bh * g.bw;
    for (int idx = tid; idx < nb; idx += kThreads) {
      const int icw = idx % g.tcw;
      const int rest = idx / g.tcw;
      const int bc = rest % g.bw;
      const int br = rest / g.bw;
      const int xr = xr0 + br, xc = xc0 + bc, gi = ci0 + 4 * icw;
      uint32_t word = 0;
      if (xr >= 0 && xr < g.H && xc >= 0 && xc < g.W && gi < g.Cin) {
        const int8_t* px =
            x + (((long long)b * g.H + xr) * g.W + xc) * g.Cin + gi;
        if (vec) {
          word = *reinterpret_cast<const uint32_t*>(px);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (4 * icw + k < g.tcin && gi + k < g.Cin)
              word |= (uint32_t)(uint8_t)px[k] << (8 * k);
        }
      }
      band[icw * g.plane + br * g.bw + bc] = (int)word;
    }
    __syncthreads();

    for (int kh = 0; kh < g.KTh; ++kh) {
      for (int kw = 0; kw < g.KTw; ++kw) {
        const int* wt = wf + (kh * g.KTw + kw) * g.tcw * TC + tx * kMicro;
        const int* bt = band + kh * g.bw + kw;
        for (int icw = 0; icw < g.tcw; ++icw) {
          const int4 wv = *reinterpret_cast<const int4*>(wt + icw * TC);
          const int* bp = bt + icw * g.plane;
#pragma unroll
          for (int i = 0; i < kMicro; ++i) {
            const int a = bp[pix[i]];
            acc[i][0] = __dp4a(a, wv.x, acc[i][0]);
            acc[i][1] = __dp4a(a, wv.y, acc[i][1]);
            acc[i][2] = __dp4a(a, wv.z, acc[i][2]);
            acc[i][3] = __dp4a(a, wv.w, acc[i][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // Epilogue: dequantize phase channel c with this sample's scale row
  // (before the interleave; a static row has stride 0), then K1's
  // interleave, bias, act and crop, and the requantization for int8 out.
  const float* srow = scale + (long long)b * g.sstride;
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
      float r = __fmul_rn(__int2float_rn(acc[i][j]), srow[c]);
      r = __fadd_rn(r, bias[oc]);
      if (g.act == 1) r = fmaxf(r, 0.f);
      else if (g.act == 2) r = tanhf(r);
      store(y + (((long long)b * g.OH + oy) * g.OW + ox) * g.Cout + oc, r);
    }
  }
}

template <int TX, typename OutT>
cudaError_t launch(const int8_t* x, const int8_t* ws, const float* scale,
                   const float* bias, OutT* y, const Geom& g, int nh,
                   cudaStream_t stream) {
  constexpr int TC = TX * kMicro;
  const size_t smem =
      sizeof(int) * ((size_t)g.KTh * g.KTw * g.tcw * TC +
                     (size_t)g.tcw * g.plane);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sd_fused_int8_kernel<TX, OutT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((g.NC + TC - 1) / TC, nh * g.nw, g.B);
  sd_fused_int8_kernel<TX, OutT><<<grid, kThreads, smem, stream>>>(
      x, ws, scale, bias, y, g);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t dispatch(const int8_t* x, const int8_t* ws, const float* scale,
                     const float* bias, void* y, const Geom& g, int nh,
                     int tc, cudaStream_t s) {
  OutT* yo = static_cast<OutT*>(y);
  switch (tc) {
    case 16: return launch<4>(x, ws, scale, bias, yo, g, nh, s);
    case 32: return launch<8>(x, ws, scale, bias, yo, g, nh, s);
    case 64: return launch<16>(x, ws, scale, bias, yo, g, nh, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, H, W, Cin) int8, ws (KTh, KTw, Cin, Cout*sh*sw) int8 oc-major,
// scale f32 oc-major rows of Cout*sh*sw, row b at scale + b * sstride
// (sstride Cout*sh*sw for a (B, NC) scale, 0 for a static (1, NC) row),
// bias (Cout,) f32, y (B, OH, OW, Cout) f32, or int8 when out_int8 is 1
// (act linear or relu only).  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int sd_fused_int8_launch(
    const void* x, const void* ws, const void* scale, const void* bias,
    void* y, int B, int H, int W, int Cin, int Cout, int KTh, int KTw,
    int sh, int sw, int q_h, int q_w, int plo_h, int plo_w, int res_h,
    int res_w, int OH, int OW, int th, int tw, int tcin, int tc, int act,
    int sstride, int out_int8, void* stream) {
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
  g.tcw = (tcin + 3) / 4;
  const int nh = (OH + th * sh - 1) / (th * sh);
  g.nw = (OW + tw * sw - 1) / (tw * sw);
  g.bw = g.rw + KTw - 1;
  g.plane = ((g.rh + KTh - 1) * g.bw) | 1;
  g.act = act;
  g.sstride = sstride;
  if (g.rh * g.rw > kThreads * kMicro / (tc / kMicro) || tcin < 1 ||
      act < 0 || act > 2 || (out_int8 && act == 2) ||
      (sstride != 0 && sstride != g.NC))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(ws);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  return (int)(out_int8 ? dispatch<int8_t>(xi, wi, sc, bi, y, g, nh, tc, s)
                        : dispatch<float>(xi, wi, sc, bi, y, g, nh, tc, s));
}
