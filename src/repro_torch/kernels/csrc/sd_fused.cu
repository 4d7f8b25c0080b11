// Fused split-deconvolution kernel for Hopper (sm_90a), float branch.
//
// Replaces the Pallas TPU kernel `sd_fused_pallas`
// (src/repro/kernels/sd_conv.py, body `_sd_fused_body`): in one call,
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
// What bounds it and the design: sd_igemm.cuh, the implicit-GEMM
// mainloop on the tensor cores that K2 (sd_conv.cu) shares: 3xTF32 for
// f32, one pass for bf16 (exact in TF32).  K1 is that GEMM over the
// conv positions that the cropped output needs, M = B*MH*MW with MH =
// ceil((OH + res_h) / sh) (MW alike), and N = Cout*sh*sw oc-major phase
// channels; the crop's whole-row part q and the pad plo fold into the
// input offset q - plo of position (0, 0).  Its epilogue (ShuffleEpi,
// in the GEMM kernel or, with split-K, in the reduce kernel) maps each
// (position, phase channel) straight to its interleaved, cropped output
// element: oy = v*sh + py - res_h, ox = u*sw + px - res_w, dropped when
// outside the output; adds the bias in f32, applies the activation and
// rounds to the output type once.  Every output element has exactly one
// (position, phase channel), and output-padding rows past the shuffled
// support read only the zero halo, so they come out as act(bias).
// The int8 branch is sd_fused_int8.cu.

#include "sd_igemm.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch does
}

template <typename T>
struct ShuffleEpi {
  T* y;
  const float* bias;
  int MH, MW, sh, sw, res_h, res_w, OH, OW, Cout;
  int act;  // 0 linear, 1 relu, 2 tanh
  __device__ __forceinline__ void store(int m, int c, float v, int) const {
    const int per = MH * MW;
    const int b = m / per, rem = m - b * per;
    const int cv = rem / MW, cu = rem - cv * MW;
    const int ss = sh * sw;
    const int oc = c / ss, ph = c - oc * ss;
    const int oy = cv * sh + ph / sw - res_h;
    const int ox = cu * sw + ph % sw - res_w;
    if (oy < 0 || oy >= OH || ox < 0 || ox >= OW) return;
    float r = v + bias[oc];
    if (act == 1) r = fmaxf(r, 0.f);
    else if (act == 2) r = tanhf(r);
    y[(((long long)b * OH + oy) * OW + ox) * Cout + oc] = from_f32<T>(r);
  }
};

}  // namespace

// dtype: 0 = float32 (3xTF32), 1 = bfloat16 (one TF32 pass, exact
// products); x, ws and y share it, bias is f32.  work: splits x
// B*MH*MW x Cout*sh*sw f32 when splits > 1, else unused.  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int sd_fused_launch(
    const void* x, const void* ws, const void* bias, void* y, void* work,
    int dtype, int B, int H, int W, int Cin, int Cout, int KTh, int KTw,
    int sh, int sw, int q_h, int q_w, int plo_h, int plo_w, int res_h,
    int res_w, int OH, int OW, int bn, int splits, int act,
    void* stream) {
  if (act < 0 || act > 2 || sh < 1 || sw < 1)
    return (int)cudaErrorInvalidValue;
  igemm::Geom g = {};
  g.B = B; g.H = H; g.W = W; g.Cin = Cin; g.KTh = KTh; g.KTw = KTw;
  g.MH = (OH + res_h + sh - 1) / sh;
  g.MW = (OW + res_w + sw - 1) / sw;
  g.r0 = q_h - plo_h; g.c0 = q_w - plo_w;
  g.N = Cout * sh * sw;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* wk = static_cast<float*>(work);
  if (dtype == 0)
    return (int)igemm::run(
        static_cast<const float*>(x), static_cast<const float*>(ws), g, bn,
        splits, wk,
        ShuffleEpi<float>{static_cast<float*>(y), b, g.MH, g.MW, sh, sw,
                          res_h, res_w, OH, OW, Cout, act},
        s);
  if (dtype == 1)
    return (int)igemm::run(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(ws), g, bn, splits, wk,
        ShuffleEpi<__nv_bfloat16>{static_cast<__nv_bfloat16*>(y), b, g.MH,
                                  g.MW, sh, sw, res_h, res_w, OH, OW, Cout,
                                  act},
        s);
  return (int)cudaErrorInvalidValue;
}
