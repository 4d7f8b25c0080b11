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
// The sum is exact (the wrapper refuses Cin*KTh*KTw*127^2 >= 2^31; a
// split-K partial sums fewer terms), and it is rounded to f32 once, by
// __int2float_rn; the multiply and the bias add are __fmul_rn /
// __fadd_rn, so nvcc cannot contract them into an FMA and the result is
// the plain version's (`sd_fused_ref` on an int8 pair) rounding for
// rounding: bit-identical for linear and relu, f32 or int8 out, within
// tanhf's ulps for tanh.
//
// What bounds it on the H100: each staged int8 feeds hundreds of
// multiply-adds at DCGAN's widths, so it is bound by arithmetic, at the
// s8 tensor cores' 1,979 TOP/s.  The design is K1's float branch
// (sd_fused.cu): the implicit GEMM of sd_igemm.cuh over M = B*MH*MW conv
// positions x N = Cout*sh*sw oc-major phase channels x K = KTh*KTw*Cin,
// the crop's whole rows and the pad folded into the input offset of
// position (0, 0), here on mma.sync m16n8k32 s8 x s8 -> s32 with int32
// accumulators (64-byte k-tiles, the B fragments transposed in
// registers; the header says how), 64 x BN blocks, a 3-stage cp.async
// ring and deterministic split-K over int32 partials.  Its epilogue
// (DequantShuffleEpi, in the GEMM kernel or, with split-K, in the reduce
// kernel) takes ShuffleEpi's map of each (position, phase channel) to its
// interleaved, cropped output element, with the dequant, bias, act and
// requantization above.  The output type is a template parameter; an
// int8 output is a quarter of the f32 output's bytes.

#include "sd_igemm.cuh"

namespace {

__device__ __forceinline__ void put(float* p, float r) { *p = r; }

// Round half to even, then clamp in float: never a wrapping cast.
__device__ __forceinline__ void put(int8_t* p, float r) {
  *p = static_cast<int8_t>(
      static_cast<int>(fminf(fmaxf(rintf(r), -127.f), 127.f)));
}

template <typename OutT>
struct DequantShuffleEpi {
  OutT* y;
  const float* scale;
  const float* bias;
  int MH, MW, sh, sw, res_h, res_w, OH, OW, Cout;
  int act;      // 0 linear, 1 relu, 2 tanh
  int sstride;  // scale row's batch stride: NC, or 0 for a static row
  __device__ __forceinline__ void store(int m, int c, int v, int) const {
    const int per = MH * MW;
    const int b = m / per, rem = m - b * per;
    const int cv = rem / MW, cu = rem - cv * MW;
    const int ss = sh * sw;
    const int oc = c / ss, ph = c - oc * ss;
    const int oy = cv * sh + ph / sw - res_h;
    const int ox = cu * sw + ph % sw - res_w;
    if (oy < 0 || oy >= OH || ox < 0 || ox >= OW) return;
    float r = __fmul_rn(__int2float_rn(v), scale[(long long)b * sstride + c]);
    r = __fadd_rn(r, bias[oc]);
    if (act == 1) r = fmaxf(r, 0.f);
    else if (act == 2) r = tanhf(r);
    put(y + (((long long)b * OH + oy) * OW + ox) * Cout + oc, r);
  }
};

}  // namespace

// x (B, H, W, Cin) int8, ws (KTh, KTw, Cin, Cout*sh*sw) int8 oc-major,
// scale f32 oc-major rows of Cout*sh*sw, row b at scale + b * sstride
// (sstride Cout*sh*sw for a (B, NC) scale, 0 for a static (1, NC) row),
// bias (Cout,) f32, y (B, OH, OW, Cout) f32, or int8 when out_int8 is 1
// (act linear or relu only).  work: splits x B*MH*MW x Cout*sh*sw int32
// when splits > 1, else unused.  Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int sd_fused_int8_launch(
    const void* x, const void* ws, const void* scale, const void* bias,
    void* y, void* work, int B, int H, int W, int Cin, int Cout, int KTh,
    int KTw, int sh, int sw, int q_h, int q_w, int plo_h, int plo_w,
    int res_h, int res_w, int OH, int OW, int bn, int splits, int act,
    int sstride, int out_int8, void* stream) {
  const int nc = Cout * sh * sw;
  if (act < 0 || act > 2 || sh < 1 || sw < 1 || (out_int8 && act == 2) ||
      (sstride != 0 && sstride != nc))
    return (int)cudaErrorInvalidValue;
  igemm::Geom g = {};
  g.B = B; g.H = H; g.W = W; g.Cin = Cin; g.KTh = KTh; g.KTw = KTw;
  g.MH = (OH + res_h + sh - 1) / sh;
  g.MW = (OW + res_w + sw - 1) / sw;
  g.r0 = q_h - plo_h; g.c0 = q_w - plo_w;
  g.N = nc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(ws);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  int* wk = static_cast<int*>(work);
  if (out_int8)
    return (int)igemm::run(
        xi, wi, g, bn, splits, wk,
        DequantShuffleEpi<int8_t>{static_cast<int8_t*>(y), sc, bi, g.MH,
                                  g.MW, sh, sw, res_h, res_w, OH, OW, Cout,
                                  act, sstride},
        s);
  return (int)igemm::run(
      xi, wi, g, bn, splits, wk,
      DequantShuffleEpi<float>{static_cast<float*>(y), sc, bi, g.MH, g.MW,
                               sh, sw, res_h, res_w, OH, OW, Cout, act,
                               sstride},
      s);
}
