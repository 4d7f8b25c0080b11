// Stride-1 VALID convolution kernel for Hopper (sm_90a), int8 pair: K2's
// int8 branch.
//
// Replaces the int8 branch of the Pallas TPU kernel `sd_conv_pallas`
// (src/repro/kernels/sd_conv.py, body `_sd_conv_body` through
// `_conv_partial` on an int8 (x, w) pair): a stride-1 VALID conv of int8
// activations with int8 filters over the logically zero-padded input,
// with the pad done by masked reads (the halo is the int8 zero, which is
// exact under symmetric quantization) and a contiguous output window
// folded into the launch, summed exactly in int32:
//
//   y[b, i, j, co] = sum_{kh, kw, ci}
//       xpad[b, os_h + i + kh, os_w + j + kw, ci] * w[kh, kw, ci, co]
//   xpad[b, r, c, ci] = x[b, r - plo_h, c - plo_w, ci] inside x, else 0
//
// for 0 <= i < OH, 0 <= j < OW; y is int32 and the caller owns the
// dequant.  Its caller is the 3-D split-deconv lowering
// (kernels/ops.py `sd_deconv_presplit_fused_3d`): one launch per depth
// tap with (batch x output depth) folded into the batch, the taps summed
// in int32 outside the kernel.  The wrapper refuses a geometry whose
// whole sum (Cin x all taps, including the depth taps summed outside)
// could reach 2^31, so every int32 here, and every split-K partial (which
// sums fewer terms), is exact.
//
// What bounds it on the H100: at VoxGAN's tap shapes (batch 16) the conv
// does 0.08-0.38 GOP but writes 2-6 MB of int32 sums, so at the int8
// tensor cores' 1,979 TOP/s it is bound by its output's bytes at
// 3.35 TB/s; the multiply-adds must run on the tensor cores to stay
// below that (on dp4a they took 10-30x the bound).  The design is K2 in f32 (sd_conv.cu) on the int8 path of the shared
// implicit GEMM (sd_igemm.cuh, as K1's int8 branch sd_fused_int8.cu runs
// it): M = B*OH*OW output positions x N = Co x K = KTh*KTw*Cin, the
// window's origin os - plo as the input offset of position (0, 0), on
// mma.sync m16n8k32 s8 x s8 -> s32 with int32 accumulators, 64-byte
// k-tiles, 64 x BN blocks, a 3-stage cp.async ring and deterministic
// split-K over int32 partials summed in split order.  Its epilogue writes
// C[m, n], which is y in (B, OH, OW, Co) order, masked at the ragged
// edges.

#include "sd_igemm.cuh"

namespace {

struct WindowEpi {
  int* y;
  int n;
  __device__ __forceinline__ void store(int m, int c, int v, int) const {
    y[(long long)m * n + c] = v;
  }
};

}  // namespace

// x (B, H, W, Cin) int8, w (KTh, KTw, Cin, Co) int8, y (B, OH, OW, Co)
// int32, all contiguous; work: splits x B*OH*OW x Co int32 when
// splits > 1, else unused.  Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int sd_conv_int8_launch(const void* x, const void* w, void* y,
                                   void* work, int B, int H, int W,
                                   int Cin, int Co, int KTh, int KTw,
                                   int plo_h, int plo_w, int os_h, int os_w,
                                   int OH, int OW, int bn, int splits,
                                   void* stream) {
  igemm::Geom g = {};
  g.B = B; g.H = H; g.W = W; g.Cin = Cin; g.KTh = KTh; g.KTw = KTw;
  g.MH = OH; g.MW = OW;
  g.r0 = os_h - plo_h; g.c0 = os_w - plo_w;
  g.N = Co;
  return (int)igemm::run(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), g, bn,
      splits, static_cast<int*>(work),
      WindowEpi{static_cast<int*>(y), Co},
      static_cast<cudaStream_t>(stream));
}
