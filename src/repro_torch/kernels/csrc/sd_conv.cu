// Stride-1 VALID convolution kernel for Hopper (sm_90a), f32: K2.
//
// Replaces the Pallas TPU kernel `sd_conv_pallas`
// (src/repro/kernels/sd_conv.py, body `_sd_conv_body`): a stride-1
// VALID conv over the logically zero-padded input, with the pad done in
// the kernel and a contiguous output window folded into the launch.
//
//   y[b, i, j, co] = sum_{kh, kw, ci}
//       xpad[b, os_h + i + kh, os_w + j + kw, ci] * w[kh, kw, ci, co]
//   xpad[b, r, c, ci] = x[b, r - plo_h, c - plo_w, ci] inside x, else 0
//
// for 0 <= i < OH, 0 <= j < OW.  Filters may be rectangular (KTh !=
// KTw).  In the SD backward it computes the input gradient: a FULL conv
// of the pixel-unshuffled cotangent dy1 with the split filters rotated
// 180 degrees and their channels swapped (pad KT - 1 on every side),
// whose window (os = P_I, size = the input's) is the pad^T crop, so dx
// is written once at its final shape.  The rotation and channel swap are
// a small copy of the filter made by the wrapper
// (kernels/ops.py `sd_input_grad_fused`); this kernel is a plain conv.
// The 3-D lowering runs it once per depth tap.
//
// What bounds it and the design: sd_igemm.cuh, the implicit-GEMM
// mainloop on 3xTF32 tensor cores that K1's float branch shares.  K2 is
// that GEMM with M = B*OH*OW output positions, N = Co and the window's
// origin os - plo as the input offset of position (0, 0); its epilogue
// writes C[m, n], which is y in (B, OH, OW, Co) order, masked at the
// ragged edges.  The int8 pair (exact int32 output) is sd_conv_int8.cu.

#include "sd_igemm.cuh"

namespace {

struct WindowEpi {
  float* y;
  int n;
  __device__ __forceinline__ void store(int m, int c, float v, int) const {
    y[(long long)m * n + c] = v;
  }
};

}  // namespace

// x (B, H, W, Cin), w (KTh, KTw, Cin, Co), y (B, OH, OW, Co), all f32 and
// contiguous; work: splits x B*OH*OW x Co f32 when splits > 1, else
// unused.  Returns cudaGetLastError() after the launches (0 on success).
extern "C" int sd_conv_launch(const void* x, const void* w, void* y,
                              void* work, int B, int H, int W, int Cin,
                              int Co, int KTh, int KTw, int plo_h, int plo_w,
                              int os_h, int os_w, int OH, int OW, int bn,
                              int splits, void* stream) {
  igemm::Geom g = {};
  g.B = B; g.H = H; g.W = W; g.Cin = Cin; g.KTh = KTh; g.KTw = KTw;
  g.MH = OH; g.MW = OW;
  g.r0 = os_h - plo_h; g.c0 = os_w - plo_w;
  g.N = Co;
  return (int)igemm::run(
      static_cast<const float*>(x), static_cast<const float*>(w), g, bn,
      splits, static_cast<float*>(work),
      WindowEpi{static_cast<float*>(y), Co},
      static_cast<cudaStream_t>(stream));
}
