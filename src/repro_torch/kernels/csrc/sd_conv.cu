// Stride-1 VALID convolution kernel for Hopper (sm_90a), f32: K2.
//
// Replaces the Pallas TPU kernel `sd_conv_pallas`
// (src/repro/kernels/sd_conv.py, body `_sd_conv_body`): a stride-1
// VALID conv over the logically zero-padded input, with the pad done by
// masked reads and a contiguous output window folded into the launch.
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
//
// What bounds it on the H100: at DCGAN's widths every staged input value
// feeds tc (16..64) multiply-adds per tap and the filters are reused by
// every position of the block, so it is bound by the 67 TFLOP/s of f32
// FFMA, not by HBM.  The design is K1's (sd_fused.cu) without the
// interleave epilogue:
//   * one block per (batch, tile of th x tw output positions, tile of tc
//     output channels); the TPU grid's sequential Cin axis becomes a loop
//     inside the block over chunks of tcin input channels;
//   * per chunk the block stages the zero-masked input band ((th + KTh -
//     1) x (tw + KTw - 1) x tcin, channel planes padded to an odd stride)
//     and the (KTh, KTw, tcin, tc) filter block in shared memory;
//   * each thread keeps a 4 positions x 4 channels f32 register tile and
//     runs plain FFMA (no TF32: the result must match the reference to
//     1e-4 relative);
//   * the ragged edge (output rows/cols past OH/OW, channels past Co,
//     input channels past Cin) is masked by the kernel.
// Narrow contractions (DCGAN d3's dx sums over only 12 phase channels)
// simply take one short chunk: tcin is min(32, Cin), never padded up.
// The int8 pair (exact int32 output) comes with the port's int8 slice.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMicro = 4;

struct Geom {
  int B, H, W, Cin, Co, KTh, KTw;
  int plo_h, plo_w, os_h, os_w, OH, OW;
  int th, tw, tcin, nw, bw, plane;
};

template <int TX>
__global__ void __launch_bounds__(kThreads)
sd_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ y, Geom g) {
  constexpr int TY = kThreads / TX;   // threads along output positions
  constexpr int TC = TX * kMicro;     // output channels per block
  extern __shared__ __align__(16) float smem[];
  const int ntap = g.KTh * g.KTw;
  float* wf = smem;                           // [tap][tcin][TC]
  float* band = smem + ntap * g.tcin * TC;    // [tcin][plane]

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int c0 = blockIdx.x * TC;
  const int tile_i = blockIdx.y / g.nw, tile_j = blockIdx.y % g.nw;
  const int b = blockIdx.z;
  // Band row 0 is padded row os_h + tile_i*th, i.e. input row
  // os_h + tile_i*th - plo_h (rows outside [0, H) read as zero).
  const int xr0 = g.os_h + tile_i * g.th - g.plo_h;
  const int xc0 = g.os_w + tile_j * g.tw - g.plo_w;

  int prow[kMicro], pcol[kMicro], pix[kMicro];
  bool pvalid[kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int p = ty + TY * i;
    pvalid[i] = p < g.th * g.tw;
    prow[i] = pvalid[i] ? p / g.tw : 0;
    pcol[i] = pvalid[i] ? p % g.tw : 0;
    pix[i] = prow[i] * g.bw + pcol[i];
  }

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  const int bh = g.th + g.KTh - 1;
  for (int ci0 = 0; ci0 < g.Cin; ci0 += g.tcin) {
    const int nf = ntap * g.tcin * TC;
    for (int idx = tid; idx < nf; idx += kThreads) {
      const int c = idx % TC;
      const int rest = idx / TC;
      const int ic = rest % g.tcin;
      const int tap = rest / g.tcin;
      const int gc = c0 + c, gi = ci0 + ic;
      float v = 0.f;
      if (gc < g.Co && gi < g.Cin)
        v = w[((long long)tap * g.Cin + gi) * g.Co + gc];
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
        v = x[(((long long)b * g.H + xr) * g.W + xc) * g.Cin + gi];
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

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    if (!pvalid[i]) continue;
    const int oy = tile_i * g.th + prow[i];
    const int ox = tile_j * g.tw + pcol[i];
    if (oy >= g.OH || ox >= g.OW) continue;
    float* yp = y + (((long long)b * g.OH + oy) * g.OW + ox) * g.Co;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int c = c0 + tx * kMicro + j;
      if (c < g.Co) yp[c] = acc[i][j];
    }
  }
}

template <int TX>
cudaError_t launch(const float* x, const float* w, float* y, const Geom& g,
                   int nh, cudaStream_t stream) {
  constexpr int TC = TX * kMicro;
  const size_t smem =
      sizeof(float) * ((size_t)g.KTh * g.KTw * g.tcin * TC +
                       (size_t)g.tcin * g.plane);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sd_conv_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((g.Co + TC - 1) / TC, nh * g.nw, g.B);
  sd_conv_kernel<TX><<<grid, kThreads, smem, stream>>>(x, w, y, g);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, Cin), w (KTh, KTw, Cin, Co), y (B, OH, OW, Co), all f32 and
// contiguous.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int sd_conv_launch(const void* x, const void* w, void* y, int B,
                              int H, int W, int Cin, int Co, int KTh,
                              int KTw, int plo_h, int plo_w, int os_h,
                              int os_w, int OH, int OW, int th, int tw,
                              int tcin, int tc, void* stream) {
  Geom g;
  g.B = B; g.H = H; g.W = W; g.Cin = Cin; g.Co = Co;
  g.KTh = KTh; g.KTw = KTw; g.plo_h = plo_h; g.plo_w = plo_w;
  g.os_h = os_h; g.os_w = os_w; g.OH = OH; g.OW = OW;
  g.th = th; g.tw = tw; g.tcin = tcin;
  const int nh = (OH + th - 1) / th;
  g.nw = (OW + tw - 1) / tw;
  g.bw = tw + KTw - 1;
  g.plane = ((th + KTh - 1) * g.bw) | 1;
  if (tc < kMicro || th * tw > kThreads * kMicro / (tc / kMicro) ||
      tcin < 1)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tc) {
    case 16: return (int)launch<4>(xf, wf, yf, g, nh, s);
    case 32: return (int)launch<8>(xf, wf, yf, g, nh, s);
    case 64: return (int)launch<16>(xf, wf, yf, g, nh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
