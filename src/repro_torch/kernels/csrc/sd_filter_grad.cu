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
// Per tap it is one GEMM (Cin x M) . (M x NCo) over the M = B * O1h *
// O1w positions of the cotangent.
//
// What bounds it on the H100: the output is tiny (KT^2 * Cin * NCo, e.g.
// 3*3*256*512 on DCGAN d1) and the reduction long (M = 1,600 on d1 and
// 18,496 on d3 at batch 16); in f32 it is bound by the 67 TFLOP/s of
// FFMA.  The TPU kernel carried the batch as its innermost sequential
// grid axis; blocks on Hopper run in no order, so the reduction is split
// across blocks instead, deterministically, in two passes:
//   1. one block per (tile of tco output channels, tap x tile of 64 input
//      channels, chunk of `chunk` positions of M): it stages 32 positions
//      at a time of the masked, tap-shifted x rows (32 x 64) and of dy1
//      (32 x tco) in shared memory and keeps a 4 x 4 f32 register tile per
//      thread (plain FFMA, no TF32), then writes its partial sum to a
//      workspace slice of its own;
//   2. a reduce kernel adds the slices in a fixed order.
// With a single chunk the first pass writes the output and the second is
// skipped.  No atomics, so the result is the same on every run.
// Narrow outputs (DCGAN d3: NCo = 12) take a 16-channel tile in a block
// of 64 threads, and many chunks keep the card busy.

#include <cuda_runtime.h>

namespace {

constexpr int kMicro = 4;
constexpr int kTci = 64;   // input channels per block
constexpr int kMk = 32;    // positions of M staged per step

struct Geom {
  int B, H, W, Cin, NCo, KTh, KTw;
  int plo_h, plo_w, O1h, O1w, M, chunk, nci;
  long long n_out;  // KTh * KTw * Cin * NCo
};

template <int TXO>
__global__ void __launch_bounds__(kTci / kMicro * TXO)
sd_filter_grad_kernel(const float* __restrict__ x,
                      const float* __restrict__ dy,
                      float* __restrict__ out, Geom g) {
  constexpr int TCO = TXO * kMicro;
  constexpr int NT = kTci / kMicro * TXO;
  __shared__ __align__(16) float xs[kMk][kTci];
  __shared__ __align__(16) float ds[kMk][TCO];

  const int tid = threadIdx.x;
  const int tx = tid % TXO, ty = tid / TXO;
  const int co0 = blockIdx.x * TCO;
  const int tap = blockIdx.y / g.nci;
  const int ci0 = (blockIdx.y % g.nci) * kTci;
  const int kh = tap / g.KTw, kw = tap % g.KTw;
  const int m_begin = blockIdx.z * g.chunk;
  const int m_end = min(g.M, m_begin + g.chunk);
  const int o1 = g.O1h * g.O1w;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  for (int m0 = m_begin; m0 < m_end; m0 += kMk) {
    for (int idx = tid; idx < kMk * kTci; idx += NT) {
      const int r = idx / kTci, c = idx % kTci;
      const int m = m0 + r, gi = ci0 + c;
      float v = 0.f;
      if (m < m_end && gi < g.Cin) {
        const int bb = m / o1, rem = m - bb * o1;
        const int vv = rem / g.O1w, u = rem - vv * g.O1w;
        const int xr = vv + kh - g.plo_h, xc = u + kw - g.plo_w;
        if (xr >= 0 && xr < g.H && xc >= 0 && xc < g.W)
          v = x[(((long long)bb * g.H + xr) * g.W + xc) * g.Cin + gi];
      }
      xs[r][c] = v;
    }
    for (int idx = tid; idx < kMk * TCO; idx += NT) {
      const int r = idx / TCO, c = idx % TCO;
      const int m = m0 + r, gc = co0 + c;
      ds[r][c] = (m < m_end && gc < g.NCo)
                     ? dy[(long long)m * g.NCo + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kMk; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[r][ty * kMicro]);
      const float4 d = *reinterpret_cast<const float4*>(&ds[r][tx * kMicro]);
      const float av[kMicro] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
        acc[i][0] = fmaf(av[i], d.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], d.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], d.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], d.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

  float* dst = out + (long long)blockIdx.z * g.n_out;
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int ci = ci0 + ty * kMicro + i;
    if (ci >= g.Cin) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int co = co0 + tx * kMicro + j;
      if (co < g.NCo)
        dst[((long long)tap * g.Cin + ci) * g.NCo + co] = acc[i][j];
    }
  }
}

// out[i] = sum over the chunks' partial slices, in chunk order.
__global__ void sd_filter_grad_reduce(const float* __restrict__ part,
                                      float* __restrict__ out, long long n,
                                      int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(long long)k * n + i];
    out[i] = s;
  }
}

template <int TXO>
cudaError_t launch(const float* x, const float* dy, float* dst,
                   const Geom& g, int splits, cudaStream_t stream) {
  constexpr int TCO = TXO * kMicro;
  const dim3 grid((g.NCo + TCO - 1) / TCO, g.KTh * g.KTw * g.nci, splits);
  sd_filter_grad_kernel<TXO><<<grid, kTci / kMicro * TXO, 0, stream>>>(
      x, dy, dst, g);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, Cin), dy (B, O1h, O1w, NCo), out (KTh, KTw, Cin, NCo), all
// f32 and contiguous.  `part` is a workspace of ceil(M / chunk) * |out|
// floats, used (and then reduced into `out`) only when there is more
// than one chunk.  Returns the first CUDA error of the two launches (0 on
// success).
extern "C" int sd_filter_grad_launch(const void* x, const void* dy,
                                     void* part, void* out, int B, int H,
                                     int W, int Cin, int NCo, int KTh,
                                     int KTw, int plo_h, int plo_w, int O1h,
                                     int O1w, int tco, int chunk,
                                     void* stream) {
  Geom g;
  g.B = B; g.H = H; g.W = W; g.Cin = Cin; g.NCo = NCo;
  g.KTh = KTh; g.KTw = KTw; g.plo_h = plo_h; g.plo_w = plo_w;
  g.O1h = O1h; g.O1w = O1w; g.M = B * O1h * O1w; g.chunk = chunk;
  g.nci = (Cin + kTci - 1) / kTci;
  g.n_out = (long long)KTh * KTw * Cin * NCo;
  if (chunk < 1 || g.M < 1) return (int)cudaErrorInvalidValue;
  const int splits = (g.M + chunk - 1) / chunk;
  if (splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(dy);
  float* dst = static_cast<float*>(splits > 1 ? part : out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (tco) {
    case 16: err = launch<4>(xf, df, dst, g, splits, s); break;
    case 32: err = launch<8>(xf, df, dst, g, splits, s); break;
    case 64: err = launch<16>(xf, df, dst, g, splits, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long blocks = (g.n_out + 255) / 256;
  sd_filter_grad_reduce<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0,
                          s>>>(dst, static_cast<float*>(out), g.n_out,
                               splits);
  return (int)cudaGetLastError();
}
