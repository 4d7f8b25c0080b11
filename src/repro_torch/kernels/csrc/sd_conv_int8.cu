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
// could reach 2^31, so every int32 here is exact.
//
// What bounds it on the H100: at VoxGAN's widths every staged int8 feeds
// tc (16..64) multiply-adds per tap, so it is bound by arithmetic.  This
// first version runs that arithmetic on the CUDA cores with __dp4a (four
// int8 products summed into an int32 per instruction), far below the
// int8 tensor cores' rate; mma/wgmma s8 is later work.  The design is
// K2's (sd_conv.cu) with the staging of K1's int8 branch
// (sd_fused_int8.cu):
//   * one block per (batch, tile of th x tw output positions, tile of tc
//     output channels); the TPU grid's sequential Cin axis is a loop
//     inside the block over chunks of tcin input channels;
//   * per chunk the block stages the zero-masked input band ((th + KTh -
//     1) x (tw + KTw - 1)) and the (KTh, KTw, tcin, tc) filter block in
//     shared memory as int8 packed four consecutive input channels to a
//     32-bit word (a Cin or tcin tail that is not a multiple of 4 is
//     zero-filled, so it adds nothing); channel planes padded to an odd
//     stride;
//   * each thread keeps a 4 positions x 4 channels int32 register tile
//     and runs one __dp4a per (position, channel, word);
//   * the ragged edge (output rows/cols past OH/OW, channels past Co) is
//     masked by the kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMicro = 4;

struct Geom {
  int B, H, W, Cin, Co, KTh, KTw;
  int plo_h, plo_w, os_h, os_w, OH, OW;
  int th, tw, tcin, tcw, nw, bw, plane;
};

template <int TX>
__global__ void __launch_bounds__(kThreads)
sd_conv_int8_kernel(const int8_t* __restrict__ x,
                    const int8_t* __restrict__ w,
                    int32_t* __restrict__ y, Geom g) {
  constexpr int TY = kThreads / TX;   // threads along output positions
  constexpr int TC = TX * kMicro;     // output channels per block
  extern __shared__ __align__(16) int smem[];
  const int ntap = g.KTh * g.KTw;
  int* wf = smem;                             // [tap][tcw][TC] words
  int* band = smem + ntap * g.tcw * TC;       // [tcw][plane] words

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int c0 = blockIdx.x * TC;
  const int tile_i = blockIdx.y / g.nw, tile_j = blockIdx.y % g.nw;
  const int b = blockIdx.z;
  // Band row 0 is padded row os_h + tile_i*th, i.e. input row
  // os_h + tile_i*th - plo_h (rows outside [0, H) read as zero).
  const int xr0 = g.os_h + tile_i * g.th - g.plo_h;
  const int xc0 = g.os_w + tile_j * g.tw - g.plo_w;
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
    pvalid[i] = p < g.th * g.tw;
    prow[i] = pvalid[i] ? p / g.tw : 0;
    pcol[i] = pvalid[i] ? p % g.tw : 0;
    pix[i] = prow[i] * g.bw + pcol[i];
  }

  int acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0;

  const int bh = g.th + g.KTh - 1;
  for (int ci0 = 0; ci0 < g.Cin; ci0 += g.tcin) {
    // Filter block: word (tap, icw, c) packs input channels ci0 + 4*icw
    // + k, k = 0..3, of output channel c0 + c, lane k = bits 8k..8k+7.
    const int nf = ntap * g.tcw * TC;
    for (int idx = tid; idx < nf; idx += kThreads) {
      const int c = idx % TC;
      const int rest = idx / TC;
      const int icw = rest % g.tcw;
      const int tap = rest / g.tcw;
      const int gc = c0 + c;
      uint32_t word = 0;
      if (gc < g.Co) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ic = icw * 4 + k, gi = ci0 + ic;
          if (ic < g.tcin && gi < g.Cin)
            word |= (uint32_t)(uint8_t)
                        w[((long long)tap * g.Cin + gi) * g.Co + gc]
                    << (8 * k);
        }
      }
      wf[idx] = (int)word;
    }
    // Input band: word (icw, row, col), the same packing; rows and cols
    // outside the input are the zero pad.
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

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    if (!pvalid[i]) continue;
    const int oy = tile_i * g.th + prow[i];
    const int ox = tile_j * g.tw + pcol[i];
    if (oy >= g.OH || ox >= g.OW) continue;
    int32_t* yp = y + (((long long)b * g.OH + oy) * g.OW + ox) * g.Co;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int c = c0 + tx * kMicro + j;
      if (c < g.Co) yp[c] = acc[i][j];
    }
  }
}

template <int TX>
cudaError_t launch(const int8_t* x, const int8_t* w, int32_t* y,
                   const Geom& g, int nh, cudaStream_t stream) {
  constexpr int TC = TX * kMicro;
  const size_t smem =
      sizeof(int) * ((size_t)g.KTh * g.KTw * g.tcw * TC +
                     (size_t)g.tcw * g.plane);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sd_conv_int8_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((g.Co + TC - 1) / TC, nh * g.nw, g.B);
  sd_conv_int8_kernel<TX><<<grid, kThreads, smem, stream>>>(x, w, y, g);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, Cin) int8, w (KTh, KTw, Cin, Co) int8, y (B, OH, OW, Co)
// int32, all contiguous.  Returns cudaGetLastError() after the launch (0
// on success).
extern "C" int sd_conv_int8_launch(const void* x, const void* w, void* y,
                                   int B, int H, int W, int Cin, int Co,
                                   int KTh, int KTw, int plo_h, int plo_w,
                                   int os_h, int os_w, int OH, int OW,
                                   int th, int tw, int tcin, int tc,
                                   void* stream) {
  Geom g;
  g.B = B; g.H = H; g.W = W; g.Cin = Cin; g.Co = Co;
  g.KTh = KTh; g.KTw = KTw; g.plo_h = plo_h; g.plo_w = plo_w;
  g.os_h = os_h; g.os_w = os_w; g.OH = OH; g.OW = OW;
  g.th = th; g.tw = tw; g.tcin = tcin;
  g.tcw = (tcin + 3) / 4;
  const int nh = (OH + th - 1) / th;
  g.nw = (OW + tw - 1) / tw;
  g.bw = tw + KTw - 1;
  g.plane = ((th + KTh - 1) * g.bw) | 1;
  if (tc < kMicro || th * tw > kThreads * kMicro / (tc / kMicro) ||
      tcin < 1)
    return (int)cudaErrorInvalidValue;
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  int32_t* yo = static_cast<int32_t*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tc) {
    case 16: return (int)launch<4>(xi, wi, yo, g, nh, s);
    case 32: return (int)launch<8>(xi, wi, yo, g, nh, s);
    case 64: return (int)launch<16>(xi, wi, yo, g, nh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
