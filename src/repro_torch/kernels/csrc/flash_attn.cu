// Flash attention forward for Hopper (sm_90a): K5.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attn.py, body `_fa_body`): softmax attention
// over (B, H, S, D) q/k/v with an online softmax, computed per query
// tile against a sweep of key/value tiles
//
//   s[i, j] = (scale * q[i]) . k[j]          scale = 1 / sqrt(D)
//   o[i]    = sum_j softmax_j(s[i, :])[j] * v[j]
//
// with the causal mask (key j visible to query i when j <= i) taken only
// for Sq == Sk, the TPU kernel's own validity condition.  The running
// max, the running sum and the accumulator are f32; the output is
// written once, in the input's type.  Differences from the TPU kernel's
// contract:
//   * k/v may carry Hkv heads with H % Hkv == 0 (grouped-query
//     attention): q head h reads kv head h / (H / Hkv), so the caller
//     never expands k/v;
//   * any S >= 1: keys past Sk are masked and query rows past Sq are
//     computed but never written, so no host-side padding copy is made;
//   * any element strides over (batch, head, sequence), with the head dim
//     unit-stride: the LM hands (B, S, H, D) activations in as transposed
//     views and gets its output in the same layout.
//
// What bounds it on the H100: at the serving shape (B 4, H 32, S 4080,
// D 160, bf16) a query tile does 2 * 64 * 64 * D multiply-adds per key
// tile it reads, far above the card's bytes-to-operations balance, so
// attention is bound by arithmetic: 989 TFLOP/s on the bf16 tensor
// cores, 67 TFLOP/s on the CUDA cores this first kernel uses.  The
// design is the FlashAttention schedule written for CUDA cores:
//   * one block of 256 threads per (query tile of 64 rows, head, batch);
//     the TPU grid's sequential kv axis is a loop inside the block, and
//     for a causal launch it stops at the tile holding the diagonal:
//     tiles entirely above it are skipped, not masked;
//   * the query tile is staged once in shared memory as f32, already
//     multiplied by the scale; per step a 64-key tile of k and v is
//     staged in f32 (rows of odd stride, so that 16 threads reading 16
//     keys hit 16 banks), zero past Sk;
//   * the threads form a 16 x 16 grid: each owns 4 query rows x 4 keys of
//     the score tile (plain FFMA over D) and the same 4 rows x ceil(D/16)
//     head dims of the accumulator; a row's max and sum are reduced over
//     its 16 threads, which share a half warp, with shuffles; the
//     probabilities go through shared memory to the P.V product;
//   * rows with no visible key yet keep m = -inf and contribute 0 (the
//     TPU kernel's guard), and the output divides by max(l, 1e-30).
// Tensor cores (mma/wgmma) and TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per step
constexpr int kTX = 16;              // threads along keys / head dims
constexpr int kTY = kThreads / kTX;  // threads along query rows
constexpr int kRows = kBQ / kTY;     // query rows per thread
constexpr int kCols = kBK / kTX;     // keys per thread
constexpr int kMaxD = 256;
static_assert(kBQ == kBK, "stage() moves tiles of kBQ rows for q, k and v");

struct Args {
  int H, Hkv, Sq, Sk, D, causal;
  long long qb, qh, qs;   // element strides over (batch, head, sequence)
  long long kb, kh, ks;
  long long vb, vh, vs;
  long long ob, oh, os;
  float scale;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Stage rows [row0, row0 + 64) of one (batch, head) slice into shared
// memory as f32 times `mul`, rows at or past `nrows` as zeros.  Warp w
// takes rows w, w + 8, ...; its lanes walk the head dim (coalesced).
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const T* __restrict__ src,
                                      long long stride, int row0, int nrows,
                                      int D, float mul) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const int row = row0 + r;
    float* d = dst + r * ld;
    if (row < nrows) {
      const T* s = src + row * stride;
      for (int c = lane; c < D; c += 32) d[c] = to_f32(s[c]) * mul;
    } else {
      for (int c = lane; c < D; c += 32) d[c] = 0.f;
    }
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = kTX / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = kTX / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// NJ = head dims per thread (ceil(D / 16), rounded up to an instantiated
// value); dims at or past D are skipped.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, Args a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D;
  const int ldq = D + 1, ldk = D + 1, ldv = D, ldp = kBK + 1;
  float* qs = smem;                 // [kBQ][ldq], scaled queries
  float* ks = qs + kBQ * ldq;       // [kBK][ldk]
  float* vs = ks + kBK * ldk;       // [kBK][ldv]
  float* ps = vs + kBK * ldv;       // [kBQ][ldp], probabilities

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;

  const T* qp = q + b * a.qb + h * a.qh;
  const T* kp = k + b * a.kb + hk * a.kh;
  const T* vp = v + b * a.vb + hk * a.vh;
  stage(qs, ldq, qp, a.qs, q0, a.Sq, D, a.scale);

  float acc[kRows][NJ];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // A causal sweep ends with the tile holding the block's last row.
  const int kend = a.causal ? min(a.Sk, q0 + kBQ) : a.Sk;
  const int ntiles = (kend + kBK - 1) / kBK;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();   // the last step's k/v reads are done
    stage(ks, ldk, kp, a.ks, k0, a.Sk, D, 1.f);
    stage(vs, ldv, vp, a.vs, k0, a.Sk, D, 1.f);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + kTY * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + kTX * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty + kTY * i;
      const int qpos = q0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + kTX * j;
        if (kpos >= a.Sk || (a.causal && kpos > qpos)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - safe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - safe);   // masked: exp(-inf) = 0
        ps[row * ldp + tx + kTX * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    // A row of P is written and read by the same half warp.
    __syncwarp();

    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + kTY * i) * ldp + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + kTX * j;
        if (c < D) {
          const float vv = vs[kk * ldv + c];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  T* op = o + b * a.ob + h * a.oh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty + kTY * i;
    if (qpos >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + kTX * j;
      if (c < D) store(op + qpos * a.os + c, acc[i][j] / denom);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (size_t)(kBQ * (a.D + 1) + kBK * (a.D + 1) + kBK * a.D +
               kBQ * (kBK + 1));
  auto kern = flash_attn_kernel<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     const Args& a, int B, cudaStream_t s) {
  const int nj = (a.D + kTX - 1) / kTX;
  if (nj <= 1) return launch<T, 1>(q, k, v, o, a, B, s);
  if (nj <= 2) return launch<T, 2>(q, k, v, o, a, B, s);
  if (nj <= 4) return launch<T, 4>(q, k, v, o, a, B, s);
  if (nj <= 6) return launch<T, 6>(q, k, v, o, a, B, s);
  if (nj <= 8) return launch<T, 8>(q, k, v, o, a, B, s);
  if (nj <= 10) return launch<T, 10>(q, k, v, o, a, B, s);
  if (nj <= 12) return launch<T, 12>(q, k, v, o, a, B, s);
  return launch<T, 16>(q, k, v, o, a, B, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike); a causal
// launch needs Sq == Sk.  Strides are
// in elements, over (batch, head, sequence); the head dim is unit-stride.
extern "C" int flash_attn_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int Hkv, int Sq, int Sk, int D, int causal, long long qb,
    long long qh, long long qs, long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs, long long ob, long long oh,
    long long os, float scale, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1 ||
      D < 1 || D > kMaxD || H > 65535 || B > 65535 ||
      (causal && Sq != Sk))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.H = H; a.Hkv = Hkv; a.Sq = Sq; a.Sk = Sk; a.D = D; a.causal = causal;
  a.qb = qb; a.qh = qh; a.qs = qs;
  a.kb = kb; a.kh = kh; a.ks = ks;
  a.vb = vb; a.vh = vh; a.vs = vs;
  a.ob = ob; a.oh = oh; a.os = os;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch<float>(q, k, v, o, a, B, s);
    case 1: return (int)dispatch<__nv_bfloat16>(q, k, v, o, a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
