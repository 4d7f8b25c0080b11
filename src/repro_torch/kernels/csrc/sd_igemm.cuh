// Implicit-GEMM mainloop for the port's float stride-1 convolutions on
// Hopper (sm_90a): 3xTF32 on the tensor cores, shared by K2 (sd_conv.cu,
// f32) and the float branch of K1 (sd_fused.cu, f32 and bf16).  Each
// .cu adds its own epilogue functor and C entry point.
//
// The GEMM.  A stride-1 conv over a zero-padded NHWC input x (B, H, W,
// Cin) with (KTh, KTw, Cin, N) filters is
//
//   C[m, n] = sum_k A[m, k] * Wt[k, n],   M = B*MH*MW, K = KTh*KTw*Cin,
//   A[m, k] = x[b, v + r0 + kh, u + c0 + kw, ci]   (0 outside x),
//   m = (b*MH + v)*MW + u,  k = (kh*KTw + kw)*Cin + ci,
//
// so the filters, read as a K x N row-major matrix, are the B operand as
// they lie in memory, and A is gathered from x in place: the halo (the
// pad, an output window's offset, K1's q/plo shifts, all folded into
// r0/c0) is zero-filled by cp.async with a source size of 0, never a
// padded copy in device memory.
//
// What bounds it on the H100: at DCGAN's widths the convs do 0.1-6
// GFLOP on 1-8 MB of operands, so they are bound by arithmetic.  In
// f32 the CUDA cores' 67 TFLOP/s cap them; one TF32 rounding (tensor
// cores, 495 TFLOP/s dense) breaks the f32 gates (1e-4, and 1e-5 in the
// 3-D lowering).  So each f32 operand is split into two TF32 values,
// hi = tf32(a) and lo = tf32(a - hi), and the block takes
// lo*hi + hi*lo + hi*hi on the tensor cores into f32 accumulators
// (3xTF32): three times the work at 7.4 times the rate, and f32's
// accuracy up to the dropped lo*lo (2^-22 relative).  A bf16 value is
// exact in TF32 (8 mantissa bits <= 10), so lo = 0 and the bf16 branch
// takes the hi*hi pass alone; the pass count is a compile-time constant
// of the element type.
//
// The design:
//   * a block of 4 warps computes a 64 x BN tile of C (BN 16, 32 or 64,
//     so DCGAN d3's 12 phase channels take a narrow tile), each warp a
//     sub-tile of m16n8k8 mma.sync instructions with f32 accumulators in
//     registers;
//   * a ring of 3 stages in shared memory is filled with cp.async
//     (commit_group / wait_group), so the loads of the next k-tiles are
//     in flight while the block computes on this one: 16-byte copies
//     where Cin (for A) or N (for B) is a multiple of 16 bytes' worth of
//     elements and the base is 16-byte aligned, 4-byte copies otherwise
//     (Cin 3, 5, 7, 70), and plain loads for a lone bf16 element (bf16
//     rows not a multiple of 8, such as d3's 12 phase channels);
//   * shared rows are padded (A: BK + 4 f32 or BK + 8 bf16 elements,
//     B: BN + 8) so that every fragment load of a warp hits 32 distinct
//     banks or shares a word;
//   * fragments are read as f32 (A through ldmatrix) and split in
//     registers with cvt.rna.tf32.f32's rounding; the small products
//     are issued before hi*hi, pass by pass, so that consecutive mma
//     never wait on one accumulator;
//   * the tensor cores add into their f32 accumulator with truncation,
//     an error that grows with the length of the chain (DCGAN d1's dx
//     chains 1,728 mma over K = 4,608) and outgrew cuDNN's f32 error
//     enough to fail the G-step's 1e-4 gradient gate.  So each k-tile's
//     12 mma start from zero, and their sum is added to an f32 register
//     sum on the CUDA cores, rounded to nearest (chip_smoke's
//     "precision:" lines hold K1, K2 and cuDNN's f32 against an f64
//     product);
//   * where the 64 x BN output tiles cannot fill the 132 SMs, the K loop
//     is split over blockIdx.z (split-K).  Each split writes an f32
//     partial slab into a workspace the wrapper allocates, and a second
//     small kernel sums the slabs in fixed split order and then runs the
//     epilogue, so the result is deterministic run to run.  With one
//     split the epilogue runs in the GEMM kernel and there is no
//     workspace.
//
// Why mma.sync and not wgmma: at these sizes (about 2.4 GFLOP of kernel
// work on DCGAN d1) filling the card and keeping latency low matter more
// than the last factor of tensor-core rate, and mma.sync takes its A and
// B fragments from registers, where the hi/lo split is made.  wgmma with
// TF32 needs both operands K-major in shared memory, so the split would
// have to be written back to shared memory (and B transposed there);
// that is a later option.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace igemm {

constexpr int kBM = 64;       // GEMM rows (conv positions) per block
constexpr int kBK = 32;       // K per stage
constexpr int kThreads = 128; // 4 warps
constexpr int kStages = 3;    // cp.async ring depth

struct Geom {
  int B, H, W, Cin, KTh, KTw;
  int MH, MW;          // conv positions per sample, rows x cols
  int r0, c0;          // input row / col of position (0, 0) at tap (0, 0)
  int N;               // GEMM columns (output or phase channels)
  int M, K;            // B*MH*MW, KTh*KTw*Cin
  int vec_a, vec_b;    // 16-byte copies for A rows / B rows
  int kt_per_split;
};

// Stores the f32 partial of split z at ws[z][m][n].
struct PartialEpi {
  float* ws;
  long long mn;
  int n;
  __device__ __forceinline__ void store(int m, int c, float v, int z) const {
    ws[z * mn + (long long)m * n + c] = v;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// One element; the halo (ok false) is written as zero.
__device__ __forceinline__ void copy_elem(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void copy_elem(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, bool ok) {
  // cp.async copies 4, 8 or 16 bytes: a lone bf16 is a plain load, stored
  // before the barrier that precedes its use.
  *reinterpret_cast<unsigned short*>(dst) =
      ok ? *reinterpret_cast<const unsigned short*>(src) : (unsigned short)0;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// TF32 of f, rounded as cvt.rna.tf32.f32 rounds (to nearest, ties away
// from zero, 10 mantissa bits kept): add half of the 13 dropped bits'
// unit to the magnitude, then clear them.  Two integer instructions,
// where ptxas expands cvt.rna into four (with a NaN test the finite
// operands here never need); identical for every finite f.
__device__ __forceinline__ uint32_t tf32(float f) {
  return (__float_as_uint(f) + 0x1000u) & 0xFFFFE000u;
}

// Products per multiply-add: 3 for f32 (3xTF32), 1 for bf16.
template <typename T>
__host__ __device__ constexpr int passes() { return sizeof(T) == 4 ? 3 : 1; }

// hi = tf32(v), lo = tf32(v - hi) (v - hi is exact in f32).  A bf16
// operand widened to f32 is already a TF32 value: one pass, no split.
template <typename T>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  if (passes<T>() == 1) {
    hi = __float_as_uint(v);
    return;
  }
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The four A values of an m16n8k8 tf32 fragment from an f32 tile in
// shared memory (rows 0-15 of the warp's m-tile at k offset 0), in one
// instruction: ldmatrix's four 8x8 b16 matrices read as rows 0-7 / 8-15
// x k 0-3 / 4-7 of 4-byte elements; lane l names row l % 16 of matrix
// l / 8 and receives row l / 4, word l % 4 of each: a0, a1, a2, a3.
template <int AS>
__device__ __forceinline__ void ldmatrix_a(float (&v)[4], const float* tile,
                                           int lane) {
  const float* p = tile + ((lane & 7) + (lane & 8)) * AS + (lane >> 4) * 4;
  uint32_t r[4];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = __uint_as_float(r[e]);
}

// Shared row strides in elements (see the bank notes at the top).
template <typename T>
__host__ __device__ constexpr int a_stride() {
  return kBK + (sizeof(T) == 4 ? 4 : 8);
}
template <int BN>
__host__ __device__ constexpr int b_stride() { return BN + 8; }

template <typename T, int BN>
constexpr size_t smem_bytes() {
  return 3 * kBM * sizeof(int) +
         (size_t)kStages * (kBM * a_stride<T>() + kBK * b_stride<BN>()) *
             sizeof(T);
}

template <typename T, int BN, class Epi>
__global__ void __launch_bounds__(kThreads)
igemm_kernel(const T* __restrict__ x, const T* __restrict__ w, Geom g,
             Epi epi) {
  constexpr int WARPS_M = BN == 16 ? 4 : 2;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WM = kBM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int AS = a_stride<T>(), BS = b_stride<BN>();
  constexpr int A_STAGE = kBM * AS, B_STAGE = kBK * BS;
  constexpr int V = 16 / sizeof(T);        // elements per 16-byte copy
  constexpr int PASSES = passes<T>();

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Per row of the tile: b*H, input row and col of tap (0, 0); a row past
  // M gets a row that no tap brings inside x.
  int* rows = reinterpret_cast<int*>(smem_raw);
  T* As = reinterpret_cast<T*>(smem_raw + 3 * kBM * sizeof(int));
  T* Bs = As + kStages * A_STAGE;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int nk = (g.K + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * g.kt_per_split;
  const int ntiles = max(0, min(nk, kt0 + g.kt_per_split) - kt0);

  for (int r = tid; r < kBM; r += kThreads) {
    const int m = m0 + r;
    int bh = 0, ir = -(1 << 29), ic = 0;
    if (m < g.M) {
      const int per = g.MH * g.MW;
      const int b = m / per, rem = m - b * per;
      const int v = rem / g.MW;
      bh = b * g.H;
      ir = v + g.r0;
      ic = rem - v * g.MW + g.c0;
    }
    rows[r] = bh;
    rows[kBM + r] = ir;
    rows[2 * kBM + r] = ic;
  }
  __syncthreads();

  // A tile: kBM rows x kBK of k.  A thread keeps one column (group) and
  // walks rows; its column's k = (kh*KTw + kw)*Cin + ci is decomposed
  // once and stepped by kBK per tile (tiles load in order).
  const int a_width = g.vec_a ? V : 1;
  const int a_per_row = kBK / a_width;
  const int a_col = (tid % a_per_row) * a_width;
  int ak = kt0 * kBK + a_col;
  int aci = ak % g.Cin, akw = (ak / g.Cin) % g.KTw, akh = ak / g.Cin / g.KTw;
  auto load_a = [&](int stage) {
    T* dst = As + stage * A_STAGE;
    const bool kok = ak < g.K;
    for (int r = tid / a_per_row; r < kBM; r += kThreads / a_per_row) {
      const int xr = rows[kBM + r] + akh, xc = rows[2 * kBM + r] + akw;
      const bool ok = kok && xr >= 0 && xr < g.H && xc >= 0 && xc < g.W;
      const T* src =
          ok ? x + (((long long)(rows[r] + xr) * g.W + xc) * g.Cin + aci) : x;
      if (g.vec_a)
        cp_async16(dst + r * AS + a_col, src, ok);
      else
        copy_elem(dst + r * AS + a_col, src, ok);
    }
    ak += kBK;
    for (aci += kBK; aci >= g.Cin; aci -= g.Cin)
      if (++akw == g.KTw) {
        akw = 0;
        ++akh;
      }
  };
  // B tile: kBK rows of k x BN columns of the K x N filter matrix.
  auto load_b = [&](int stage, int kt) {
    T* dst = Bs + stage * B_STAGE;
    const int width = g.vec_b ? V : 1;
    const int per_row = BN / width;
    for (int i = tid; i < kBK * per_row; i += kThreads) {
      const int r = i / per_row, col = (i - r * per_row) * width;
      const int k = kt * kBK + r, n = n0 + col;
      const bool ok = k < g.K && n < g.N;
      const T* src = ok ? w + (long long)k * g.N + n : w;
      if (g.vec_b)
        cp_async16(dst + r * BS + col, src, ok);
      else
        copy_elem(dst + r * BS + col, src, ok);
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int gid = lane / 4, tig = lane % 4;

  // acc: the mma accumulator of the current k-tile; sum: the k-tiles'
  // sums, added in f32 on the CUDA cores.
  float acc[MT][NT][4], sum[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = sum[i][j][e] = 0.f;

  constexpr int S = kStages;
  for (int s = 0; s < S - 1; ++s) {
    if (s < ntiles) {
      load_a(s);
      load_b(s, kt0 + s);
    }
    cp_async_commit();
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<S - 2>(); // tile t has landed (this thread's copies)
    __syncthreads();        // everyone's copies; stage (t-1)%S is free
    const int next = t + S - 1;
    if (next < ntiles) {
      load_a(next % S);
      load_b(next % S, kt0 + next);
    }
    cp_async_commit();

    const T* a_s = As + (t % S) * A_STAGE + wm * WM * AS;
    const T* b_s = Bs + (t % S) * B_STAGE + tig * BS + wn * WN + gid;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float v[4];
        const T* tile = a_s + i * 16 * AS + kk;
        if constexpr (sizeof(T) == 4) {
          ldmatrix_a<AS>(v, tile, lane);
        } else {
          const T* p = tile + gid * AS + tig;
          v[0] = to_f32(p[0]);
          v[1] = to_f32(p[8 * AS]);
          v[2] = to_f32(p[4]);
          v[3] = to_f32(p[8 * AS + 4]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split<T>(v[e], ah[i][e], al[i][e]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* p = b_s + kk * BS + j * 8;
        split<T>(to_f32(p[0]), bh[j][0], bl[j][0]);
        split<T>(to_f32(p[4 * BS]), bh[j][1], bl[j][1]);
      }
      // Pass by pass, so that consecutive mma never share an accumulator.
      if (PASSES == 3) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
    }
    // Promote the tile's sum out of the tensor cores' accumulator.
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sum[i][j][e] += acc[i][j][e];
          acc[i][j][e] = 0.f;
        }
  }
  cp_async_wait<0>();

  // c0, c1 at (gid, 2*tig + {0, 1}); c2, c3 eight rows down.
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * WM + i * 16 + gid + (e >= 2 ? 8 : 0);
        const int n = n0 + wn * WN + j * 8 + tig * 2 + (e & 1);
        if (m < g.M && n < g.N) epi.store(m, n, sum[i][j][e], blockIdx.z);
      }
}

// Sums the split partials of each (m, n) in split order, then the
// epilogue: the same value on every run.
template <class Epi>
__global__ void __launch_bounds__(256)
igemm_reduce_kernel(const float* __restrict__ ws, int splits, int M, int N,
                    Epi epi) {
  const long long mn = (long long)M * N;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < mn;
       i += (long long)gridDim.x * 256) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s += ws[z * mn + i];
    const int m = (int)(i / N);
    epi.store(m, (int)(i - (long long)m * N), s, 0);
  }
}

template <typename T, int BN, class Epi>
cudaError_t launch_gemm(const T* x, const T* w, const Geom& g, int splits,
                        Epi epi, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, BN>();
  if constexpr (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        igemm_kernel<T, BN, Epi>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((g.M + kBM - 1) / kBM, (g.N + BN - 1) / BN, splits);
  igemm_kernel<T, BN, Epi><<<grid, kThreads, smem, stream>>>(
      x, w, g, epi);
  return cudaGetLastError();
}

template <typename T, int BN, class Epi>
cudaError_t run_bn(const T* x, const T* w, const Geom& g, int splits,
                   float* work, Epi epi, cudaStream_t stream) {
  if (splits == 1)
    return launch_gemm<T, BN>(x, w, g, 1, epi, stream);
  const long long mn = (long long)g.M * g.N;
  const cudaError_t err = launch_gemm<T, BN>(
      x, w, g, splits, PartialEpi{work, mn, g.N}, stream);
  if (err != cudaSuccess) return err;
  const long long blocks = (mn + 255) / 256;
  igemm_reduce_kernel<Epi><<<(int)(blocks < 1056 ? blocks : 1056), 256, 0,
                             stream>>>(work, splits, g.M, g.N, epi);
  return cudaGetLastError();
}

// Checks the plan (bn, splits), fills the derived fields of g
// and launches: one GEMM kernel with the epilogue, or with splits > 1
// the GEMM into `work` (splits x M x N f32) and the reduce kernel.
template <typename T, class Epi>
cudaError_t run(const T* x, const T* w, Geom g, int bn, int splits,
                float* work, Epi epi, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  g.M = g.B * g.MH * g.MW;
  g.K = g.KTh * g.KTw * g.Cin;
  const int nk = (g.K + kBK - 1) / kBK;
  if (splits < 1 || splits > 65535 ||
      (splits > 1 && work == nullptr) || g.M <= 0 || g.N <= 0 || g.Cin < 1)
    return cudaErrorInvalidValue;
  g.kt_per_split = (nk + splits - 1) / splits;
  g.vec_a = g.Cin % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.vec_b = g.N % V == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  switch (bn) {
    case 16: return run_bn<T, 16>(x, w, g, splits, work, epi, stream);
    case 32: return run_bn<T, 32>(x, w, g, splits, work, epi, stream);
    case 64: return run_bn<T, 64>(x, w, g, splits, work, epi, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace igemm
