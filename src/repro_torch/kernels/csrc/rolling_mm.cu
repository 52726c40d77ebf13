// Windowed (rolling) matrix products for the fused sub-model round, f32.
//
// rolling_mm_fwd<T>: y_t[b] = x[b] @ W_t[b][:, off[b] : off[b] + win]
//   Replaces the TPU kernels src/repro/kernels/rolling_matmul_batched.py:60
//   rolling_matmul_batched (T = 1, pallas_call at :85) and :164
//   rolling_matmul_batched_multi (T = 2, the gate/up pair, pallas_call at
//   :193).
// rolling_mm_dx<T>:  dx[b] = sum_t dy_t[b] @ W_t[b][:, off[b] : off[b] + win]^T
//   Replaces :110 rolling_matmul_batched_dx (T = 1, pallas_call at :136) and
//   :219 rolling_matmul_batched_dx_multi (T = 2, pallas_call at :248).
//
// What bounds them on an H100 at the full-width TinyLlama-1.1B shapes (C = 4
// clients, M = 512 tokens per client, K = d_model = 2048): all are
// compute-bound in f32.  The gate/up forward does 2*4*2*512*2048*2816 =
// 47.2 GFLOP against 0.25 GB of traffic (x, the two W windows, two y's):
// 0.70 ms at the 67 TFLOP/s f32 peak outside the tensor cores, 0.07 ms at
// 3.35 TB/s.  The q projection (win 1024) is 8.6 GFLOP, 0.13 ms; each dx
// does the same operations as its forward.
//
// Design: a plain shared-memory tiled product.  Each 256-thread block owns a
// 64 x 64 output tile and walks the contraction in 16-deep slabs; every thread
// keeps a 4 x 4 register accumulator (rows ty + 16 i, columns tx + 16 j, so
// shared-memory reads are conflict-free and output stores coalesce).  Every
// product accumulates with fmaf in f32: no TF32, no tensor cores, so the
// result stays within f32 rounding of the plain PyTorch version.  Each block
// reads its client's offset from a device int32[C] vector, so any offset and
// any shape work: ragged edges are masked, there is no alignment rule.  W
// arrives as T separate base pointers with an explicit batch and row stride;
// no weight is stacked or copied.  The TPU's sequential grid axes over the
// weight group and the window (its scratch accumulator) become a loop inside
// the dx block into one register accumulator.  Making these fast (TMA,
// wgmma, TF32 or bf16) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;    // output rows per block
constexpr int BN = 64;    // output columns per block
constexpr int BK = 16;    // contraction depth per shared-memory slab
constexpr int TILE = 16;  // threads per block edge: 16 x 16 = 256 threads
constexpr int R = 4;      // outputs per thread along each edge
constexpr int PAD = 4;    // shared-memory row padding against bank conflicts
constexpr int THREADS = TILE * TILE;

struct WPtrs {
  const float* p[2];
};

// acc[i][j] += sum_kk As[kk][ty + 16 i] * Bs[kk][tx + 16 j]
__device__ __forceinline__ void slab_fma(float (*As)[BM + PAD],
                                         float (*Bs)[BN + PAD],
                                         float (&acc)[R][R], int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[R], b[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = As[kk][ty + TILE * i];
#pragma unroll
    for (int j = 0; j < R; ++j) b[j] = Bs[kk][tx + TILE * j];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Load a BM x BK slab of a row-major [rows, depth] matrix (depth contiguous,
// leading dimension ld) into As[depth][row], zero outside the matrix.
__device__ __forceinline__ void load_rows(float (*As)[BM + PAD],
                                          const float* __restrict__ a,
                                          long long ld, int rows, int depth,
                                          int r0, int d0, int tid) {
#pragma unroll
  for (int l = 0; l < (BM * BK) / THREADS; ++l) {
    const int idx = tid + l * THREADS;
    const int r = idx / BK, d = idx % BK;
    const int gr = r0 + r, gd = d0 + d;
    As[d][r] = (gr < rows && gd < depth) ? a[gr * ld + gd] : 0.0f;
  }
}

template <int T>
__global__ void __launch_bounds__(THREADS)
rolling_mm_fwd_kernel(const float* __restrict__ x, WPtrs w, float* y0,
                      float* y1, const int* __restrict__ off, int M, int K,
                      int N, int win, long long w_bs, long long ldw) {
  __shared__ float As[BK][BM + PAD];
  __shared__ float Bs[BK][BN + PAD];
  const int tid = threadIdx.x, tx = tid % TILE, ty = tid / TILE;
  const int b = blockIdx.z / T, t = blockIdx.z % T;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int o = off[b];
  const float* xb = x + (long long)b * M * K;
  const float* wb = w.p[t] + (long long)b * w_bs;
  float* yb = (t == 0 ? y0 : y1) + (long long)b * M * win;

  float acc[R][R] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_rows(As, xb, K, M, K, m0, k0, tid);
#pragma unroll
    for (int l = 0; l < (BK * BN) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / BN, c = idx % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < win && o + gn < N)
                     ? wb[gk * ldw + o + gn] : 0.0f;
    }
    __syncthreads();
    slab_fma(As, Bs, acc, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int gm = m0 + ty + TILE * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int gn = n0 + tx + TILE * j;
      if (gn < win) yb[(long long)gm * win + gn] = acc[i][j];
    }
  }
}

template <int T>
__global__ void __launch_bounds__(THREADS)
rolling_mm_dx_kernel(const float* dy0, const float* dy1, WPtrs w,
                     float* __restrict__ dx, const int* __restrict__ off,
                     int M, int K, int N, int win, long long w_bs,
                     long long ldw) {
  __shared__ float As[BK][BM + PAD];
  __shared__ float Bs[BK][BN + PAD];
  const int tid = threadIdx.x, tx = tid % TILE, ty = tid / TILE;
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM, k0 = blockIdx.x * BN;
  const int o = off[b];

  float acc[R][R] = {};
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float* dyb = (t == 0 ? dy0 : dy1) + (long long)b * M * win;
    const float* wb = w.p[t] + (long long)b * w_bs;
    for (int n0 = 0; n0 < win; n0 += BK) {
      load_rows(As, dyb, win, M, win, m0, n0, tid);
      // Bs[n][k] = W[k0 + k, o + n0 + n]: 16 consecutive window columns
      // of each of 64 weight rows.
#pragma unroll
      for (int l = 0; l < (BK * BN) / THREADS; ++l) {
        const int idx = tid + l * THREADS;
        const int kc = idx / BK, n = idx % BK;
        const int gk = k0 + kc, gn = n0 + n;
        Bs[n][kc] = (gk < K && gn < win && o + gn < N)
                        ? wb[gk * ldw + o + gn] : 0.0f;
      }
      __syncthreads();
      slab_fma(As, Bs, acc, ty, tx);
      __syncthreads();
    }
  }
  float* dxb = dx + (long long)b * M * K;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int gm = m0 + ty + TILE * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int gk = k0 + tx + TILE * j;
      if (gk < K) dxb[(long long)gm * K + gk] = acc[i][j];
    }
  }
}

}  // namespace

// x [C, M, K] and y_t [C, M, win] contiguous; W_t rows of stride ldw,
// clients of stride w_bs; off int32 [C] on the device.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int rolling_mm_fwd(int T, const float* x, const float* w0,
                              const float* w1, float* y0, float* y1,
                              const int* off, int C, int M, int K, int N,
                              int win, long long w_bs, long long ldw,
                              void* stream) {
  const dim3 grid((win + BN - 1) / BN, (M + BM - 1) / BM, C * T);
  const WPtrs w{{w0, w1}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T == 1)
    rolling_mm_fwd_kernel<1><<<grid, THREADS, 0, s>>>(x, w, y0, y1, off, M,
                                                      K, N, win, w_bs, ldw);
  else if (T == 2)
    rolling_mm_fwd_kernel<2><<<grid, THREADS, 0, s>>>(x, w, y0, y1, off, M,
                                                      K, N, win, w_bs, ldw);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// dy_t [C, M, win] and dx [C, M, K] contiguous; W_t as for rolling_mm_fwd.
extern "C" int rolling_mm_dx(int T, const float* dy0, const float* dy1,
                             const float* w0, const float* w1, float* dx,
                             const int* off, int C, int M, int K, int N,
                             int win, long long w_bs, long long ldw,
                             void* stream) {
  const dim3 grid((K + BN - 1) / BN, (M + BM - 1) / BM, C);
  const WPtrs w{{w0, w1}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T == 1)
    rolling_mm_dx_kernel<1><<<grid, THREADS, 0, s>>>(dy0, dy1, w, dx, off, M,
                                                     K, N, win, w_bs, ldw);
  else if (T == 2)
    rolling_mm_dx_kernel<2><<<grid, THREADS, 0, s>>>(dy0, dy1, w, dx, off, M,
                                                     K, N, win, w_bs, ldw);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
