// Windowed (rolling) matrix products for the sub-model round and one model's
// window, f32 in and out, on Hopper's tensor cores.
//
// rolling_mm_fwd<T>: y_t[c] = x[c] @ W_t[c][:, off[c] : off[c] + win]
//   Replaces the TPU kernels src/repro/kernels/rolling_matmul_batched.py:60
//   rolling_matmul_batched (T = 1) and :164 rolling_matmul_batched_multi
//   (T = 2, the gate/up pair), and, as C = 1 launches, rolling_matmul.py:44
//   rolling_matmul and :95 rolling_matmul_multi.
// rolling_mm_dx<T>:  dx[c] = sum_t dy_t[c] @ W_t[c][:, off[c] : off[c] + win]^T
//   Replaces rolling_matmul_batched.py:110 rolling_matmul_batched_dx (T = 1)
//   and :219 rolling_matmul_batched_dx_multi (T = 2), and, as C = 1
//   launches, rolling_matmul_bwd.py:50 rolling_matmul_dx and :104
//   rolling_matmul_dx_multi.
//
// What bounds them on an H100: operations.  The products keep f32 accuracy
// with the 3xTF32 split of tf32x3.cuh (three TF32 tensor-core passes a
// product, the split and its two numerical rules stated there), so 2*M*N*K
// operations run at 495 / 3 = 165 TFLOP/s at best.  The gate/up forward of
// a window round (C = 4, M = 512, K = 2048, win 2816) is 47.2 GFLOP,
// 0.29 ms at that rate against 0.07 ms for its 0.25 GB at 3.35 TB/s.
//
// Design.  Each block owns a BM x BN output tile and walks the contraction
// in 32-deep stages through a ring of STAGES shared-memory buffers filled by
// cp.async, so the next stages are in flight while the current one is
// multiplied; one __syncthreads per stage.  Each warp multiplies a
// (BM / WM) x (BN / WN) sub-tile with mma.sync m16n8k8 TF32, splitting each
// fragment into big and small as it is read from shared memory (ldmatrix
// where the operand is contraction-contiguous).  mma.sync, not wgmma: TF32
// wgmma takes K-major operands only, and the forward's B (the window of
// W [K, N]) is N-contiguous; fragments read from shared memory take both
// layouts in one design.  The dx kernel's operands (dy rows, and W rows with
// the window along the contraction) are both K-major, which makes dx the
// first candidate for wgmma fed by TMA.
//
// Each output tile's 12 products of a stage are summed on the tensor core
// from zero and added to the register accumulator in f32 (tf32x3.cuh).
//
// Shared memory: A [BM][32 + 4] (contraction contiguous); B [32][BN + 8] in
// the forward (output columns contiguous) and [BN][32 + 4] in dx.  The
// paddings make every fragment read of a warp hit 32 distinct banks, and keep
// rows 16-byte aligned for the copies.  Copies are 16 bytes where the tile's
// rows allow it (the row stride and the window's first column multiples of 4
// floats: x when K % 4 == 0, dy when win % 4 == 0, W when ldw and the client's
// offset are), else 4 bytes; either way the ragged edges are zero-filled by
// the copy's source size, so no stage holds stale or uninitialised values.
// Both paths are of one kernel, chosen per block from the data's alignment.
//
// Block tiles are chosen per launch (rolling_mm_tile): 128 x 128 (8 warps)
// where its grid covers every SM, else 128 x 64 (8 warps), else 64 x 64 (4
// warps), else 64 x 32 (4 warps; the k/v projections' forward, a window of
// 128 columns).  No split of the contraction and no atomics: one block sums each
// output in a fixed order, so a result is the same from run to run.  The
// TPU's sequential grid axes over the weight group and the window become
// the dx block's one contraction loop over T x win.
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

template <int BM_, int BN_, int WM_, int WN_, int STAGES_, int MINB_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;  // output tile of a block
  static constexpr int WM = WM_, WN = WN_;  // warps along M and along N
  static constexpr int BK = 32;             // contraction depth of a stage
  static constexpr int STAGES = STAGES_;
  static constexpr int MINB = MINB_;        // blocks an SM holds
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MT = BM / WM / 16;   // m16 tiles of a warp
  static constexpr int NT = BN / WN / 8;    // n8 tiles of a warp
  static constexpr int SA = BK + 4;         // row stride of A and of dx's B
  static constexpr int SB_KN = BN + 8;      // row stride of the forward's B
  static constexpr int A_FLOATS = BM * SA;
  static constexpr int B_FLOATS_KN = BK * SB_KN;
  static constexpr int B_FLOATS_NK = BN * SA;
  static constexpr int smem_bytes(bool nk) {
    return STAGES * 4 * (A_FLOATS + (nk ? B_FLOATS_NK : B_FLOATS_KN));
  }
};

// A warp's fragments of a whole stage stay in registers (the 12 products of
// each output tile are summed before one f32 add): 128 x 128 and 128 x 64
// need more than the 128 registers that two 256-thread blocks an SM allow.
using Large = Tile<128, 128, 2, 4, 4, 1>;
using Medium = Tile<128, 64, 4, 2, 4, 1>;
using Small = Tile<64, 64, 2, 2, 4, 3>;
using Narrow = Tile<64, 32, 2, 2, 4, 3>;

struct WPtrs {
  const float* p[2];
};

// The A fragment of rows r0 .. r0 + 15 and contraction kk .. kk + 7.
template <class TL>
__device__ __forceinline__ void load_a(const float* As, int r0, int kk,
                                       int lane, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  uint32_t v[4];
  ldmatrix_x4(v, As + (r0 + (lane & 15)) * TL::SA + kk + (lane >> 4) * 4);
  split4(v, big, small);
}

// The B fragments of the warp's NT n8 tiles from column n0, contraction
// kk .. kk + 7.  NK: B stored [BN][SA] (contraction contiguous, dx), else
// [BK][SB_KN] (the forward).
template <class TL, bool NK>
__device__ __forceinline__ void load_b(const float* Bs, int n0, int kk,
                                       int lane, uint32_t (&big)[TL::NT][2],
                                       uint32_t (&small)[TL::NT][2]) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < TL::NT; j += 2) {
    uint32_t v[4];
    if (NK) {
      ldmatrix_x4(v, Bs + (n0 + j * 8 + (lane & 7) + (lane >> 4) * 8) * TL::SA +
                         kk + ((lane >> 3) & 1) * 4);
    } else {
      const float* b = Bs + (kk + q) * TL::SB_KN + n0 + j * 8 + g;
      v[0] = __float_as_uint(b[0]);
      v[1] = __float_as_uint(b[4 * TL::SB_KN]);
      v[2] = __float_as_uint(b[8]);
      v[3] = __float_as_uint(b[4 * TL::SB_KN + 8]);
    }
    uint32_t vb[4], vs[4];
    split4(v, vb, vs);
    big[j][0] = vb[0], big[j][1] = vb[1], big[j + 1][0] = vb[2],
    big[j + 1][1] = vb[3];
    small[j][0] = vs[0], small[j][1] = vs[1], small[j + 1][0] = vs[2],
    small[j + 1][1] = vs[3];
  }
}

// acc += A B over `stages` contraction stages; load(As, Bs, s) issues the
// copies of stage s.  Each output tile's 3 x KS TF32 products of a stage are
// summed on the tensor core from zero, then added to acc in f32, rounded to
// nearest: the tensor core's own accumulation truncates, which on the
// running sum would bias it toward zero over a long contraction.
template <class TL, bool NK, class Load>
__device__ __forceinline__ void mainloop(float* smem, int stages, Load load,
                                         float (&acc)[TL::MT][TL::NT][4]) {
  constexpr int KS = TL::BK / 8;  // k8 steps of a stage
  constexpr int STAGE =
      TL::A_FLOATS + (NK ? TL::B_FLOATS_NK : TL::B_FLOATS_KN);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / TL::WN) * (TL::BM / TL::WM);
  const int wn0 = (warp % TL::WN) * (TL::BN / TL::WN);

#pragma unroll
  for (int s = 0; s < TL::STAGES - 1; ++s) {
    if (s < stages) load(smem + s * STAGE, smem + s * STAGE + TL::A_FLOATS, s);
    cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<TL::STAGES - 2>();
    __syncthreads();  // stage s landed for all; stage s - 1 is read by all
    const int next = s + TL::STAGES - 1;
    if (next < stages) {
      float* st = smem + (next % TL::STAGES) * STAGE;
      load(st, st + TL::A_FLOATS, next);
    }
    cp_async_commit();
    const float* As = smem + (s % TL::STAGES) * STAGE;
    const float* Bs = As + TL::A_FLOATS;
    uint32_t bb[KS][TL::NT][2], bs[KS][TL::NT][2];
#pragma unroll
    for (int h = 0; h < KS; ++h)
      load_b<TL, NK>(Bs, wn0, 8 * h, lane, bb[h], bs[h]);
#pragma unroll
    for (int i = 0; i < TL::MT; ++i) {
      uint32_t ab[KS][4], as[KS][4];
#pragma unroll
      for (int h = 0; h < KS; ++h)
        load_a<TL>(As, wm0 + 16 * i, 8 * h, lane, ab[h], as[h]);
#pragma unroll
      for (int j = 0; j < TL::NT; ++j) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int h = 0; h < KS; ++h) {
          mma_tf32(t, as[h], bb[h][j]);
          mma_tf32(t, ab[h], bs[h][j]);
          mma_tf32(t, ab[h], bb[h][j]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
      }
    }
  }
  cp_async_wait<0>();
}

// Store a block's accumulators to out (the tile's first element, row stride
// ld), rows < nr and columns < nc only; a thread's two neighbouring columns
// as one 8-byte store where out and ld allow it.
template <class TL>
__device__ __forceinline__ void store_tile(
    const float (&acc)[TL::MT][TL::NT][4], float* out, long long ld, int nr,
    int nc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm0 = (warp / TL::WN) * (TL::BM / TL::WM);
  const int wn0 = (warp % TL::WN) * (TL::BN / TL::WN);
  const bool pairs = ld % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
#pragma unroll
  for (int i = 0; i < TL::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm0 + i * 16 + g + 8 * h;
      if (r >= nr) continue;
#pragma unroll
      for (int j = 0; j < TL::NT; ++j) {
        const int c = wn0 + j * 8 + 2 * q;
        float* o = out + r * ld + c;
        if (pairs && c + 1 < nc) {
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          if (c < nc) o[0] = acc[i][j][2 * h];
          if (c + 1 < nc) o[1] = acc[i][j][2 * h + 1];
        }
      }
    }
  }
}

template <class TL, int T>
__global__ void __launch_bounds__(TL::THREADS, TL::MINB)
rolling_mm_fwd_kernel(const float* __restrict__ x, WPtrs w, float* y0,
                      float* y1, const int* __restrict__ off, int M, int K,
                      int win, long long w_bs, long long ldw, bool x_vec,
                      bool w_vec) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.z / T, t = blockIdx.z % T;
  const int m0 = blockIdx.y * TL::BM, n0 = blockIdx.x * TL::BN;
  const int o = off[c];
  const bool wv = w_vec && o % 4 == 0;
  const float* xt = x + ((long long)c * M + m0) * K;
  const float* wt = (t == 0 ? w.p[0] : w.p[1]) + c * w_bs + o + n0;
  auto load = [&](float* As, float* Bs, int s) {
    const int k0 = s * TL::BK;
    load_tile<TL::BM, TL::BK, TL::SA, TL::THREADS>(As, xt + k0, K, M - m0,
                                                   K - k0, x_vec);
    load_tile<TL::BK, TL::BN, TL::SB_KN, TL::THREADS>(
        Bs, wt + k0 * ldw, ldw, K - k0, win - n0, wv);
  };
  float acc[TL::MT][TL::NT][4] = {};
  mainloop<TL, false>(smem, (K + TL::BK - 1) / TL::BK, load, acc);
  float* y = (t == 0 ? y0 : y1) + ((long long)c * M + m0) * win + n0;
  store_tile<TL>(acc, y, win, M - m0, win - n0);
}

template <class TL, int T>
__global__ void __launch_bounds__(TL::THREADS, TL::MINB)
rolling_mm_dx_kernel(const float* dy0, const float* dy1, WPtrs w,
                     float* __restrict__ dx, const int* __restrict__ off,
                     int M, int K, int win, long long w_bs, long long ldw,
                     bool dy_vec, bool w_vec) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.z;
  const int m0 = blockIdx.y * TL::BM, k0 = blockIdx.x * TL::BN;
  const int o = off[c];
  const bool wv = w_vec && o % 4 == 0;
  const int per_t = (win + TL::BK - 1) / TL::BK;  // stages of one weight
  auto load = [&](float* As, float* Bs, int s) {
    const int t = T == 1 ? 0 : s / per_t;
    const int n0 = (s - t * per_t) * TL::BK;
    const float* dyt = (t == 0 ? dy0 : dy1) + ((long long)c * M + m0) * win;
    const float* wt = (t == 0 ? w.p[0] : w.p[1]) + c * w_bs + k0 * ldw + o;
    load_tile<TL::BM, TL::BK, TL::SA, TL::THREADS>(As, dyt + n0, win, M - m0,
                                                   win - n0, dy_vec);
    load_tile<TL::BN, TL::BK, TL::SA, TL::THREADS>(Bs, wt + n0, ldw, K - k0,
                                                   win - n0, wv);
  };
  float acc[TL::MT][TL::NT][4] = {};
  mainloop<TL, true>(smem, T * per_t, load, acc);
  store_tile<TL>(acc, dx + ((long long)c * M + m0) * K + k0, K, M - m0,
                 K - k0);
}

// The tile of a launch whose output has `cols` columns, M rows per client
// and Z client-weight pairs: the largest whose grid covers every SM, else
// the narrowest.
int pick_tile(int cols, int M, int Z) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const auto blocks = [&](int bm, int bn) {
    return (long long)((cols + bn - 1) / bn) * ((M + bm - 1) / bm) * Z;
  };
  if (blocks(Large::BM, Large::BN) >= sms) return 0;
  if (blocks(Medium::BM, Medium::BN) >= sms) return 1;
  if (blocks(Small::BM, Small::BN) >= sms) return 2;
  return 3;
}

template <class TL, int T>
cudaError_t launch_fwd(const float* x, WPtrs w, float* y0, float* y1,
                       const int* off, int C, int M, int K, int win,
                       long long w_bs, long long ldw, bool x_vec, bool w_vec,
                       cudaStream_t s) {
  const auto kern = rolling_mm_fwd_kernel<TL, T>;
  const int bytes = TL::smem_bytes(false);
  // above 48 KB a block's dynamic shared memory needs this opt-in
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((win + TL::BN - 1) / TL::BN, (M + TL::BM - 1) / TL::BM,
                  C * T);
  kern<<<grid, TL::THREADS, bytes, s>>>(x, w, y0, y1, off, M, K, win, w_bs,
                                        ldw, x_vec, w_vec);
  return cudaGetLastError();
}

template <class TL, int T>
cudaError_t launch_dx(const float* dy0, const float* dy1, WPtrs w, float* dx,
                      const int* off, int C, int M, int K, int win,
                      long long w_bs, long long ldw, bool dy_vec, bool w_vec,
                      cudaStream_t s) {
  const auto kern = rolling_mm_dx_kernel<TL, T>;
  const int bytes = TL::smem_bytes(true);
  // above 48 KB a block's dynamic shared memory needs this opt-in
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((K + TL::BN - 1) / TL::BN, (M + TL::BM - 1) / TL::BM, C);
  kern<<<grid, TL::THREADS, bytes, s>>>(dy0, dy1, w, dx, off, M, K, win, w_bs,
                                        ldw, dy_vec, w_vec);
  return cudaGetLastError();
}

template <int T, class... A>
cudaError_t fwd_tiled(int tile, A... a) {
  if (tile == 0) return launch_fwd<Large, T>(a...);
  if (tile == 1) return launch_fwd<Medium, T>(a...);
  if (tile == 2) return launch_fwd<Small, T>(a...);
  return launch_fwd<Narrow, T>(a...);
}

template <int T, class... A>
cudaError_t dx_tiled(int tile, A... a) {
  if (tile == 0) return launch_dx<Large, T>(a...);
  if (tile == 1) return launch_dx<Medium, T>(a...);
  if (tile == 2) return launch_dx<Small, T>(a...);
  return launch_dx<Narrow, T>(a...);
}

}  // namespace

// x [C, M, K] and y_t [C, M, win] contiguous; W_t rows of stride ldw,
// clients of stride w_bs; off int32 [C] on the device (off[c] + win <= N).
// Returns the CUDA error of the launch (0 on success).
extern "C" int rolling_mm_fwd(int T, const float* x, const float* w0,
                              const float* w1, float* y0, float* y1,
                              const int* off, int C, int M, int K, int N,
                              int win, long long w_bs, long long ldw,
                              void* stream) {
  (void)N;
  if (T != 1 && T != 2) return static_cast<int>(cudaErrorInvalidValue);
  const WPtrs w{{w0, w1}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool x_vec = K % 4 == 0 && aligned16(x);
  const bool w_vec = ldw % 4 == 0 && w_bs % 4 == 0 && aligned16(w0) &&
                     (T == 1 || aligned16(w1));
  const int tile = pick_tile(win, M, C * T);
  return static_cast<int>(
      T == 1 ? fwd_tiled<1>(tile, x, w, y0, y1, off, C, M, K, win, w_bs, ldw,
                            x_vec, w_vec, s)
             : fwd_tiled<2>(tile, x, w, y0, y1, off, C, M, K, win, w_bs, ldw,
                            x_vec, w_vec, s));
}

// dy_t [C, M, win] and dx [C, M, K] contiguous; W_t as for rolling_mm_fwd.
extern "C" int rolling_mm_dx(int T, const float* dy0, const float* dy1,
                             const float* w0, const float* w1, float* dx,
                             const int* off, int C, int M, int K, int N,
                             int win, long long w_bs, long long ldw,
                             void* stream) {
  (void)N;
  if (T != 1 && T != 2) return static_cast<int>(cudaErrorInvalidValue);
  const WPtrs w{{w0, w1}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dy_vec = win % 4 == 0 && aligned16(dy0) &&
                      (T == 1 || aligned16(dy1));
  const bool w_vec = ldw % 4 == 0 && w_bs % 4 == 0 && aligned16(w0) &&
                     (T == 1 || aligned16(w1));
  const int tile = pick_tile(K, M, C);
  return static_cast<int>(
      T == 1 ? dx_tiled<1>(tile, dy0, dy1, w, dx, off, C, M, K, win, w_bs,
                           ldw, dy_vec, w_vec, s)
             : dx_tiled<2>(tile, dy0, dy1, w, dx, off, C, M, K, win, w_bs,
                           ldw, dy_vec, w_vec, s));
}

// The block tile (rows << 16 | columns) that rolling_mm_fwd (dx = 0) or
// rolling_mm_dx (dx = 1) takes for these sizes on the current device.
extern "C" int rolling_mm_tile(int dx, int T, int C, int M, int K, int win) {
  static const int tiles[4] = {Large::BM << 16 | Large::BN,
                               Medium::BM << 16 | Medium::BN,
                               Small::BM << 16 | Small::BN,
                               Narrow::BM << 16 | Narrow::BN};
  return tiles[dx ? pick_tile(K, M, C) : pick_tile(win, M, C * T)];
}
