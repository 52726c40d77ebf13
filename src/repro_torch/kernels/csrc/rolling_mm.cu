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
//
// The bf16 arm (rolling_mm_fwd_bf16, rolling_mm_dx_bf16), the Pallas
// kernels on bf16 operands (f32 accumulation, the output in x's dtype), has
// two bodies, chosen per launch from the data's alignment and counted apart
// (the entry point reports which ran):
//
// - The wgmma body (rolling_mm_{fwd,dx}_wgmma_kernel), where TMA takes the
//   operands: 16-byte aligned bases, row strides (x: K; dy: win; W: ldw)
//   and W's client stride whole 16-byte vectors, and every client's offset
//   a multiple of 8 elements (a TMA box must start on a 16-byte vector: a
//   box of W at an offset of 5, 12 or 37 elements stopped the kernel with
//   an illegal instruction on an H100).  What bounds it: operations,
//   2*M*N*K at the dense bf16 rate (989 TFLOP/s), which mma.sync cannot
//   reach (the copy body below ran rows 1-2 at 177-183 TFLOP/s); and, at
//   128 x 128 tiles, the L2's bandwidth into the SMs (a 64-deep stage is
//   32 KB for 2 MFLOP).  Design (wgmma.cuh): one producer warp keeps a ring
//   of STAGES 64-deep stages in flight by TMA, with mbarriers between it and
//   one or two consumer warpgroups, each owning 64 rows x BN columns in
//   registers; A (x, dy) and dx's B (W's rows, the window along the
//   contraction) are K-major, the forward's B (the window of W [K, N], N
//   contiguous) MN-major through wgmma's transpose bit, all in the 128-byte
//   swizzle TMA writes.  TMA zero-fills past a tensor's bounds (x's and
//   dy's columns, W's rows, through a 3-d map [C, K, N]), but not past the
//   window's last column inside W: dx's ragged last stage of each weight
//   zeroes those columns in shared memory before its wgmma (0 x inf is NaN).
//   Each stage's four k16 products are summed on the tensor core from zero
//   and added to the accumulators in f32: summing the whole contraction on
//   the tensor core ran rows 2-8 3-16% faster but missed one bf16 ulp +
//   1e-6 at the 5632-long contraction of rows 4 and 8's dx (the tensor
//   core's truncating adds; PERF.md §6).  Tiles (pick_wtile): 128 x 128 (two
//   warpgroups) where the grid covers every SM, else 64 x 128, 64 x 64, and
//   in dx 64 x 32 (the forward's MN-major B comes in 64-column chunks).
// - The mma.sync body (the kernels above, templated on the element type):
//   the f32 arm's tiles, tile picker, stage ring and copy rules, with a
//   bf16 mainloop.  Each operand is exact in one mma.sync m16n8k16 bf16
//   pass (bf16_mma.cuh); fragments come from shared memory by ldmatrix (the
//   forward's B by ldmatrix.trans), rows padded by 8 elements so that every
//   ldmatrix phase hits 32 distinct banks.  Copies are 16 bytes where rows
//   and the window's first column are multiples of 8 elements, else
//   element by element (odd offsets and strides: Hymba's dt, ldw 50).
//
// Both sum in f32 in a fixed order (no split of the contraction, no
// atomics) and round once to bf16 at the store.
#include <cuda_runtime.h>

#include <cstdint>

#include "bf16_mma.cuh"
#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace {

// A block tile of elements E (float, or bf16 for the bf16 arm).
template <class E_, int BM_, int BN_, int WM_, int WN_, int STAGES_,
          int MINB_>
struct Tile {
  using E = E_;
  static constexpr int VEC = 16 / sizeof(E);  // elements a 16-byte copy
  static constexpr int BM = BM_, BN = BN_;  // output tile of a block
  static constexpr int WM = WM_, WN = WN_;  // warps along M and along N
  static constexpr int BK = 32;             // contraction depth of a stage
  static constexpr int STAGES = STAGES_;
  static constexpr int MINB = MINB_;        // blocks an SM holds
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MT = BM / WM / 16;   // m16 tiles of a warp
  static constexpr int NT = BN / WN / 8;    // n8 tiles of a warp
  static constexpr int SA = BK + VEC;       // row stride of A and of dx's B
  static constexpr int SB_KN = BN + 8;      // row stride of the forward's B
  static constexpr int A_ELTS = BM * SA;
  static constexpr int B_ELTS_KN = BK * SB_KN;
  static constexpr int B_ELTS_NK = BN * SA;
  static constexpr int smem_bytes(bool nk) {
    return STAGES * static_cast<int>(sizeof(E)) *
           (A_ELTS + (nk ? B_ELTS_NK : B_ELTS_KN));
  }
  static_assert(NT % 2 == 0, "B fragments load in pairs of n8 tiles");
};

// A warp's fragments of a whole stage stay in registers (the 12 products of
// each output tile are summed before one f32 add): 128 x 128 and 128 x 64
// need more than the 128 registers that two 256-thread blocks an SM allow.
// The bf16 arm takes the same tiles.
template <class E>
using Large = Tile<E, 128, 128, 2, 4, 4, 1>;
template <class E>
using Medium = Tile<E, 128, 64, 4, 2, 4, 1>;
template <class E>
using Small = Tile<E, 64, 64, 2, 2, 4, 3>;
template <class E>
using Narrow = Tile<E, 64, 32, 2, 2, 4, 3>;

template <class E>
struct WPtrs {
  const E* p[2];
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
      TL::A_ELTS + (NK ? TL::B_ELTS_NK : TL::B_ELTS_KN);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / TL::WN) * (TL::BM / TL::WM);
  const int wn0 = (warp % TL::WN) * (TL::BN / TL::WN);

#pragma unroll
  for (int s = 0; s < TL::STAGES - 1; ++s) {
    if (s < stages) load(smem + s * STAGE, smem + s * STAGE + TL::A_ELTS, s);
    cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<TL::STAGES - 2>();
    __syncthreads();  // stage s landed for all; stage s - 1 is read by all
    const int next = s + TL::STAGES - 1;
    if (next < stages) {
      float* st = smem + (next % TL::STAGES) * STAGE;
      load(st, st + TL::A_ELTS, next);
    }
    cp_async_commit();
    const float* As = smem + (s % TL::STAGES) * STAGE;
    const float* Bs = As + TL::A_ELTS;
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

// -- the bf16 arm ---------------------------------------------------------------

// The B fragments of the warp's NT n8 tiles from column n0, contraction
// kk .. kk + 15, two tiles an ldmatrix.  NK: B stored [BN][SA] (contraction
// contiguous, dx), else [BK][SB_KN] (the forward; read transposed).
template <class TL, bool NK>
__device__ __forceinline__ void load_b_bf16(const bf16* Bs, int n0, int kk,
                                            int lane,
                                            uint32_t (&b)[TL::NT][2]) {
#pragma unroll
  for (int j = 0; j < TL::NT; j += 2) {
    uint32_t v[4];
    if (NK) {
      ldmatrix_x4_bf16(v, Bs + (n0 + j * 8 + (lane & 7) + (lane >> 4) * 8) *
                                   TL::SA +
                              kk + ((lane >> 3) & 1) * 8);
    } else {
      ldmatrix_x4_trans_bf16(
          v, Bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * TL::SB_KN +
                 n0 + j * 8 + (lane >> 4) * 8);
    }
    b[j][0] = v[0], b[j][1] = v[1], b[j + 1][0] = v[2], b[j + 1][1] = v[3];
  }
}

// acc += A B over `stages` contraction stages; load(As, Bs, s) issues the
// copies of stage s.  Each output tile's KS products of a stage are summed
// on the tensor core from zero, then added to acc in f32.
template <class TL, bool NK, class Load>
__device__ __forceinline__ void mainloop(bf16* smem, int stages, Load load,
                                         float (&acc)[TL::MT][TL::NT][4]) {
  constexpr int KS = TL::BK / 16;  // k16 steps of a stage
  constexpr int STAGE = TL::A_ELTS + (NK ? TL::B_ELTS_NK : TL::B_ELTS_KN);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / TL::WN) * (TL::BM / TL::WM);
  const int wn0 = (warp % TL::WN) * (TL::BN / TL::WN);

#pragma unroll
  for (int s = 0; s < TL::STAGES - 1; ++s) {
    if (s < stages) load(smem + s * STAGE, smem + s * STAGE + TL::A_ELTS, s);
    cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<TL::STAGES - 2>();
    __syncthreads();  // stage s landed for all; stage s - 1 is read by all
    const int next = s + TL::STAGES - 1;
    if (next < stages) {
      bf16* st = smem + (next % TL::STAGES) * STAGE;
      load(st, st + TL::A_ELTS, next);
    }
    cp_async_commit();
    const bf16* As = smem + (s % TL::STAGES) * STAGE;
    const bf16* Bs = As + TL::A_ELTS;
    uint32_t b[KS][TL::NT][2];
#pragma unroll
    for (int h = 0; h < KS; ++h)
      load_b_bf16<TL, NK>(Bs, wn0, 16 * h, lane, b[h]);
#pragma unroll
    for (int i = 0; i < TL::MT; ++i) {
      uint32_t a[KS][4];
#pragma unroll
      for (int h = 0; h < KS; ++h)
        ldmatrix_x4_bf16(a[h], As + (wm0 + 16 * i + (lane & 15)) * TL::SA +
                                   16 * h + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < TL::NT; ++j) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int h = 0; h < KS; ++h) mma_bf16(t, a[h], b[h][j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
      }
    }
  }
  cp_async_wait<0>();
}

// store_tile at bf16: each accumulator rounded once to nearest even; a
// thread's two neighbouring columns as one 4-byte store where out and ld
// allow it.
template <class TL>
__device__ __forceinline__ void store_tile(
    const float (&acc)[TL::MT][TL::NT][4], bf16* out, long long ld, int nr,
    int nc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm0 = (warp / TL::WN) * (TL::BM / TL::WM);
  const int wn0 = (warp % TL::WN) * (TL::BN / TL::WN);
  const bool pairs = ld % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
#pragma unroll
  for (int i = 0; i < TL::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm0 + i * 16 + g + 8 * h;
      if (r >= nr) continue;
#pragma unroll
      for (int j = 0; j < TL::NT; ++j) {
        const int c = wn0 + j * 8 + 2 * q;
        bf16* o = out + r * ld + c;
        const float a = acc[i][j][2 * h], b = acc[i][j][2 * h + 1];
        if (pairs && c + 1 < nc) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
        } else {
          if (c < nc) o[0] = __float2bfloat16_rn(a);
          if (c + 1 < nc) o[1] = __float2bfloat16_rn(b);
        }
      }
    }
  }
}

// -- the kernels ---------------------------------------------------------------

// The kernels of both arms: mainloop, store_tile and load_tile take the
// element type of TL (f32: tf32x3.cuh and the 3xTF32 mainloop above; bf16:
// bf16_mma.cuh and the bf16 mainloop above).
template <class TL, int T>
__global__ void __launch_bounds__(TL::THREADS, TL::MINB)
rolling_mm_fwd_kernel(const typename TL::E* __restrict__ x,
                      WPtrs<typename TL::E> w, typename TL::E* y0,
                      typename TL::E* y1, const int* __restrict__ off, int M,
                      int K, int win, long long w_bs, long long ldw,
                      bool x_vec, bool w_vec) {
  using E = typename TL::E;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* smem = reinterpret_cast<E*>(smem_raw);
  const int c = blockIdx.z / T, t = blockIdx.z % T;
  const int m0 = blockIdx.y * TL::BM, n0 = blockIdx.x * TL::BN;
  const int o = off[c];
  const bool wv = w_vec && o % TL::VEC == 0;
  const E* xt = x + ((long long)c * M + m0) * K;
  const E* wt = (t == 0 ? w.p[0] : w.p[1]) + c * w_bs + o + n0;
  auto load = [&](E* As, E* Bs, int s) {
    const int k0 = s * TL::BK;
    load_tile<TL::BM, TL::BK, TL::SA, TL::THREADS>(As, xt + k0, K, M - m0,
                                                   K - k0, x_vec);
    load_tile<TL::BK, TL::BN, TL::SB_KN, TL::THREADS>(
        Bs, wt + k0 * ldw, ldw, K - k0, win - n0, wv);
  };
  float acc[TL::MT][TL::NT][4] = {};
  mainloop<TL, false>(smem, (K + TL::BK - 1) / TL::BK, load, acc);
  E* y = (t == 0 ? y0 : y1) + ((long long)c * M + m0) * win + n0;
  store_tile<TL>(acc, y, win, M - m0, win - n0);
}

template <class TL, int T>
__global__ void __launch_bounds__(TL::THREADS, TL::MINB)
rolling_mm_dx_kernel(const typename TL::E* dy0, const typename TL::E* dy1,
                     WPtrs<typename TL::E> w, typename TL::E* __restrict__ dx,
                     const int* __restrict__ off, int M, int K, int win,
                     long long w_bs, long long ldw, bool dy_vec, bool w_vec) {
  using E = typename TL::E;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* smem = reinterpret_cast<E*>(smem_raw);
  const int c = blockIdx.z;
  const int m0 = blockIdx.y * TL::BM, k0 = blockIdx.x * TL::BN;
  const int o = off[c];
  const bool wv = w_vec && o % TL::VEC == 0;
  const int per_t = (win + TL::BK - 1) / TL::BK;  // stages of one weight
  auto load = [&](E* As, E* Bs, int s) {
    const int t = T == 1 ? 0 : s / per_t;
    const int n0 = (s - t * per_t) * TL::BK;
    const E* dyt = (t == 0 ? dy0 : dy1) + ((long long)c * M + m0) * win;
    const E* wt = (t == 0 ? w.p[0] : w.p[1]) + c * w_bs + k0 * ldw + o;
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
  using L = Large<float>;
  using Me = Medium<float>;
  using Sm = Small<float>;
  if (blocks(L::BM, L::BN) >= sms) return 0;
  if (blocks(Me::BM, Me::BN) >= sms) return 1;
  if (blocks(Sm::BM, Sm::BN) >= sms) return 2;
  return 3;
}

template <class TL, int T, class E>
cudaError_t launch_fwd(const E* x, WPtrs<E> w, E* y0, E* y1, const int* off,
                       int C, int M, int K, int win, long long w_bs,
                       long long ldw, bool x_vec, bool w_vec,
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

template <class TL, int T, class E>
cudaError_t launch_dx(const E* dy0, const E* dy1, WPtrs<E> w, E* dx,
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

template <class E, int T, class... A>
cudaError_t fwd_tiled(int tile, A... a) {
  if (tile == 0) return launch_fwd<Large<E>, T>(a...);
  if (tile == 1) return launch_fwd<Medium<E>, T>(a...);
  if (tile == 2) return launch_fwd<Small<E>, T>(a...);
  return launch_fwd<Narrow<E>, T>(a...);
}

template <class E, int T, class... A>
cudaError_t dx_tiled(int tile, A... a) {
  if (tile == 0) return launch_dx<Large<E>, T>(a...);
  if (tile == 1) return launch_dx<Medium<E>, T>(a...);
  if (tile == 2) return launch_dx<Small<E>, T>(a...);
  return launch_dx<Narrow<E>, T>(a...);
}

// The entry points of both arms: x [C, M, K] and y_t [C, M, win]
// contiguous; W_t rows of stride ldw, clients of stride w_bs; off int32 [C]
// on the device (off[c] + win <= N).  16-byte copies where x's rows and
// W's strides are whole 16-byte vectors (the window's offset is checked
// per client in the kernel).
template <class E>
int fwd_entry(int T, const E* x, const E* w0, const E* w1, E* y0, E* y1,
              const int* off, int C, int M, int K, int win, long long w_bs,
              long long ldw, void* stream) {
  if (T != 1 && T != 2) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = 16 / sizeof(E);
  const WPtrs<E> w{{w0, w1}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool x_vec = K % V == 0 && aligned16(x);
  const bool w_vec = ldw % V == 0 && w_bs % V == 0 && aligned16(w0) &&
                     (T == 1 || aligned16(w1));
  const int tile = pick_tile(win, M, C * T);
  return static_cast<int>(
      T == 1 ? fwd_tiled<E, 1>(tile, x, w, y0, y1, off, C, M, K, win, w_bs,
                               ldw, x_vec, w_vec, s)
             : fwd_tiled<E, 2>(tile, x, w, y0, y1, off, C, M, K, win, w_bs,
                               ldw, x_vec, w_vec, s));
}

// dy_t [C, M, win] and dx [C, M, K] contiguous; W_t as for fwd_entry.
template <class E>
int dx_entry(int T, const E* dy0, const E* dy1, const E* w0, const E* w1,
             E* dx, const int* off, int C, int M, int K, int win,
             long long w_bs, long long ldw, void* stream) {
  if (T != 1 && T != 2) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = 16 / sizeof(E);
  const WPtrs<E> w{{w0, w1}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dy_vec = win % V == 0 && aligned16(dy0) &&
                      (T == 1 || aligned16(dy1));
  const bool w_vec = ldw % V == 0 && w_bs % V == 0 && aligned16(w0) &&
                     (T == 1 || aligned16(w1));
  const int tile = pick_tile(K, M, C);
  return static_cast<int>(
      T == 1 ? dx_tiled<E, 1>(tile, dy0, dy1, w, dx, off, C, M, K, win, w_bs,
                              ldw, dy_vec, w_vec, s)
             : dx_tiled<E, 2>(tile, dy0, dy1, w, dx, off, C, M, K, win, w_bs,
                              ldw, dy_vec, w_vec, s));
}


// -- the bf16 arm's wgmma body ------------------------------------------------

// A wgmma block tile: BM / 64 consumer warpgroups, each owning 64 rows by
// BN columns of the output in BN / 2 f32 registers a thread, and one
// producer warp whose first lane keeps STAGES stages of A (x or dy, BM x 64)
// and B (W, 64 x BN) in flight through TMA.
template <int BM_, int BN_, int STAGES_>
struct WTile {
  static constexpr int BM = BM_, BN = BN_, BK = 64, STAGES = STAGES_;
  static constexpr int WG = BM / 64;              // consumer warpgroups
  static constexpr int THREADS = 128 * WG + 32;   // + the producer warp
  static constexpr int R = BN / 2;                // accumulators a thread
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // + 1024 to align the ring to the swizzle's 1024 bytes, + the barriers
  static constexpr int smem_bytes = STAGES * STAGE_BYTES + 1024 + 16 * STAGES;
};
// the forward's B is MN-major in 64-column chunks, so its tiles are at
// least 64 wide; dx also takes 64 x 32 (the k/v projections' narrow grids)
using W128x128 = WTile<128, 128, 6>;
using W64x128 = WTile<64, 128, 4>;
using W64x64 = WTile<64, 64, 6>;
using W64x32 = WTile<64, 32, 8>;

template <int BN, int TB>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (BN == 128) {
    wgmma_n128<TB>(d, a, b, scale_d);
  } else if constexpr (BN == 64) {
    wgmma_n64<TB>(d, a, b, scale_d);
  } else {
    static_assert(BN == 32, "wgmma tile width");
    wgmma_n32<TB>(d, a, b, scale_d);
  }
}

// Zero columns [rem, 64) of the K-major tile at B (rows x 64, swizzled):
// dx's B past the end of the window, which TMA filled from W's next
// columns.  128 threads of one warpgroup.
template <int ROWS>
__device__ __forceinline__ void zero_tail(unsigned char* B, int rem,
                                          int tid) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = tid; i < ROWS * 8; i += 128) {
    const int r = i >> 3, chunk = i & 7;
    if (8 * chunk + 7 < rem) continue;
    bf16* p = reinterpret_cast<bf16*>(B + r * 128 + ((chunk ^ (r & 7)) << 4));
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (8 * chunk + e >= rem) p[e] = zero;
  }
}

// rolling_mm_fwd (DX false) or rolling_mm_dx (DX true) at bf16 on wgmma.
// Forward: a0 maps x [C*M, K]; b_t map W_t [C, K, N]; block z = c * T + t
// writes y_t.  dx: a_t map dy_t [C*M, win]; b_t map W_t; block z = c sums
// over t and the window into dx.  The accumulators stay in registers for
// the whole contraction; each stage's four k16 products are summed on the
// tensor core from zero and added to them in f32 (the bf16 arm's rule).
template <class WT, int T, bool DX>
__device__ __forceinline__ void wgmma_body(const CUtensorMap& a0,
                                           const CUtensorMap& a1,
                                           const CUtensorMap& b0,
                                           const CUtensorMap& b1, bf16* out0,
                                           bf16* out1, const int* off, int M,
                                           int K, int win) {
  constexpr int STAGES = WT::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * WT::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = DX ? blockIdx.z : blockIdx.z / T;
  const int t_out = DX ? 0 : blockIdx.z % T;
  const int m0 = blockIdx.y * WT::BM, n0 = blockIdx.x * WT::BN;
  const int o = off[c];
  const int per_t = (win + WT::BK - 1) / WT::BK;  // dx: stages a weight
  const int nst = DX ? T * per_t : (K + WT::BK - 1) / WT::BK;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * WT::WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * WT::WG) {  // the producer
    if (lane == 0) {
      for (int s = 0; s < nst; ++s) {
        const int slot = s % STAGES;
        if (s >= STAGES) mbar_wait(&empty[slot], (s / STAGES - 1) & 1);
        unsigned char* A = ring + slot * WT::STAGE_BYTES;
        unsigned char* B = A + WT::A_BYTES;
        mbar_expect_tx(&full[slot], WT::STAGE_BYTES);
        if (DX) {
          const int t = T == 1 ? 0 : s / per_t, j0 = (s - t * per_t) * 64;
          tma_load_2d(A, t ? &a1 : &a0, &full[slot], j0, c * M + m0);
          tma_load_3d(B, t ? &b1 : &b0, &full[slot], o + j0, n0, c);
        } else {
          const int k0 = s * 64;
          tma_load_2d(A, &a0, &full[slot], k0, c * M + m0);
#pragma unroll
          for (int cn = 0; cn < WT::BN / 64; ++cn)
            tma_load_3d(B + cn * 8192, t_out ? &b1 : &b0, &full[slot],
                        o + n0 + 64 * cn, k0, c);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of the block tile
  const int wg = warp >> 2, wtid = tid & 127;
  float acc[WT::R], part[WT::R];
#pragma unroll
  for (int i = 0; i < WT::R; ++i) acc[i] = part[i] = 0.f;
  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  for (int s = 0; s < nst; ++s) {
    const int slot = s % STAGES;
    mbar_wait(&full[slot], (s / STAGES) & 1);
    __syncwarp();  // the wgmma below run on converged warps
    const uint32_t As = ring_s + slot * WT::STAGE_BYTES + wg * 64 * 128;
    const uint32_t Bs = ring_s + slot * WT::STAGE_BYTES + WT::A_BYTES;
    if (DX) {
      const int rem = win - (s % per_t) * 64;  // window columns left
      if (rem < 64) {
        zero_tail<WT::BN>(ring + slot * WT::STAGE_BYTES + WT::A_BYTES, rem,
                          wtid);
        fence_proxy_async();
        __syncwarp();
        named_barrier(1 + wg, 128);
      }
    }
    wgmma_hold(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = wgmma_desc(As + 32 * kk, 16, 1024);
      const uint64_t db = DX ? wgmma_desc(Bs + 32 * kk, 16, 1024)
                             : wgmma_desc(Bs + 2048 * kk, 8192, 1024);
      wgmma_bn<WT::BN, DX ? 0 : 1>(part, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(part);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
#pragma unroll
    for (int i = 0; i < WT::R; ++i) acc[i] += part[i];
  }

  // store: accumulator 4 i + 2 h + e is row 16 (warp % 4) + g + 8 h,
  // column 8 i + 2 q + e of the warpgroup's 64 x BN
  bf16* out = DX ? out0 : (t_out ? out1 : out0);
  const long long ld = DX ? K : win;
  const int nr = M - m0, nc = (DX ? K : win) - n0;
  out += (static_cast<long long>(c) * M + m0) * ld + n0;
  const int g = lane >> 2, q = lane & 3;
  const bool pairs = ld % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * wg + 16 * (warp & 3) + g + 8 * h;
    if (r >= nr) continue;
#pragma unroll
    for (int i = 0; i < WT::BN / 8; ++i) {
      const int col = 8 * i + 2 * q;
      bf16* p = out + r * ld + col;
      const float x0 = acc[4 * i + 2 * h], x1 = acc[4 * i + 2 * h + 1];
      if (pairs && col + 1 < nc) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < nc) p[0] = __float2bfloat16_rn(x0);
        if (col + 1 < nc) p[1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// The two kernels (named apart, so that a profile groups each with its
// arm's other body).
template <class WT, int T>
__global__ void __launch_bounds__(WT::THREADS, 1) rolling_mm_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap a0,
    const __grid_constant__ CUtensorMap a1,
    const __grid_constant__ CUtensorMap b0,
    const __grid_constant__ CUtensorMap b1, bf16* out0, bf16* out1,
    const int* __restrict__ off, int M, int K, int win) {
  wgmma_body<WT, T, false>(a0, a1, b0, b1, out0, out1, off, M, K, win);
}

template <class WT, int T>
__global__ void __launch_bounds__(WT::THREADS, 1) rolling_mm_dx_wgmma_kernel(
    const __grid_constant__ CUtensorMap a0,
    const __grid_constant__ CUtensorMap a1,
    const __grid_constant__ CUtensorMap b0,
    const __grid_constant__ CUtensorMap b1, bf16* out0, bf16* out1,
    const int* __restrict__ off, int M, int K, int win) {
  wgmma_body<WT, T, true>(a0, a1, b0, b1, out0, out1, off, M, K, win);
}

// The wgmma tile of a launch whose output has `cols` columns, M rows per
// client and Z client-weight pairs: the largest whose grid covers every
// SM, else the narrowest (the forward's narrowest is 64 x 64).
int pick_wtile(bool dx, int cols, int M, int Z) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const auto blocks = [&](int bm, int bn) {
    return (long long)((cols + bn - 1) / bn) * ((M + bm - 1) / bm) * Z;
  };
  if (blocks(W128x128::BM, W128x128::BN) >= sms) return 0;
  if (blocks(W64x128::BM, W64x128::BN) >= sms) return 1;
  if (!dx || blocks(W64x64::BM, W64x64::BN) >= sms) return 2;
  return 3;
}

// Whether TMA takes the operands of a bf16 launch: the bases 16-byte
// aligned, the row strides (x: K; dy: win; W: ldw) and W's client stride
// whole 16-byte vectors, the clients' weights apart, and every client's
// offset (offs16) a whole 16-byte vector: a box's first element must lie
// on one (a box of W at an offset of 5, 12 or 37 elements stops the
// kernel with an illegal instruction on an H100).
bool tma_ok(const bf16* a0, const bf16* a1, int lda, const bf16* w0,
            const bf16* w1, int T, int C, int K, long long w_bs,
            long long ldw, int offs16) {
  return offs16 && aligned16(a0) && (T == 1 || !a1 || aligned16(a1)) &&
         lda % 8 == 0 &&
         aligned16(w0) && (T == 1 || aligned16(w1)) && ldw % 8 == 0 &&
         (C == 1 || (w_bs % 8 == 0 && w_bs >= K * ldw));
}

template <class WT, int T, bool DX>
cudaError_t launch_wgmma(const bf16* a0p, const bf16* a1p, int a_rows,
                         int lda, const bf16* w0, const bf16* w1,
                         bf16* out0, bf16* out1, const int* off, int C,
                         int M, int K, int N, int win, long long w_bs,
                         long long ldw, cudaStream_t s) {
  CUtensorMap a0, a1, b0, b1;
  const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(lda),
                                static_cast<cuuint64_t>(a_rows)};
  const cuuint64_t a_str[1] = {static_cast<cuuint64_t>(lda) * 2};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(C)};
  const cuuint64_t w_str[2] = {
      static_cast<cuuint64_t>(ldw) * 2,
      static_cast<cuuint64_t>(C == 1 ? ldw * K : w_bs) * 2};
  const int b_box = DX ? WT::BN : 64;
  if (!make_map(&a0, a0p, 2, a_dims, a_str, WT::BM) ||
      !make_map(&b0, w0, 3, w_dims, w_str, b_box))
    return cudaErrorInvalidValue;
  a1 = a0, b1 = b0;  // one weight: the second pair is never read
  if (T == 2 && ((DX && !make_map(&a1, a1p, 2, a_dims, a_str, WT::BM)) ||
                 !make_map(&b1, w1, 3, w_dims, w_str, b_box)))
    return cudaErrorInvalidValue;
  const auto kern = [] {
    if constexpr (DX)
      return rolling_mm_dx_wgmma_kernel<WT, T>;
    else
      return rolling_mm_fwd_wgmma_kernel<WT, T>;
  }();
  // above 48 KB a block's dynamic shared memory needs this opt-in, once
  static const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, WT::smem_bytes);
  if (e != cudaSuccess) return e;
  const int cols = DX ? K : win;
  const dim3 grid((cols + WT::BN - 1) / WT::BN, (M + WT::BM - 1) / WT::BM,
                  DX ? C : C * T);
  kern<<<grid, WT::THREADS, WT::smem_bytes, s>>>(a0, a1, b0, b1, out0, out1,
                                                 off, M, K, win);
  return cudaGetLastError();
}

template <int T, bool DX, class... A>
cudaError_t wgmma_tiled(int tile, A... a) {
  if (tile == 0) return launch_wgmma<W128x128, T, DX>(a...);
  if (tile == 1) return launch_wgmma<W64x128, T, DX>(a...);
  if constexpr (DX) {
    if (tile == 3) return launch_wgmma<W64x32, T, DX>(a...);
  }
  return launch_wgmma<W64x64, T, DX>(a...);
}

// The bf16 entry points: the wgmma body where TMA takes the operands
// (tma_ok), else the mma.sync body (its copies take any alignment); *body
// says which ran, 1 wgmma, 0 mma.sync.
int fwd_entry_bf16(int T, const bf16* x, const bf16* w0, const bf16* w1,
                   bf16* y0, bf16* y1, const int* off, int C, int M, int K,
                   int N, int win, long long w_bs, long long ldw,
                   void* stream, int offs16, int* body) {
  if (T != 1 && T != 2) return static_cast<int>(cudaErrorInvalidValue);
  *body = tma_ok(x, nullptr, K, w0, w1, T, C, K, w_bs, ldw, offs16);
  if (!*body)
    return fwd_entry(T, x, w0, w1, y0, y1, off, C, M, K, win, w_bs, ldw,
                     stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile = pick_wtile(false, win, M, C * T);
  return static_cast<int>(
      T == 1 ? wgmma_tiled<1, false>(tile, x, x, C * M, K, w0, w1, y0, y1,
                                     off, C, M, K, N, win, w_bs, ldw, s)
             : wgmma_tiled<2, false>(tile, x, x, C * M, K, w0, w1, y0, y1,
                                     off, C, M, K, N, win, w_bs, ldw, s));
}

int dx_entry_bf16(int T, const bf16* dy0, const bf16* dy1, const bf16* w0,
                  const bf16* w1, bf16* dx, const int* off, int C, int M,
                  int K, int N, int win, long long w_bs, long long ldw,
                  void* stream, int offs16, int* body) {
  if (T != 1 && T != 2) return static_cast<int>(cudaErrorInvalidValue);
  *body = tma_ok(dy0, dy1, win, w0, w1, T, C, K, w_bs, ldw, offs16);
  if (!*body)
    return dx_entry(T, dy0, dy1, w0, w1, dx, off, C, M, K, win, w_bs, ldw,
                    stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile = pick_wtile(true, K, M, C);
  return static_cast<int>(
      T == 1 ? wgmma_tiled<1, true>(tile, dy0, dy1, C * M, win, w0, w1, dx,
                                    dx, off, C, M, K, N, win, w_bs, ldw, s)
             : wgmma_tiled<2, true>(tile, dy0, dy1, C * M, win, w0, w1, dx,
                                    dx, off, C, M, K, N, win, w_bs, ldw, s));
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).
extern "C" int rolling_mm_fwd(int T, const float* x, const float* w0,
                              const float* w1, float* y0, float* y1,
                              const int* off, int C, int M, int K, int N,
                              int win, long long w_bs, long long ldw,
                              void* stream) {
  (void)N;
  return fwd_entry(T, x, w0, w1, y0, y1, off, C, M, K, win, w_bs, ldw,
                   stream);
}

extern "C" int rolling_mm_dx(int T, const float* dy0, const float* dy1,
                             const float* w0, const float* w1, float* dx,
                             const int* off, int C, int M, int K, int N,
                             int win, long long w_bs, long long ldw,
                             void* stream) {
  (void)N;
  return dx_entry(T, dy0, dy1, w0, w1, dx, off, C, M, K, win, w_bs, ldw,
                  stream);
}

// The block tile (rows << 16 | columns) that rolling_mm_fwd (dx = 0) or
// rolling_mm_dx (dx = 1) takes for these sizes on the current device: the
// f32 arm's (bf16 = 0; the bf16 arm's mma.sync body takes the same), or the
// bf16 arm's wgmma body's (bf16 = 1).
extern "C" int rolling_mm_tile(int dx, int T, int C, int M, int K, int win,
                               int bf16) {
  static const int tiles[4] = {
      Large<float>::BM << 16 | Large<float>::BN,
      Medium<float>::BM << 16 | Medium<float>::BN,
      Small<float>::BM << 16 | Small<float>::BN,
      Narrow<float>::BM << 16 | Narrow<float>::BN};
  static const int wtiles[4] = {W128x128::BM << 16 | W128x128::BN,
                                W64x128::BM << 16 | W64x128::BN,
                                W64x64::BM << 16 | W64x64::BN,
                                W64x32::BM << 16 | W64x32::BN};
  if (bf16)
    return wtiles[dx ? pick_wtile(true, K, M, C)
                     : pick_wtile(false, win, M, C * T)];
  return tiles[dx ? pick_tile(K, M, C) : pick_tile(win, M, C * T)];
}

// The bf16 arm: every operand bf16, the same layout rules; offs16 says
// whether every client's offset is a multiple of 8 elements (the host's
// offsets; the kernels read the device copy); *body is 1 where the wgmma
// body ran, 0 where the mma.sync body did.
extern "C" int rolling_mm_fwd_bf16(int T, const bf16* x, const bf16* w0,
                                   const bf16* w1, bf16* y0, bf16* y1,
                                   const int* off, int C, int M, int K, int N,
                                   int win, long long w_bs, long long ldw,
                                   void* stream, int offs16, int* body) {
  return fwd_entry_bf16(T, x, w0, w1, y0, y1, off, C, M, K, N, win, w_bs,
                        ldw, stream, offs16, body);
}

extern "C" int rolling_mm_dx_bf16(int T, const bf16* dy0, const bf16* dy1,
                                  const bf16* w0, const bf16* w1, bf16* dx,
                                  const int* off, int C, int M, int K, int N,
                                  int win, long long w_bs, long long ldw,
                                  void* stream, int offs16, int* body) {
  return dx_entry_bf16(T, dy0, dy1, w0, w1, dx, off, C, M, K, N, win, w_bs,
                       ldw, stream, offs16, body);
}
