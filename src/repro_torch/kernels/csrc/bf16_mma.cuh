// bf16 building blocks for Hopper's tensor cores: the bf16 arms of the
// windowed products' mma.sync body (rolling_mm.cu), of flash attention
// (flash_attn.cu) and of the SSD chunk block (ssd_chunk.cu), and the
// overloads that let one kernel template copy and store either element type
// (the last section; flash attention's and the SSD block's f32 arms share
// them).  Beside tf32x3.cuh, whose copy and pipeline helpers they share.
//
// A bf16 operand is exact in one tensor-core pass: mma.sync m16n8k16 with
// bf16 A and B and f32 accumulators multiplies exactly and sums in f32, so
// no split is needed; 2*M*N*K operations run at the card's dense bf16 rate
// (989 TFLOP/s at best on an H100).  An f32 operand (a softmax weight, a
// decay-weighted SSD term) goes in as two bf16 passes on its two parts
// (split_bf16x2), within 2^-17 of it.  The products and flash attention
// keep tf32x3.cuh's rule for the running sum: each stage's products are
// summed on the tensor core from zero, then added to the register
// accumulator with an f32 add, rounded to nearest (the SSD block's
// contractions, at most 32 mma, are summed on the tensor core directly:
// ssd_chunk.cu); the result is rounded once to bf16 at the store.
//
// Copies into shared memory are 16 bytes (8 bf16) where the source rows
// allow it (row stride and first column multiples of 8 elements).
// cp.async copies 4, 8 or 16 bytes, so it has no copy for a bf16 at an odd
// element: otherwise each thread copies single elements with plain loads
// and stores (any offset, even or odd; the copy of the stage two ahead
// then does not overlap the products).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// Copy 16 bytes, of which the first `bytes` come from src and the rest are
// zero (any byte count 0..16).
__device__ __forceinline__ void cp_async16_bf16(bf16* dst, const bf16* src,
                                                int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// tf32x3.cuh's load_tile at bf16: copy a ROWS x COLS bf16 tile of a matrix (COLS contiguous, row stride ld,
// the tile's first element at g) into shared memory of row stride SLD;
// elements at row >= nr or column >= nc are zero.  vec: 16-byte cp.async
// (g and ld multiples of 8 elements), else element by element.
template <int ROWS, int COLS, int SLD, int THREADS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          long long ld, int nr, int nc,
                                          bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int CPR = COLS / 8;  // 16-byte chunks in a row
    constexpr int RSTEP = THREADS / CPR;
    static_assert(THREADS % CPR == 0 && ROWS % RSTEP == 0, "tile shape");
    const int r0 = tid / CPR, c = (tid % CPR) * 8;
    const int v = min(max(nc - c, 0), 8);
    const bf16* src = g + r0 * ld + c;
    bf16* dst = s + r0 * SLD + c;
#pragma unroll
    for (int l = 0; l < ROWS / RSTEP; ++l) {
      const int n = r0 + l * RSTEP < nr ? v : 0;
      cp_async16_bf16(dst + l * RSTEP * SLD, n ? src : g, 2 * n);
      src += RSTEP * ld;
    }
  } else {
    constexpr int RSTEP = THREADS / COLS;
    static_assert(THREADS % COLS == 0 && ROWS % RSTEP == 0, "tile shape");
    const int r0 = tid / COLS, c = tid % COLS;
    const bf16* src = g + r0 * ld + c;
    bf16* dst = s + r0 * SLD + c;
    const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll 1
    for (int l = 0; l < ROWS / RSTEP; ++l) {
      const bool ok = c < nc && r0 + l * RSTEP < nr;
      dst[l * RSTEP * SLD] = ok ? *src : zero;
      src += RSTEP * ld;
    }
  }
}

// Four 8 x 8 bf16 matrices (8 rows of 16 bytes each; lane l gives the
// address of row l % 8 of matrix l / 8); lane 4 g + q receives elements
// (g, 2q) and (g, 2q + 1) of each.
__device__ __forceinline__ void ldmatrix_x4_bf16(uint32_t (&v)[4],
                                                 const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
      : "r"(smem_u32(p)));
}

// The same, each matrix transposed: lane 4 g + q receives elements
// (2q, g) and (2q + 1, g).
__device__ __forceinline__ void ldmatrix_x4_trans_bf16(uint32_t (&v)[4],
                                                       const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
      : "r"(smem_u32(p)));
}

// Two 8 x 8 bf16 matrices, each transposed (lanes 0-15 give the row
// addresses, as for x4): lane 4 g + q receives elements (2q, g) and
// (2q + 1, g) of each.
__device__ __forceinline__ void ldmatrix_x2_trans_bf16(uint32_t (&v)[2],
                                                       const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(v[0]), "=r"(v[1])
      : "r"(smem_u32(p)));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), d 16 x 8 f32, per the m16n8k16
// bf16 fragment layouts (lane = 4 g + q; each register two bf16 along k:
// a = (g, 2q..), (g + 8, 2q..), (g, 2q + 8..), (g + 8, 2q + 8..);
// b = (k 2q.., n g), (k 2q + 8.., n g); d = (g, 2q), (g, 2q + 1),
// (g + 8, 2q), (g + 8, 2q + 1)).
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// split_bf16x2(a, b): hi = the bf16 pair (a, b) rounded to nearest, lo =
// the bf16 pair of what is left (a - hi, b - hi exactly in f32), each a
// register of two bf16, a in the low half: hi + lo lies within 2^-17 of
// each value (a bf16 rounds to 2^-9 of itself, twice).
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The two bf16 of a register (the low half first) as floats.
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// -- either element type ----------------------------------------------------
//
// Overloads that the f32 and bf16 kernels of the SSD block and flash
// attention share (copies and output stores), and the f32 fragment loads
// of their f32 arms.  A bf16 row of shared memory is HD + 8 elements:
// ldmatrix's eight row addresses then fall in distinct 16-byte bank
// groups, and rows stay 16-byte aligned.

// p[0], p[1] = a, b (p two elements aligned); bf16 rounds each once.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The m16n8k8 A fragment of the 16 x 8 tile at s (row stride ld, the
// contraction along the row), as f32 bits: lane 4 g + q gets (g, q),
// (g + 8, q), (g, q + 4), (g + 8, q + 4).
__device__ __forceinline__ void frag_a(uint32_t (&v)[4], const float* s,
                                       int ld) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(v, s + (lane & 15) * ld + (lane >> 4) * 4);
}
// The m16n8k8 B fragments of two n8 tiles at s (16 rows along n, row
// stride ld, the contraction along the row), as f32 bits: lane 4 g + q
// gets (n g, k q) and (n g, k q + 4) of tile 0 (rows 0-7) in v[0], v[1],
// and of tile 1 (rows 8-15) in v[2], v[3].
__device__ __forceinline__ void frag_b2(uint32_t (&v)[4], const float* s,
                                        int ld) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(v, s + ((lane & 7) + (lane >> 4) * 8) * ld +
                     ((lane >> 3) & 1) * 4);
}

// A ROWS x COLS tile (COLS contiguous, row stride ld, the first element at
// g) into shared memory of row stride SLD, elements at row >= nr or column
// >= nc zero.  f32: tf32x3.cuh's load_tile.  bf16: any tile shape and
// thread count (COLS a multiple of 8); vec: 16-byte cp.async (g and ld
// multiples of 8 elements), else element by element with plain loads.
template <int ROWS, int COLS, int SLD, int THREADS>
__device__ __forceinline__ void load_block(float* s, const float* g,
                                           long long ld, int nr, int nc,
                                           bool vec) {
  load_tile<ROWS, COLS, SLD, THREADS>(s, g, ld, nr, nc, vec);
}
template <int ROWS, int COLS, int SLD, int THREADS>
__device__ __forceinline__ void load_block(bf16* s, const bf16* g,
                                           long long ld, int nr, int nc,
                                           bool vec) {
  static_assert(COLS % 8 == 0, "tile shape");
  if (vec) {
    constexpr int CPR = COLS / 8;
    for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const int n = r < nr ? min(max(nc - c, 0), 8) : 0;
      cp_async16_bf16(s + r * SLD + c, n ? g + r * ld + c : g, 2 * n);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      s[r * SLD + c] = r < nr && c < nc ? g[r * ld + c] : zero;
    }
  }
}

// tf32x3.cuh's load_rows at bf16: ROWS full rows of COLS, rows >= nr zero.
template <int ROWS, int COLS, int SLD, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ld, int nr, bool vec) {
  load_block<ROWS, COLS, SLD, THREADS>(dst, src, ld, nr, COLS, vec);
}

}  // namespace
