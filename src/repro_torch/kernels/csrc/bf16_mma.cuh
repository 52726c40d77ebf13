// bf16 building blocks for Hopper's tensor cores: the bf16 arms of the
// windowed products' mma.sync body (rolling_mm.cu) and of flash attention
// (flash_attn.cu), and the widening helpers of the SSD chunk block's bf16
// arm (ssd_chunk.cu; the last section), whose overloads flash attention's
// f32 arm shares.  Beside tf32x3.cuh, whose copy and pipeline helpers they
// share.
//
// A bf16 operand is exact in one tensor-core pass: mma.sync m16n8k16 with
// bf16 A and B and f32 accumulators multiplies exactly and sums in f32, so
// no split is needed; 2*M*N*K operations run at the card's dense bf16 rate
// (989 TFLOP/s at best on an H100).  The kernels keep tf32x3.cuh's rule for
// the running sum: each stage's products are summed on the tensor core from
// zero, then added to the register accumulator with an f32 add, rounded to
// nearest; the result is rounded once to bf16 at the store.
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

// -- widening at fragment build (ssd_chunk.cu) --------------------------------
//
// Its bf16 arm keeps bf16 tiles in shared memory (half the f32 arm's
// bytes) and widens each element to f32 exactly as a fragment is built, so
// the 3xTF32 mainloops run unchanged: a widened bf16 has no bits below
// TF32's, so its small part is 0.  Each overload pair below does one thing
// for either element type; the f32 one is the f32 arm's own code.  A bf16
// row of shared memory is HD + 8 elements (f32: HD + 4): its fragment reads
// then hit distinct 4-byte words across a warp, or the same word (a
// broadcast), and rows stay 16-byte aligned.

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <class E>
__device__ __forceinline__ E from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// p[0], p[1] = a, b (p two elements aligned); bf16 rounds each once.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t wide_bits(bf16 v) {
  return __float_as_uint(__bfloat162float(v));
}

// The m16n8k8 A fragment of the 16 x 8 tile at s (row stride ld, the
// contraction along the row), as f32 bits: lane 4 g + q gets (g, q),
// (g + 8, q), (g, q + 4), (g + 8, q + 4).
__device__ __forceinline__ void frag_a(uint32_t (&v)[4], const float* s,
                                       int ld) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(v, s + (lane & 15) * ld + (lane >> 4) * 4);
}
__device__ __forceinline__ void frag_a(uint32_t (&v)[4], const bf16* s,
                                       int ld) {
  const int lane = threadIdx.x & 31;
  const bf16* p = s + (lane >> 2) * ld + (lane & 3);
  v[0] = wide_bits(p[0]);
  v[1] = wide_bits(p[8 * ld]);
  v[2] = wide_bits(p[4]);
  v[3] = wide_bits(p[8 * ld + 4]);
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
__device__ __forceinline__ void frag_b2(uint32_t (&v)[4], const bf16* s,
                                        int ld) {
  const int lane = threadIdx.x & 31;
  const bf16* p = s + (lane >> 2) * ld + (lane & 3);
  v[0] = wide_bits(p[0]);
  v[1] = wide_bits(p[4]);
  v[2] = wide_bits(p[8 * ld]);
  v[3] = wide_bits(p[8 * ld + 4]);
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           int bytes) {
  cp_async16_bf16(dst, src, bytes);
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
