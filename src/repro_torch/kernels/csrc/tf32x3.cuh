// 3xTF32 building blocks for Hopper's tensor cores, shared by the kernels
// that keep f32 accuracy on mma.sync m16n8k8 TF32: the windowed products
// (rolling_mm.cu), the SSD chunk block (ssd_chunk.cu) and flash attention
// (flash_attn.cu).
//
// The split: each operand a = big + small, big = a rounded to TF32 and
// small = a - big (exact in f32), and each product is small*big +
// big*small + big*big, the small products first (small*small is below f32
// rounding).  That is three TF32 tensor-core passes, so an f32 product runs
// at 495 / 3 = 165 TFLOP/s at best on an H100.
//
// Two numerical rules, which every kernel built on this header keeps:
// - The tensor core's f32 accumulation truncates, and on a running sum over
//   a long contraction that bias toward zero grows with its length.  So
//   each stage's products (at most a few dozen) are summed on the tensor
//   core from zero, then added to the register accumulator with an f32 add,
//   rounded to nearest.
// - big is rounded by integer add and mask, (bits + 0x1000) & ~0x1fff,
//   which is cvt.rna.tf32.f32 (to nearest, ties away from zero) for finite
//   values in two integer instructions (cvt.rna compiles to a longer
//   sequence that also tests for inf and NaN); small goes to the tensor
//   core as f32 bits, whose low 13 bits it ignores (an error below 2^-21 of
//   a).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Copy 16 bytes, of which the first `bytes` come from src and the rest are
// zero.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy a ROWS x COLS tile of a matrix (COLS contiguous, row stride ld, the
// tile's first element at g) into shared memory of row stride SLD; elements
// at row >= nr or column >= nc are zero.  vec: 16-byte copies (g and ld are
// multiples of 4 floats), else 4-byte copies.  A thread copies one column
// (chunk) of every RSTEP-th row, walking one source pointer down the rows.
template <int ROWS, int COLS, int SLD, int THREADS>
__device__ __forceinline__ void load_tile(float* s, const float* g,
                                          long long ld, int nr, int nc,
                                          bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int CPR = COLS / 4;  // 16-byte chunks in a row
    constexpr int RSTEP = THREADS / CPR;
    static_assert(THREADS % CPR == 0 && ROWS % RSTEP == 0, "tile shape");
    const int r0 = tid / CPR, c = (tid % CPR) * 4;
    const int v = min(max(nc - c, 0), 4);
    const float* src = g + r0 * ld + c;
    float* dst = s + r0 * SLD + c;
#pragma unroll
    for (int l = 0; l < ROWS / RSTEP; ++l) {
      const int n = r0 + l * RSTEP < nr ? v : 0;
      cp_async16(dst + l * RSTEP * SLD, n ? src : g, 4 * n);
      src += RSTEP * ld;
    }
  } else {
    constexpr int RSTEP = THREADS / COLS;
    static_assert(THREADS % COLS == 0 && ROWS % RSTEP == 0, "tile shape");
    const int r0 = tid / COLS, c = tid % COLS;
    const float* src = g + r0 * ld + c;
    float* dst = s + r0 * SLD + c;
    // not unrolled: the compiler would keep every copy's address live
    // across the main loop, registers the products need
#pragma unroll 1
    for (int l = 0; l < ROWS / RSTEP; ++l) {
      const bool ok = c < nc && r0 + l * RSTEP < nr;
      cp_async4(dst + l * RSTEP * SLD, ok ? src : g, ok ? 4 : 0);
      src += RSTEP * ld;
    }
  }
}

// Copy ROWS rows of COLS floats (row stride ld, the first at src) into
// shared memory of row stride SLD, rows >= nr zero; any COLS that is a
// multiple of 4 and any thread count.  vec: 16-byte copies (src and ld
// multiples of 4 floats), else 4-byte ones.
template <int ROWS, int COLS, int SLD, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long ld, int nr, bool vec) {
  if (vec) {
    constexpr int CPR = COLS / 4;
    for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * 4;
      const bool ok = r < nr;
      cp_async16(dst + r * SLD + c, ok ? src + r * ld + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      const bool ok = r < nr;
      cp_async4(dst + r * SLD + c, ok ? src + r * ld + c : src, ok ? 4 : 0);
    }
  }
}

// a = big + small: big is a rounded to TF32 (to nearest, ties away from
// zero), small = a - big exactly in f32; the tensor core reads small's
// top 19 bits.
__device__ __forceinline__ void split_tf32(float a, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(a - __uint_as_float(big));
}

__device__ __forceinline__ void split4(const uint32_t (&v)[4],
                                       uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split_tf32(__uint_as_float(v[e]), big[e], small[e]);
}

// Four 8 x 4 f32 matrices (8 rows of 16 bytes each; lane l gives the address
// of row l % 8 of matrix l / 8); lane 4 g + q receives element (g, q) of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&v)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
      : "r"(smem_u32(p)));
}

// d += a b: a 16 x 8 (row), b 8 x 8 (col), d 16 x 8, per the m16n8k8 TF32
// fragment layouts (lane = 4 g + q: a = (g, q), (g + 8, q), (g, q + 4),
// (g + 8, q + 4); b = (k q, n g), (k q + 4, n g); d = (g, 2q), (g, 2q + 1),
// (g + 8, 2q), (g + 8, 2q + 1)).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// t[i][j] += a[i] b[j] in 3xTF32 over MT x NT independent tiles, one
// product at a time across all of them, so consecutive mma do not wait on
// each other's accumulator.
template <int MT, int NT>
__device__ __forceinline__ void mma3_tiles(float (&t)[MT][NT][4],
                                           const uint32_t (&ab)[MT][4],
                                           const uint32_t (&as)[MT][4],
                                           const uint32_t (&bb)[NT][2],
                                           const uint32_t (&bs)[NT][2]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(t[i][j], as[i], bb[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(t[i][j], ab[i], bs[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(t[i][j], ab[i], bb[j]);
}

}  // namespace
