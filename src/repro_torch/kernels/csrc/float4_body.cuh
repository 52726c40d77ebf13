// The body shared by the in-place update kernels (sgd.cu, masked_update.cu):
// how a leaf splits into a 16-byte aligned vector body and scalar ends, the
// grid that covers them, and the element types' loads and stores (Elt: f32,
// and bf16 widened to f32 at the load and rounded once at the store), so
// that one kernel body serves both arms.
//
// An update kernel touches every byte once, and a client leaf is many times
// the 50 MB L2, so it is bound by HBM.  Each thread of the body takes one
// float4 of every operand, and the grid has one block for every kThreads
// float4, with no grid stride: the block scheduler then walks the leaf in
// order.  Measured on an H100 inside the full-width TinyLlama-1.1B rounds
// (tools/update_variants.py, PERF.md), that cut the update group's time by
// 2-3% against the old two-wave grid stride; one wave of persistent
// blocks, more float4 in flight a thread, streaming cache hints and TMA
// bulk copies were no faster, or slower.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace float4_body {

constexpr int kThreads = 256;

// How a leaf of n elements splits: scalar elements [0, head), the body of
// nv 16-byte vectors (float4, or 8 bf16) from head, scalar elements
// [tail, n).
struct Split {
  long long head, nv, tail;
};

// The body starts where w reaches 16 bytes; it needs every operand to
// share w's misalignment (then each reaches 16 bytes at the same element).
// Otherwise the whole leaf is scalar.  elt: the element's size in bytes
// (4 for f32, 2 for bf16).
inline Split split(long long n, const void* w, const void* a, const void* b,
                   int elt = 4) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(w) & 15;
  Split s{n, 0, n};
  if (mis % elt != 0 || (reinterpret_cast<uintptr_t>(a) & 15) != mis ||
      (reinterpret_cast<uintptr_t>(b) & 15) != mis)
    return s;
  const long long per = 16 / elt;
  s.head = static_cast<long long>((16 - mis) & 15) / elt;
  if (s.head > n) s.head = n;
  s.nv = (n - s.head) / per;
  s.tail = s.head + per * s.nv;
  return s;
}

// A thread for every vector of the body and for every element of the
// longer scalar end.
inline unsigned grid(long long n, const Split& s) {
  long long work = s.head > n - s.tail ? s.head : n - s.tail;
  if (s.nv > work) work = s.nv;
  const long long blocks = (work + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

// One 16-byte vector of 8 bf16, widened to f32 exactly; the f32 results
// rounded once, to nearest even, at the store.
__device__ __forceinline__ void widen8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 narrow8(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  return u;
}

// An update kernel's element type E: get / put an element as f32, and
// load / store the i-th 16-byte vector (N elements) from p as f32.  The
// arithmetic is f32 for both; bf16 rounds once at the store.
template <class E>
struct Elt;

template <>
struct Elt<float> {
  static constexpr int N = 4;
  __device__ static __forceinline__ float get(float x) { return x; }
  __device__ static __forceinline__ float put(float x) { return x; }
  __device__ static __forceinline__ void load(const float* p, long long i,
                                              float (&f)[N]) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
  __device__ static __forceinline__ void store(float* p, long long i,
                                               const float (&f)[N]) {
    reinterpret_cast<float4*>(p)[i] = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Elt<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static __forceinline__ float get(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static __forceinline__ __nv_bfloat16 put(float x) {
    return __float2bfloat16_rn(x);
  }
  __device__ static __forceinline__ void load(const __nv_bfloat16* p,
                                              long long i, float (&f)[N]) {
    widen8(reinterpret_cast<const uint4*>(p)[i], f);
  }
  __device__ static __forceinline__ void store(__nv_bfloat16* p, long long i,
                                               const float (&f)[N]) {
    reinterpret_cast<uint4*>(p)[i] = narrow8(f);
  }
};

}  // namespace float4_body
