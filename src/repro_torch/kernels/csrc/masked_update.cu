// Mask-mode updates, f32, in place: the masked client SGD step and the
// server's fill-in average.
//
// masked_sgd_inplace replaces the TPU kernel
// src/repro/kernels/masked_update.py:33 masked_sgd_2d (pallas_call at :38):
//   w <- w - (lr * m) * g
// fillin_agg_inplace replaces src/repro/kernels/masked_update.py:79
// fillin_agg_2d (pallas_call at :87):
//   w <- w + scale * sum_c m_c * (w_c - w),   scale = server_lr / C.
// The TPU versions work on a [rows, 1024] padded layout (kernels/ops.py:26
// _to_2d) that exists for the TPU's (8, 128) tiling; here any length works
// and nothing is padded or copied.
//
// What bounds them on an H100: memory.  masked_sgd reads w, m and g and
// writes w, 16 bytes for 3 flops per element; the full-width
// TinyLlama-1.1B mask round updates 4 clients x 1.1 G parameters per local
// step, 70.4 GB, 21.0 ms at 3.35 TB/s.  fillin reads w and C pairs
// (w_c, m_c) and writes w, (8 + 8C) bytes per element; 44.0 GB per round
// at C = 4, 13.1 ms.
//
// Design of masked_sgd (float4_body.cuh, as sgd.cu): one float4 of w, m
// and g a thread, one block for every 256 float4 and no grid stride, plain
// loads and stores.  A leaf whose operands share one misalignment runs a
// scalar head up to the 16-byte boundary, then the float4 body; only
// mismatched misalignments go wholly scalar.
//
// Design of fillin: a grid-stride loop of 16-byte (float4) loads and
// stores when every pointer (and the client stride) is 16-byte aligned,
// and a scalar loop for the tail or for a misaligned leaf, on a grid of up
// to 16 blocks of 256 per SM of the 132-SM part.  Each thread walks the
// clients in order for its elements, so the sum over clients stays in
// registers and w is read and written once.
//
// Every product, sum and difference is written with a _rn intrinsic, so
// nvcc cannot contract them into FMAs: the results are bit-exact against
// the plain PyTorch versions (kernels/ref.py masked_sgd_ref,
// fillin_agg_ref).
#include <cuda_runtime.h>

#include <cstdint>

#include "float4_body.cuh"

namespace {

using float4_body::kThreads;
constexpr long long kMaxBlocks = 132 * 16;  // fillin: 16 blocks per SM

__device__ __forceinline__ float masked_step(float w, float m, float g,
                                             float lr) {
  return __fsub_rn(w, __fmul_rn(__fmul_rn(lr, m), g));
}

__device__ __forceinline__ float fill_term(float acc, float w, float wc,
                                           float mc) {
  return __fadd_rn(acc, __fmul_rn(mc, __fsub_rn(wc, w)));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(kThreads)
    masked_sgd_kernel(float* __restrict__ w, const float* __restrict__ m,
                      const float* __restrict__ g, float lr, long long n,
                      float4_body::Split s) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < s.head) w[i] = masked_step(w[i], m[i], g[i], lr);
  if (s.tail + i < n) {
    const long long t = s.tail + i;
    w[t] = masked_step(w[t], m[t], g[t], lr);
  }
  if (i < s.n4) {
    float4* w4 = reinterpret_cast<float4*>(w + s.head);
    float4 a = w4[i];
    const float4 b = reinterpret_cast<const float4*>(m + s.head)[i];
    const float4 c = reinterpret_cast<const float4*>(g + s.head)[i];
    a.x = masked_step(a.x, b.x, c.x, lr);
    a.y = masked_step(a.y, b.y, c.y, lr);
    a.z = masked_step(a.z, b.z, c.z, lr);
    a.w = masked_step(a.w, b.w, c.w, lr);
    w4[i] = a;
  }
}

// wc and mc hold client c's leaf at wc + c * cstride (elements).
__global__ void fillin_agg_kernel(float* __restrict__ w,
                                  const float* __restrict__ wc,
                                  const float* __restrict__ mc, float scale,
                                  long long n, int clients,
                                  long long cstride) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (aligned16(w) && aligned16(wc) && aligned16(mc) && cstride % 4 == 0) {
    const long long n4 = n / 4;
    float4* w4 = reinterpret_cast<float4*>(w);
    for (long long i = tid; i < n4; i += stride) {
      float4 a = w4[i];
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c = 0; c < clients; ++c) {
        const float4 x = reinterpret_cast<const float4*>(wc + c * cstride)[i];
        const float4 k = reinterpret_cast<const float4*>(mc + c * cstride)[i];
        acc.x = fill_term(acc.x, a.x, x.x, k.x);
        acc.y = fill_term(acc.y, a.y, x.y, k.y);
        acc.z = fill_term(acc.z, a.z, x.z, k.z);
        acc.w = fill_term(acc.w, a.w, x.w, k.w);
      }
      a.x = __fadd_rn(a.x, __fmul_rn(scale, acc.x));
      a.y = __fadd_rn(a.y, __fmul_rn(scale, acc.y));
      a.z = __fadd_rn(a.z, __fmul_rn(scale, acc.z));
      a.w = __fadd_rn(a.w, __fmul_rn(scale, acc.w));
      w4[i] = a;
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride) {
    const float a = w[i];
    float acc = 0.f;
    for (int c = 0; c < clients; ++c)
      acc = fill_term(acc, a, wc[c * cstride + i], mc[c * cstride + i]);
    w[i] = __fadd_rn(a, __fmul_rn(scale, acc));
  }
}

unsigned grid_for(long long n) {
  long long blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

}  // namespace

// w, m and g contiguous f32 of n elements on the device.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int masked_sgd_inplace(float* w, const float* m, const float* g,
                                  float lr, long long n, void* stream) {
  if (n <= 0) return 0;
  const float4_body::Split s = float4_body::split(n, w, m, g);
  masked_sgd_kernel<<<float4_body::grid(n, s), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(w, m, g, lr, n,
                                                           s);
  return static_cast<int>(cudaGetLastError());
}

// w: the server leaf, n contiguous f32, updated in place.  wc, mc: the
// clients' leaves and masks, client c at wc + c * cstride.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int fillin_agg_inplace(float* w, const float* wc, const float* mc,
                                  float scale, long long n, int clients,
                                  long long cstride, void* stream) {
  if (n <= 0) return 0;
  fillin_agg_kernel<<<grid_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      w, wc, mc, scale, n, clients, cstride);
  return static_cast<int>(cudaGetLastError());
}
