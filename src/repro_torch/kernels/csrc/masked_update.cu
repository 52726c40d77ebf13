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
// Design of masked_sgd (float4_body.cuh, as sgd.cu; one kernel for both
// arms): one float4 of w, m and g a thread, one block for every 256 float4 and no grid stride, plain
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
//
// The bf16 arms (masked_sgd_inplace_bf16, fillin_agg_inplace_bf16) are the
// Pallas bodies at bf16, as the reference runs them on bf16 params (w, m,
// g and the clients' leaves and masks all in w's dtype, kernels/ops.py:54,
// 69-70): every operand read as bf16, 8 a 16-byte load, widened to f32;
// the same f32 operations in the same order as the f32 arms; one rounding
// to bf16 at the store.  Half the f32 arms' bytes.  Both take the
// float4_body grid (a thread for each 16-byte vector of w, walking the
// clients in order for the fill-in), with scalar ends, and a wholly scalar
// leaf where the operands' misalignments differ.
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

// One kernel for both arms (E float or bf16, float4_body::Elt).
template <class E>
__global__ void __launch_bounds__(kThreads)
    masked_sgd_kernel(E* __restrict__ w, const E* __restrict__ m,
                      const E* __restrict__ g, float lr, long long n,
                      float4_body::Split s) {
  using V = float4_body::Elt<E>;
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < s.head)
    w[i] = V::put(masked_step(V::get(w[i]), V::get(m[i]), V::get(g[i]), lr));
  if (s.tail + i < n) {
    const long long t = s.tail + i;
    w[t] = V::put(masked_step(V::get(w[t]), V::get(m[t]), V::get(g[t]), lr));
  }
  if (i < s.nv) {
    float a[V::N], b[V::N], c[V::N];
    V::load(w + s.head, i, a);
    V::load(m + s.head, i, b);
    V::load(g + s.head, i, c);
#pragma unroll
    for (int k = 0; k < V::N; ++k) a[k] = masked_step(a[k], b[k], c[k], lr);
    V::store(w + s.head, i, a);
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

// The bf16 fill-in on the float4_body grid: a thread for each 16-byte
// vector of w (and each element of the scalar ends), walking the clients
// in order; wc and mc hold client c's leaf at wc + c * cstride (elements).
__global__ void __launch_bounds__(kThreads)
    fillin_agg_bf16_kernel(__nv_bfloat16* __restrict__ w,
                           const __nv_bfloat16* __restrict__ wc,
                           const __nv_bfloat16* __restrict__ mc, float scale,
                           long long n, int clients, long long cstride,
                           float4_body::Split s) {
  using V = float4_body::Elt<__nv_bfloat16>;
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const auto one = [&](long long t) {
    const float a = V::get(w[t]);
    float acc = 0.f;
    for (int c = 0; c < clients; ++c)
      acc = fill_term(acc, a, V::get(wc[c * cstride + t]),
                      V::get(mc[c * cstride + t]));
    w[t] = V::put(__fadd_rn(a, __fmul_rn(scale, acc)));
  };
  if (i < s.head) one(i);
  if (s.tail + i < n) one(s.tail + i);
  if (i < s.nv) {
    float a[V::N], acc[V::N] = {};
    V::load(w + s.head, i, a);
    for (int c = 0; c < clients; ++c) {
      float x[V::N], k[V::N];
      V::load(wc + c * cstride + s.head, i, x);
      V::load(mc + c * cstride + s.head, i, k);
#pragma unroll
      for (int e = 0; e < V::N; ++e)
        acc[e] = fill_term(acc[e], a[e], x[e], k[e]);
    }
#pragma unroll
    for (int e = 0; e < V::N; ++e)
      a[e] = __fadd_rn(a[e], __fmul_rn(scale, acc[e]));
    V::store(w + s.head, i, a);
  }
}

unsigned grid_for(long long n) {
  long long blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

template <class E>
int masked_sgd_launch(E* w, const E* m, const E* g, float lr, long long n,
                      void* stream) {
  if (n <= 0) return 0;
  const float4_body::Split s = float4_body::split(n, w, m, g, sizeof(E));
  masked_sgd_kernel<E><<<float4_body::grid(n, s), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(w, m, g, lr, n,
                                                              s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w, m and g contiguous f32 of n elements on the device.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int masked_sgd_inplace(float* w, const float* m, const float* g,
                                  float lr, long long n, void* stream) {
  return masked_sgd_launch(w, m, g, lr, n, stream);
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

// w, m and g contiguous bf16 of n elements on the device.
extern "C" int masked_sgd_inplace_bf16(__nv_bfloat16* w,
                                       const __nv_bfloat16* m,
                                       const __nv_bfloat16* g, float lr,
                                       long long n, void* stream) {
  return masked_sgd_launch(w, m, g, lr, n, stream);
}

// As fillin_agg_inplace, every operand bf16.  The vector body needs the
// client stride to keep every client's leaf at w's misalignment (a
// multiple of 8 elements); otherwise the leaf is scalar.
extern "C" int fillin_agg_inplace_bf16(__nv_bfloat16* w,
                                       const __nv_bfloat16* wc,
                                       const __nv_bfloat16* mc, float scale,
                                       long long n, int clients,
                                       long long cstride, void* stream) {
  if (n <= 0) return 0;
  float4_body::Split s = float4_body::split(n, w, wc, mc, 2);
  if (cstride % 8 != 0) s = float4_body::Split{n, 0, n};
  fillin_agg_bf16_kernel<<<float4_body::grid(n, s), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      w, wc, mc, scale, n, clients, cstride, s);
  return static_cast<int>(cudaGetLastError());
}
