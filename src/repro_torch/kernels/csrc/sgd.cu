// In-place client SGD step, f32: w <- w - lr * g over one contiguous leaf.
//
// Replaces the TPU kernel src/repro/kernels/masked_update.py:53 sgd_2d
// (pallas_call at :60).  The TPU version works on a [rows, 1024] padded
// layout (kernels/ops.py:26 _to_2d) that exists for the TPU's (8, 128)
// tiling; here any length works and nothing is padded or copied.
//
// What bounds it on an H100: memory.  Each element reads w and g and writes
// w back, 12 bytes for 2 flops; the full-width TinyLlama-1.1B round updates
// 4 clients x 1.1 G parameters per local step, 52.8 GB, 15.8 ms at 3.35 TB/s.
// Every byte is touched once, and one [4, 2048, 5632] leaf streams 554 MB
// through a 50 MB L2.
//
// Design (float4_body.cuh): one float4 of w and g a thread, one block for
// every 256 float4 and no grid stride, plain loads and stores.  A leaf
// whose w and g share a misalignment runs a scalar head up to the 16-byte
// boundary, then the float4 body; only mismatched misalignments go wholly
// scalar.  The product and the difference round separately (__fmul_rn,
// __fsub_rn), as in the reference's p - lr * g, so the result is bit-exact
// against the plain PyTorch version w.sub_(g * lr).  w and g are
// __restrict__: the wrapper refuses a g that overlaps w.
#include "float4_body.cuh"

namespace {

using float4_body::kThreads;

__device__ __forceinline__ float step(float w, float g, float lr) {
  return __fsub_rn(w, __fmul_rn(lr, g));
}

__global__ void __launch_bounds__(kThreads)
    sgd_inplace_kernel(float* __restrict__ w, const float* __restrict__ g,
                       float lr, long long n, float4_body::Split s) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < s.head) w[i] = step(w[i], g[i], lr);
  if (s.tail + i < n) w[s.tail + i] = step(w[s.tail + i], g[s.tail + i], lr);
  if (i < s.n4) {
    float4* w4 = reinterpret_cast<float4*>(w + s.head);
    float4 a = w4[i];
    const float4 b = reinterpret_cast<const float4*>(g + s.head)[i];
    a.x = step(a.x, b.x, lr);
    a.y = step(a.y, b.y, lr);
    a.z = step(a.z, b.z, lr);
    a.w = step(a.w, b.w, lr);
    w4[i] = a;
  }
}

}  // namespace

// w and g contiguous f32 of n elements on the device.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int sgd_inplace(float* w, const float* g, float lr, long long n,
                           void* stream) {
  if (n <= 0) return 0;
  const float4_body::Split s = float4_body::split(n, w, g, g);
  sgd_inplace_kernel<<<float4_body::grid(n, s), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(w, g, lr, n, s);
  return static_cast<int>(cudaGetLastError());
}
