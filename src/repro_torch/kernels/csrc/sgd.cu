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
//
// Design: a grid-stride loop of 16-byte (float4) loads and stores when both
// pointers are 16-byte aligned, and a scalar loop for the tail or for a
// misaligned leaf.  The product and the difference round separately
// (__fmul_rn, __fsub_rn), as in the reference's p - lr * g, so the result
// is bit-exact against the plain PyTorch version w.sub_(g * lr).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float step(float w, float g, float lr) {
  return __fsub_rn(w, __fmul_rn(lr, g));
}

__global__ void sgd_inplace_kernel(float* __restrict__ w,
                                   const float* __restrict__ g, float lr,
                                   long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(g)) &
       15) == 0) {
    const long long n4 = n / 4;
    float4* w4 = reinterpret_cast<float4*>(w);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (long long i = tid; i < n4; i += stride) {
      float4 a = w4[i];
      const float4 b = g4[i];
      a.x = step(a.x, b.x, lr);
      a.y = step(a.y, b.y, lr);
      a.z = step(a.z, b.z, lr);
      a.w = step(a.w, b.w, lr);
      w4[i] = a;
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride) w[i] = step(w[i], g[i], lr);
}

}  // namespace

// w and g contiguous f32 of n elements on the device.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int sgd_inplace(float* w, const float* g, float lr, long long n,
                           void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n / 4 + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, then stride
  sgd_inplace_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(w, g, lr, n);
  return static_cast<int>(cudaGetLastError());
}
