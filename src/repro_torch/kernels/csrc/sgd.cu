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
//
// The bf16 arm (sgd_inplace_bf16) is the Pallas body at bf16, the same
// kernel on bf16 elements: w and g are read as bf16 (one 16-byte load of 8
// each a thread), widened to f32, the step taken in the f32 arm's order (no
// FMA contraction), and the result rounded once to bf16 at the store.  Half the f32 arm's bytes; bit-exact
// against the plain version (w.float() - g.float() * lr).to(bf16).
#include "float4_body.cuh"

namespace {

using float4_body::kThreads;

__device__ __forceinline__ float step(float w, float g, float lr) {
  return __fsub_rn(w, __fmul_rn(lr, g));
}

// One kernel for both arms (E float or bf16, float4_body::Elt).
template <class E>
__global__ void __launch_bounds__(kThreads)
    sgd_inplace_kernel(E* __restrict__ w, const E* __restrict__ g, float lr,
                       long long n, float4_body::Split s) {
  using V = float4_body::Elt<E>;
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < s.head) w[i] = V::put(step(V::get(w[i]), V::get(g[i]), lr));
  if (s.tail + i < n) {
    const long long t = s.tail + i;
    w[t] = V::put(step(V::get(w[t]), V::get(g[t]), lr));
  }
  if (i < s.nv) {
    float a[V::N], b[V::N];
    V::load(w + s.head, i, a);
    V::load(g + s.head, i, b);
#pragma unroll
    for (int k = 0; k < V::N; ++k) a[k] = step(a[k], b[k], lr);
    V::store(w + s.head, i, a);
  }
}

template <class E>
int sgd_launch(E* w, const E* g, float lr, long long n, void* stream) {
  if (n <= 0) return 0;
  const float4_body::Split s = float4_body::split(n, w, g, g, sizeof(E));
  sgd_inplace_kernel<E><<<float4_body::grid(n, s), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(w, g, lr, n,
                                                               s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w and g contiguous f32 of n elements on the device.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int sgd_inplace(float* w, const float* g, float lr, long long n,
                           void* stream) {
  return sgd_launch(w, g, lr, n, stream);
}

// w and g contiguous bf16 of n elements on the device.
extern "C" int sgd_inplace_bf16(__nv_bfloat16* w, const __nv_bfloat16* g,
                                float lr, long long n, void* stream) {
  return sgd_launch(w, g, lr, n, stream);
}
