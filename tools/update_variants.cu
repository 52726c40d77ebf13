// Design variants of the in-place update kernels (the client SGD step,
// w <- w - lr * g, and the masked step, w <- w - (lr * m) * g), timed side
// by side on one card by tools/update_variants.py.  They are not part of
// the port: the kernels the port runs are
// src/repro_torch/kernels/csrc/sgd.cu and masked_update.cu.
//
// Every register variant has 256 threads a block and walks tiles of U x 256
// float4 (thread t takes float4 t, t + 256, ... of a tile, all loads of a
// tile before any store) over a 16-byte aligned leaf whose length is a
// multiple of 4.  They differ in:
//   U     float4 of each operand a thread has in flight (1, 2, 4, 8);
//   hint  0: plain ld/st; 1: w ld.global.cs, g and m
//         ld.global.nc.L1::no_allocate, st.global.cs;
//   grid  0: the old grid, min(n / 1024, 132 x 16) blocks, two waves deep
//         at the w_gate leaf; 1: one wave, the device's SM count times the
//         blocks of this variant one SM holds; -1: one block for every
//         tile (no grid stride).
// update_bulk is the TMA route instead (bulk_kernel below).
// U = 1, hint 0 is the port's body: with grid 0 before its redesign, with
// grid -1 after it.  The arithmetic is the port's (__fmul_rn, __fsub_rn),
// bit-exact against the plain versions.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <int hint>
__device__ __forceinline__ float4 load_w(const float4* p) {
  if constexpr (hint == 0) return *p;
  return __ldcs(p);
}

template <int hint>
__device__ __forceinline__ float4 load_ro(const float4* p) {
  if constexpr (hint == 0) return *p;
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

template <int hint>
__device__ __forceinline__ void store(float4* p, float4 v) {
  if constexpr (hint == 0) {
    *p = v;
  } else {
    __stcs(p, v);
  }
}

__device__ __forceinline__ float masked_step(float w, float m, float g,
                                             float lr) {
  return __fsub_rn(w, __fmul_rn(__fmul_rn(lr, m), g));
}

__device__ __forceinline__ float sgd_step(float w, float g, float lr) {
  return __fsub_rn(w, __fmul_rn(lr, g));
}

template <int U, int hint, bool masked>
__global__ void __launch_bounds__(kThreads)
    variant_kernel(float4* __restrict__ w, const float4* __restrict__ m,
                   const float4* __restrict__ g, float lr, long long n4) {
  const long long tile = static_cast<long long>(U) * kThreads;
  const long long tiles = (n4 + tile - 1) / tile;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    float4 a[U], b[U], c[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long long i = t * tile + j * kThreads + threadIdx.x;
      if (i < n4) {
        a[j] = load_w<hint>(w + i);
        c[j] = load_ro<hint>(g + i);
        if (masked) b[j] = load_ro<hint>(m + i);
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long long i = t * tile + j * kThreads + threadIdx.x;
      if (i < n4) {
        float4 r;
        if (masked) {
          r = make_float4(masked_step(a[j].x, b[j].x, c[j].x, lr),
                          masked_step(a[j].y, b[j].y, c[j].y, lr),
                          masked_step(a[j].z, b[j].z, c[j].z, lr),
                          masked_step(a[j].w, b[j].w, c[j].w, lr));
        } else {
          r = make_float4(sgd_step(a[j].x, c[j].x, lr),
                          sgd_step(a[j].y, c[j].y, lr),
                          sgd_step(a[j].z, c[j].z, lr),
                          sgd_step(a[j].w, c[j].w, lr));
        }
        store<hint>(w + i, r);
      }
    }
  }
}

template <int U, int hint, bool masked>
int launch(int grid_mode, float* w, const float* m, const float* g, float lr,
           long long n, cudaStream_t stream) {
  auto kernel = variant_kernel<U, hint, masked>;
  const long long n4 = n / 4;
  const long long tiles = (n4 + U * kThreads - 1) / (U * kThreads);
  long long blocks = tiles;
  if (grid_mode == 0) {
    blocks = (n4 + kThreads - 1) / kThreads;
    if (blocks > 132 * 16) blocks = 132 * 16;
  } else if (grid_mode == 1) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    blocks = static_cast<long long>(sms) * per_sm;
    if (blocks > tiles) blocks = tiles;
  }
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      reinterpret_cast<float4*>(w), reinterpret_cast<const float4*>(m),
      reinterpret_cast<const float4*>(g), lr, n4);
  return static_cast<int>(cudaGetLastError());
}

template <bool masked>
int dispatch(int U, int hint, int grid_mode, float* w, const float* m,
             const float* g, float lr, long long n, cudaStream_t s) {
#define VARIANT(u, h)     \
  if (U == u && hint == h) \
    return launch<u, h, masked>(grid_mode, w, m, g, lr, n, s);
  VARIANT(1, 0) VARIANT(1, 1) VARIANT(2, 0) VARIANT(2, 1)
  VARIANT(4, 0) VARIANT(4, 1) VARIANT(8, 0) VARIANT(8, 1)
#undef VARIANT
  return -1;
}

// -- the TMA route: 1-D bulk copies through a ring of shared memory -------
//
// One block of 256 threads on each SM walks chunks of kBulkFloats floats of
// every operand (chunk blockIdx.x, then every gridDim.x-th).  Thread 0
// loads a chunk's operands with cp.async.bulk into a stage of the ring,
// completing on the stage's mbarrier; every thread waits on it, updates w
// in shared memory, and thread 0 stores w back with a bulk copy, waits for
// that copy to have read the stage, and reloads the stage with the chunk
// ``stages`` ahead.
constexpr int kBulkFloats = 4096;  // 16 KB of each operand a stage

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@p bra DONE;\n\t"
      "bra WAIT;\n\t"
      "DONE:\n\t}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

template <int stages, bool masked>
__global__ void __launch_bounds__(256)
    bulk_kernel(float* __restrict__ w, const float* __restrict__ m,
                const float* __restrict__ g, float lr, long long chunks) {
  constexpr int ops = masked ? 3 : 2;
  constexpr uint32_t bytes = kBulkFloats * sizeof(float);
  extern __shared__ __align__(128) float ring[];  // [stages][ops][chunk]
  __shared__ __align__(8) uint64_t full[stages];
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       smem_addr(&full[s])),
                   "r"(1)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const long long mine =
      chunks > blockIdx.x ? (chunks - blockIdx.x + gridDim.x - 1) / gridDim.x
                          : 0;
  auto stage = [&](long long k, int op) {
    return ring + ((k % stages) * ops + op) * kBulkFloats;
  };
  auto offset = [&](long long k) {
    return (blockIdx.x + k * gridDim.x) * kBulkFloats;
  };
  auto load_stage = [&](long long k) {
    uint64_t* bar = &full[k % stages];
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
            smem_addr(bar)),
        "r"(ops * bytes)
        : "memory");
    bulk_load(stage(k, 0), w + offset(k), bytes, bar);
    bulk_load(stage(k, 1), g + offset(k), bytes, bar);
    if (masked) bulk_load(stage(k, 2), m + offset(k), bytes, bar);
  };
  if (tid == 0)
    for (long long k = 0; k < stages && k < mine; ++k) load_stage(k);
  for (long long k = 0; k < mine; ++k) {
    mbar_wait(&full[k % stages], static_cast<uint32_t>((k / stages) & 1));
    float4* a = reinterpret_cast<float4*>(stage(k, 0));
    const float4* c = reinterpret_cast<const float4*>(stage(k, 1));
    const float4* b =
        reinterpret_cast<const float4*>(stage(k, masked ? 2 : 1));
    for (int i = tid; i < kBulkFloats / 4; i += 256) {
      float4 r = a[i];
      if (masked) {
        r.x = masked_step(r.x, b[i].x, c[i].x, lr);
        r.y = masked_step(r.y, b[i].y, c[i].y, lr);
        r.z = masked_step(r.z, b[i].z, c[i].z, lr);
        r.w = masked_step(r.w, b[i].w, c[i].w, lr);
      } else {
        r.x = sgd_step(r.x, c[i].x, lr);
        r.y = sgd_step(r.y, c[i].y, lr);
        r.z = sgd_step(r.z, c[i].z, lr);
        r.w = sgd_step(r.w, c[i].w, lr);
      }
      a[i] = r;
    }
    // the bulk store reads the stage through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
              w + offset(k)),
          "r"(smem_addr(stage(k, 0))), "r"(bytes)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      if (k + stages < mine) {
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        load_stage(k + stages);
      }
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int stages, bool masked>
int bulk_launch(float* w, const float* m, const float* g, float lr,
                long long n, cudaStream_t stream) {
  if (n % kBulkFloats) return -1;
  auto kernel = bulk_kernel<stages, masked>;
  const int smem = stages * (masked ? 3 : 2) * kBulkFloats * sizeof(float);
  int err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long chunks = n / kBulkFloats;
  const long long blocks = chunks < sms ? chunks : sms;
  kernel<<<static_cast<unsigned>(blocks), 256, smem, stream>>>(w, m, g, lr,
                                                               chunks);
  return static_cast<int>(cudaGetLastError());
}


}  // namespace

// masked = 0: w <- w - lr * g (m unused); 1: w <- w - (lr * m) * g.  w, m
// and g 16-byte aligned, n a multiple of 4.  Returns the launch's CUDA
// error, or -1 for a variant that does not exist.
extern "C" int update_variant(int masked, int U, int hint, int grid_mode,
                              float* w, const float* m, const float* g,
                              float lr, long long n, void* stream) {
  if (n <= 0 || n % 4 || (grid_mode < -1 || grid_mode > 1)) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  return masked ? dispatch<true>(U, hint, grid_mode, w, m, g, lr, n, s)
                : dispatch<false>(U, hint, grid_mode, w, m, g, lr, n, s);
}

// The TMA route with 2 or 4 stages; n a multiple of 4096.
extern "C" int update_bulk(int masked, int stages, float* w, const float* m,
                           const float* g, float lr, long long n,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (stages == 2)
    return masked ? bulk_launch<2, true>(w, m, g, lr, n, s)
                  : bulk_launch<2, false>(w, m, g, lr, n, s);
  if (stages == 4)
    return masked ? bulk_launch<4, true>(w, m, g, lr, n, s)
                  : bulk_launch<4, false>(w, m, g, lr, n, s);
  return -1;
}
