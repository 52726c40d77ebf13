// Flash attention forward: causal or sliding-window GQA online softmax, f32.
//
// flash_attn_fwd: out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / G])
//                                 * v[b, j, h / G]
//   over the keys j that query row i sees: j <= i when causal, i - j < window
//   when window > 0 (query and key positions both start at 0).  The wrapper
//   refuses inputs with a row that sees no key (Sq >= Skv + window).
//   Replaces the TPU kernel src/repro/kernels/flash_attention.py:88
//   flash_attention (pallas_call at :106).
//
// What bounds it on an H100: operations.  At the eval shape (B = 4,
// S = 2048, H = 32, KV = 4, hd = 64, causal) each layer does
// 4 * B * H * hd * S^2 / 2 = 68.7 GFLOP (q.k and p.v, 2 flops per
// multiply-add, half the pairs visible) on 0.13 GB of q, k, v and out:
// 1.03 ms at the 67 TFLOP/s f32 peak outside the tensor cores, 0.04 ms at
// 3.35 TB/s.
//
// Design (simple and right first, not fast): one block per (batch x kv
// head, tile of query positions); each of its 128 threads owns one query
// row (position, head of the kv head's group of G), so all G query heads of
// a kv head share every K/V tile.  The block walks only the kv tiles its
// query tile can see (causal diagonal and window), staging each 64-key K
// and V tile in shared memory; that loop replaces the TPU's sequential kv
// grid axis and its VMEM scratch.  A thread keeps its q row, its
// accumulator and its running max and sum in registers, and takes 16 keys
// per online-softmax update: 16 scores, one rescale of the accumulator,
// 16 weighted V rows.  Every product is an f32 fmaf on CUDA cores (no
// tensor cores), and K/V rows are read from shared memory as broadcast
// float4s, once per query row: the shared-memory reads and the single
// FMA issue per thread are what hold it back from the bound (a redesign
// with mma/wgmma on register-blocked tiles is later work).  Masked keys
// score -1e30 like the reference's, so their weight exp(-1e30 - m) is
// exactly 0 once a row has seen one key; 16-key groups that a row cannot
// see are skipped, so a row's state only ever holds visible keys.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // query rows per block
constexpr int BKV = 64;       // keys per shared-memory tile
constexpr int SUB = 16;       // keys per online-softmax update
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, s, h;  // batch, position and head strides, in elements
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  Strides sq, Strides sk, Strides sv, Strides so, int KV,
                  int G, int Sq, int Skv, int bq, int causal, int window,
                  float scale) {
  extern __shared__ float4 smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [BKV][HD]
  float* Vs = Ks + BKV * HD;                   // [BKV][HD]
  const int tid = threadIdx.x;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int q0 = blockIdx.x * bq;
  const int qi = tid / G, g = tid % G;
  const int qpos = q0 + qi;
  const bool active = qi < bq && qpos < Sq;
  const int h = kvh * G + g;

  // keys the block's query tile can see, and those this row sees
  const int q_last = min(q0 + bq, Sq) - 1;
  const int blk_lo = window ? max(0, q0 - window + 1) : 0;
  const int blk_hi = causal ? min(Skv - 1, q_last) : Skv - 1;
  const int row_lo = window ? max(0, qpos - window + 1) : 0;
  const int row_hi = causal ? min(Skv - 1, qpos) : Skv - 1;

  float qr[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) qr[d] = acc[d] = 0.0f;
  if (active) {
    const float* qrow = q + b * sq.b + (long long)qpos * sq.s + h * sq.h;
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = qrow[d];
  }
  float m = NEG_INF, l = 0.0f;

  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
  for (int t0 = (blk_lo / BKV) * BKV; t0 <= blk_hi; t0 += BKV) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < BKV * HD; idx += THREADS) {
      const int j = idx / HD, d = idx % HD;
      const int kp = t0 + j;
      Ks[idx] = kp < Skv ? kb[(long long)kp * sk.s + d] : 0.0f;
      Vs[idx] = kp < Skv ? vb[(long long)kp * sv.s + d] : 0.0f;
    }
    __syncthreads();
    if (!active) continue;
    for (int j0 = 0; j0 < BKV; j0 += SUB) {
      const int kp0 = t0 + j0;
      // skip a group the row cannot see; otherwise it holds >= 1 visible key
      if (kp0 > row_hi || kp0 + SUB - 1 < row_lo) continue;
      float s[SUB];
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float4* kr =
            reinterpret_cast<const float4*>(Ks + (j0 + jj) * HD);
        float dot = 0.0f;
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 kk = kr[d4];
          dot = fmaf(qr[4 * d4], kk.x, dot);
          dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
          dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
          dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
        }
        const int kp = kp0 + jj;
        s[jj] = (kp >= row_lo && kp <= row_hi) ? dot * scale : NEG_INF;
        mx = fmaxf(mx, s[jj]);
      }
      const float m_new = fmaxf(m, mx);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float p = expf(s[jj] - m_new);  // exactly 0 for a masked key
        l += p;
        const float4* vr =
            reinterpret_cast<const float4*>(Vs + (j0 + jj) * HD);
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }
  if (!active) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  float* orow = out + b * so.b + (long long)qpos * so.s + h * so.h;
#pragma unroll
  for (int d = 0; d < HD; ++d) orow[d] = acc[d] * inv;
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* out,
           Strides sq, Strides sk, Strides sv, Strides so, int B, int KV,
           int G, int Sq, int Skv, int causal, int window, float scale,
           cudaStream_t s) {
  const int smem = 2 * BKV * HD * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int bq = THREADS / G;  // query positions per block
  const dim3 grid((Sq + bq - 1) / bq, B * KV);
  flash_attn_kernel<HD><<<grid, THREADS, smem, s>>>(
      q, k, v, out, sq, sk, sv, so, KV, G, Sq, Skv, bq, causal, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Sq, H, hd], k and v [B, Skv, KV, hd], out [B, Sq, H, hd], each with
// unit stride along hd and the given batch / position / head strides (in
// elements); H = KV * G with G <= 128; hd one of 8, 16, 32, 64, 128.
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attn_fwd(const float* q, const float* k, const float* v,
                              float* out, long long sq_b, long long sq_s,
                              long long sq_h, long long sk_b, long long sk_s,
                              long long sk_h, long long sv_b, long long sv_s,
                              long long sv_h, long long so_b, long long so_s,
                              long long so_h, int B, int KV, int G, int Sq,
                              int Skv, int hd, int causal, int window,
                              float scale, void* stream) {
  if (G < 1 || G > THREADS || B < 1 || KV < 1 || Sq < 1 || Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sq_b, sq_s, sq_h}, sk{sk_b, sk_s, sk_h},
      sv{sv_b, sv_s, sv_h}, so{so_b, so_s, so_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8:
      return launch<8>(q, k, v, out, sq, sk, sv, so, B, KV, G, Sq, Skv,
                       causal, window, scale, s);
    case 16:
      return launch<16>(q, k, v, out, sq, sk, sv, so, B, KV, G, Sq, Skv,
                        causal, window, scale, s);
    case 32:
      return launch<32>(q, k, v, out, sq, sk, sv, so, B, KV, G, Sq, Skv,
                        causal, window, scale, s);
    case 64:
      return launch<64>(q, k, v, out, sq, sk, sv, so, B, KV, G, Sq, Skv,
                        causal, window, scale, s);
    case 128:
      return launch<128>(q, k, v, out, sq, sk, sv, so, B, KV, G, Sq, Skv,
                         causal, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
