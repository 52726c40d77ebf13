// The intra-chunk block of Mamba-2's SSD mixer, f32.
//
// ssd_chunk_intra_fwd: for every (batch b, chunk c, head h of the window),
// with dA = dt * A[h] and L = cumsum(dA) (inclusive) over the chunk's Q
// positions,
//   y[q, p]    = sum_{t <= q} ((C_q . B_t) * exp(L_q - L_t)) * dt_t * x[t, p]
//   S[p, n]    = sum_t exp(L_{Q-1} - L_t) * dt_t * x[t, p] * B[t, n]
// (the quadratic intra-chunk term and the chunk-exit state of the SSD block
// decomposition).  Replaces the TPU kernel src/repro/kernels/ssd_chunk.py:58
// ssd_chunk_intra (pallas_call at :84; its head-window variant
// _ssd_chunk_kernel_offset, :51, pallas_call at :125).  The inter-chunk
// recurrence stays in plain PyTorch (kernels/ssd_chunk.py ssd_chunk_scan).
//
// What bounds it on an H100: operations.  At one Mamba2-130M prefill layer
// (8 x 32768 tokens: Bt 8, nc 128, Q 256, nh 24, hd 64, N 128) the work the
// data needs is C B^T once per chunk over the causal pairs (Q(Q+1)/2 * N
// multiply-adds, 8.6 GFLOP in all; ngroups = 1, so it does not depend on the
// head), M x per head over the same pairs (103 GFLOP) and the state per head
// (Q * hd * N, 103 GFLOP): 0.215 TFLOP, 3.2 ms at the 67 TFLOP/s f32 peak
// outside the tensor cores, against 4.4 GB of x, dt, B, C, y and states
// (1.3 ms at 3.35 TB/s).  This kernel recomputes C B^T for every head, as the
// Pallas body does per head block: 64-row tiles over every causal tile pair
// (10 of 16 at Q = 256) make that 16.8 MFLOP per (chunk, head), 4x the M x
// work, so it executes about 0.62 TFLOP for the 0.215 the bound counts.
//
// Design (simple and right first, not fast): one block of 256 threads per
// (batch, chunk, head).  A Q x Q f32 tile of C B^T (256 KB at Q = 256) does
// not fit in shared memory, so the block walks 64-row query tiles and, for
// each, the 64-row key tiles t0 <= q: C's query tile and B's key tile are
// staged transposed in shared memory (n-major, so a thread reads four
// neighbouring rows as one float4), each thread forms a 4 x 4 block of
// C B^T by f32 fmaf over n, applies the causal mask before the exponential
// (t > q never forms exp(L_q - L_t), which overflows), and the masked M tile
// goes back to shared memory for the 64 x hd product with x's key tile.  L
// is summed once per block in shared memory, sequentially, with dt * A
// rounded before each add (the body's cumsum of dA), and every weight is a
// difference of L, never a sum over (t, q].  Then the state: the block
// walks all key tiles again with B row-major and x scaled by its decay.
// No tensor cores and no pipelining; the C B^T recomputation and the
// shared-memory reads of the 4 x 4 blocks are what hold it back (a redesign
// with one C B^T per chunk shared across heads and mma tiles is later work).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16: (ty, tx)
constexpr int TQ = 64;        // query rows per tile
constexpr int TT = 64;        // key rows per tile
constexpr int NMAX = 128;     // largest d_state
constexpr int QMAX = 256;     // largest chunk
constexpr int PAD = TQ + 4;   // row stride of the transposed tiles

struct Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  float* y;
  float* states;
  long long sx_b, sx_c, sx_q, sx_h;  // x strides, unit along hd
  long long sd_b, sd_c, sd_q, sd_h;  // dt strides
  long long sb_b, sb_c, sb_q;        // B strides, unit along N
  long long sc_b, sc_c, sc_q;        // C strides, unit along N
  int nc, Q, N, win, head_offset;
};

constexpr int smem_floats(int hd) {
  return 2 * QMAX + 2 * NMAX * PAD + TT * hd + TT * PAD;
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 2) ssd_chunk_kernel(Args a) {
  constexpr int PW = HD / 16;  // hd columns per thread
  constexpr int NJ = NMAX / 16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Ls = smem;               // [QMAX]
  float* dts = Ls + QMAX;         // [QMAX]
  float* CsT = dts + QMAX;        // [NMAX][PAD]: C[q0 + qi, n] at n * PAD + qi
  float* BsT = CsT + NMAX * PAD;  // [NMAX][PAD]: B[t0 + ti, n] at n * PAD + ti
  float* Xs = BsT + NMAX * PAD;   // [TT][HD]
  float* MsT = Xs + TT * HD;      // [TT][PAD]: M[qi, ti] at ti * PAD + qi
  float* Bs = CsT;                // state pass: [TT][N] row-major

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int Q = a.Q, N = a.N;
  const long long blk = blockIdx.x;
  const int hr = static_cast<int>(blk % a.win);
  const int c = static_cast<int>((blk / a.win) % a.nc);
  const long long b = blk / (static_cast<long long>(a.win) * a.nc);
  const int h = a.head_offset + hr;

  const float* xp = a.x + b * a.sx_b + c * a.sx_c + h * a.sx_h;
  const float* dtp = a.dt + b * a.sd_b + c * a.sd_c + h * a.sd_h;
  const float* Bp = a.B + b * a.sb_b + c * a.sb_c;
  const float* Cp = a.C + b * a.sc_b + c * a.sc_c;

  for (int q = tid; q < Q; q += THREADS) dts[q] = dtp[q * a.sd_q];
  __syncthreads();
  if (tid == 0) {
    const float Ah = a.A[h];
    float acc = 0.0f;
    for (int q = 0; q < Q; ++q) {
      acc = __fadd_rn(acc, __fmul_rn(dts[q], Ah));  // no contraction
      Ls[q] = acc;
    }
  }

  // ---- y: query tiles, each against the key tiles t0 <= its last row ----
  const long long y_row = static_cast<long long>(a.win) * HD;
  float* yp = a.y + ((b * a.nc + c) * Q) * y_row + hr * HD;
  for (int q0 = 0; q0 < Q; q0 += TQ) {
    __syncthreads();  // the previous tile's C is no longer read
    for (int idx = tid; idx < TQ * N; idx += THREADS) {
      const int qi = idx / N, n = idx % N;
      CsT[n * PAD + qi] = q0 + qi < Q ? Cp[(q0 + qi) * a.sc_q + n] : 0.0f;
    }
    float acc[4][PW];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < PW; ++k) acc[i][k] = 0.0f;
    const int t_end = min(q0 + TQ, Q);
    for (int t0 = 0; t0 < t_end; t0 += TT) {
      __syncthreads();  // the previous key tile and M tile are no longer read
      for (int idx = tid; idx < TT * N; idx += THREADS) {
        const int ti = idx / N, n = idx % N;
        BsT[n * PAD + ti] = t0 + ti < Q ? Bp[(t0 + ti) * a.sb_q + n] : 0.0f;
      }
      for (int idx = tid; idx < TT * HD; idx += THREADS) {
        const int ti = idx / HD, p = idx % HD;
        Xs[idx] = t0 + ti < Q ? xp[(t0 + ti) * a.sx_q + p] : 0.0f;
      }
      __syncthreads();
      float cb[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cb[i][j] = 0.0f;
      for (int n = 0; n < N; ++n) {
        const float4 cv =
            *reinterpret_cast<const float4*>(CsT + n * PAD + ty * 4);
        const float4 bv =
            *reinterpret_cast<const float4*>(BsT + n * PAD + tx * 4);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cb[i][j] = fmaf(cr[i], br[j], cb[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + tx * 4 + j;
        float m[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + ty * 4 + i;
          m[i] = 0.0f;
          if (t <= q && q < Q) {  // the mask before the exponential
            const float decay = expf(Ls[q] - Ls[t]);
            m[i] = __fmul_rn(__fmul_rn(cb[i][j], decay), dts[t]);
          }
        }
        *reinterpret_cast<float4*>(MsT + (tx * 4 + j) * PAD + ty * 4) =
            make_float4(m[0], m[1], m[2], m[3]);
      }
      __syncthreads();
      const int nt = min(TT, Q - t0);
      for (int ti = 0; ti < nt; ++ti) {
        const float4 mv =
            *reinterpret_cast<const float4*>(MsT + ti * PAD + ty * 4);
        const float mr[4] = {mv.x, mv.y, mv.z, mv.w};
        float xv[PW];
#pragma unroll
        for (int k = 0; k < PW; ++k) xv[k] = Xs[ti * HD + tx * PW + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < PW; ++k)
            acc[i][k] = fmaf(mr[i], xv[k], acc[i][k]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + ty * 4 + i;
      if (q >= Q) continue;
#pragma unroll
      for (int k = 0; k < PW; ++k) yp[q * y_row + tx * PW + k] = acc[i][k];
    }
  }

  // ---- the chunk-exit state: S[p, n] over all Q positions ----
  float s[PW][NJ];
#pragma unroll
  for (int i = 0; i < PW; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = 0.0f;
  for (int t0 = 0; t0 < Q; t0 += TT) {
    __syncthreads();  // the y pass (or the previous tile) is done with smem
    const int nt = min(TT, Q - t0);
    for (int idx = tid; idx < nt * N; idx += THREADS) {
      const int ti = idx / N, n = idx % N;
      Bs[idx] = Bp[(t0 + ti) * a.sb_q + n];
    }
    for (int idx = tid; idx < nt * HD; idx += THREADS) {
      const int ti = idx / HD, p = idx % HD;
      const int t = t0 + ti;
      const float w = __fmul_rn(expf(Ls[Q - 1] - Ls[t]), dts[t]);
      Xs[idx] = __fmul_rn(xp[t * a.sx_q + p], w);
    }
    __syncthreads();
    for (int ti = 0; ti < nt; ++ti) {
      float xv[PW];
#pragma unroll
      for (int i = 0; i < PW; ++i) xv[i] = Xs[ti * HD + ty * PW + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = tx + 16 * j;
        const float bv = n < N ? Bs[ti * N + n] : 0.0f;
#pragma unroll
        for (int i = 0; i < PW; ++i) s[i][j] = fmaf(xv[i], bv, s[i][j]);
      }
    }
  }
  float* sp = a.states + (blk * HD) * N;  // [Bt, nc, win, hd, N] contiguous
#pragma unroll
  for (int i = 0; i < PW; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = tx + 16 * j;
      if (n < N) sp[(ty * PW + i) * N + n] = s[i][j];
    }
}

template <int HD>
int launch(const Args& a, long long blocks, cudaStream_t s) {
  const int smem = smem_floats(HD) * static_cast<int>(sizeof(float));
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_chunk_kernel<HD><<<static_cast<unsigned>(blocks), THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [Bt, nc, Q, nh, hd] (unit stride along hd), dt [Bt, nc, Q, nh], A [nh]
// (contiguous), B and C [Bt, nc, Q, N] (unit stride along N); strides in
// elements.  Writes y [Bt, nc, Q, win, hd] and states [Bt, nc, win, hd, N],
// both contiguous, for heads head_offset .. head_offset + win - 1.
// Q <= 256, N <= 128, hd one of 16, 32, 64, 128.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int ssd_chunk_intra_fwd(
    const float* x, const float* dt, const float* A, const float* B,
    const float* C, float* y, float* states, long long sx_b, long long sx_c,
    long long sx_q, long long sx_h, long long sd_b, long long sd_c,
    long long sd_q, long long sd_h, long long sb_b, long long sb_c,
    long long sb_q, long long sc_b, long long sc_c, long long sc_q, int Bt,
    int nc, int Q, int nh, int hd, int N, int head_offset, int win,
    void* stream) {
  const long long blocks = static_cast<long long>(Bt) * nc * win;
  if (Bt < 1 || nc < 1 || Q < 1 || Q > QMAX || N < 1 || N > NMAX ||
      win < 1 || head_offset < 0 || head_offset + win > nh ||
      blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,    dt,   A,    B,    C,    y,    states, sx_b, sx_c,
               sx_q, sx_h, sd_b, sd_c, sd_q, sd_h, sb_b,   sb_c, sb_q,
               sc_b, sc_c, sc_q, nc,   Q,    N,    win,    head_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(a, blocks, s);
    case 32:
      return launch<32>(a, blocks, s);
    case 64:
      return launch<64>(a, blocks, s);
    case 128:
      return launch<128>(a, blocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
