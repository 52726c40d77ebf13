// Flash attention forward: causal or sliding-window GQA online softmax, f32,
// on Hopper's tensor cores.
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
// multiply-add, half the pairs visible) on 0.13 GB of q, k, v and out.  Both
// products run as 3xTF32 on mma.sync m16n8k8 (tf32x3.cuh), at 165 TFLOP/s at
// best: 0.416 ms, against 0.04 ms for the bytes at 3.35 TB/s.
//
// This design replaces a first one in which a thread owned one query row
// and every product was an f32 FMA on CUDA cores, held back by its
// shared-memory reads and single FMA issue, and spilling at hd 128.  The
// rows of the product are the (query position, head of the kv head's
// group) pairs, so all G query heads of a kv head share every K/V tile.  A
// block of 4 warps owns 64 such rows of one (batch, kv head), each warp 16
// of them, and walks only the key tiles its rows can see (causal diagonal
// and window; 64 keys a tile up to hd 64, 32 above), the next K and V tile
// in flight through a 2-deep cp.async ring while this one is multiplied;
// that loop replaces the TPU's sequential kv grid axis and its VMEM
// scratch.  Row tiles go longest first.
// For each tile a warp forms S = q k^T (q's fragments split once and kept in
// registers up to hd 64; above, read from shared memory and split per tile),
// scales it by scale * log2(e), masks it element by element only on tiles
// that meet the diagonal, the window's edge or the end of the keys, and
// takes the online softmax on the accumulator fragments (row max and the
// final row sums by quad shuffles, exp2).  P goes straight back in as the A
// operand of O += P v: an accumulator fragment (rows g, g + 8; keys 2q,
// 2q + 1) is an A fragment with its contraction order permuted, and V's B
// fragment is read in the same permuted order.  Each tile's P v is summed on
// the tensor core from zero and added to the rescaled O in f32; a tile's
// scores are at most 3 hd / 8 = 48 products summed from zero.  The
// products go to the tensor core one kind at a time across all of a warp's
// tiles (mma3_tiles), so consecutive mma never wait on each other's
// accumulator; what is left holding the kernel back is the issue of the
// splits of K and V, which every warp of a block repeats.  Masked keys
// score -1e30 like the reference's, so their weight is exactly 0 once a row
// has seen one key (weights a row takes before its first visible key are
// rescaled by exactly 0 when it comes, as in the Pallas body); a warp skips
// a tile none of its rows can see.  No atomics: a launch gives the same bits
// every time.  Shared memory rows are hd + 4 floats, so every fragment read
// of a warp hits 32 distinct banks and rows stay 16-byte aligned.
//
// The bf16 arm (flash_attn_fwd_bf16, flash_attn_bf16_kernel) takes q, k
// and v in bf16 and writes the output in bf16, as the Pallas body does: it
// casts q, k and v to f32, keeps P in f32 for P v, and rounds the output
// once.  Its kernel keeps this skeleton (rows as (position, head) pairs,
// longest tiles first, causal and window tile skipping, masked keys at
// -1e30, the online softmax in exp2, P fed back from the accumulators, no
// atomics) on bf16 mma.sync m16n8k16:
// - q k^T in one bf16 pass: both operands are bf16, so the products are
//   exact and their sums f32, as the Pallas body's f32 dot of widened
//   values (up to the summation order).
// - P v as two bf16 passes on P's two parts, hi = bf16(P) and lo = bf16(P
//   - hi) (P - hi is exact in f32): hi + lo lies within 2^-17 P of P, so P
//   v stays as close to the f32-P product as 3xTF32 kept it
//   (tests/test_torch_flash.py pins that arithmetic on the CPU).  Two
//   neighbouring n8 accumulator tiles of S are one k16 A fragment in the
//   mma's own order, so V needs no permutation.
// - K's fragments by ldmatrix and V's by ldmatrix.trans from bf16 shared
//   memory (rows of hd + 8 elements: each ldmatrix phase on 32 distinct
//   banks), through a 3-deep cp.async ring of 64-key tiles; q's fragments
//   once into registers up to head_dim 64, above it staged in shared
//   memory and read by ldmatrix each tile (the registers go to O).
// - Up to head_dim 64 a warp owns two 16-row tiles, which share every K
//   and V fragment it reads (half the shared-memory reads of an mma), 4
//   warps a block; above it one tile a warp, 16 warps a block.
// What bounds it: operations, q k^T and P v's two passes at the dense bf16
// rate, 1.5x SDPA's (which rounds P once to bf16).  At the eval shape above
// that is 103 GFLOP, 0.104 ms at 989 TFLOP/s, against 0.02 ms for its
// 0.067 GB at 3.35 TB/s; mma.sync reaches about two thirds of that rate,
// and the softmax's exp2 and the split of P take the rest of a warp's
// issue.  The softmax's exp2 is ex2.approx (2^-22 relative), far inside
// the arm's tolerance.
#include <cuda_runtime.h>

#include <cstdint>

#include "bf16_mma.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int THREADS = 128;  // 4 warps of 16 rows
constexpr int BM = 64;        // rows of a block
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // batch, position and head strides, in elements
};

template <int HD>
struct Cfg {
  static constexpr int BKV = HD <= 64 ? 64 : 32;  // keys of a K/V tile
  static constexpr bool QREG = HD <= 64;  // q's split fragments in registers
  static constexpr int S = HD + 4;  // shared-memory row stride, in floats
  static constexpr int VEC = 4;       // floats of a 16-byte copy
  static constexpr int KT = BKV / 8;      // n8 key tiles of S
  static constexpr int DK = HD / 8;       // k8 steps of q k^T; n8 tiles of O
  // n8 tiles of O summed at once in P v (their V fragments and stage sums
  // live in registers together)
  static constexpr int NCH = DK <= 8 ? DK : DK / 2;
  static constexpr int KV_ELTS = 2 * BKV * S;  // one stage: K, then V
  static constexpr int smem_bytes = 4 * (2 * KV_ELTS + (QREG ? 0 : BM * S));
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
    flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      Strides sq, Strides sk, Strides sv, Strides so, int KV,
                      int G, int Sq, int Skv, int causal, int window,
                      float scale) {
  using CF = Cfg<HD>;
  constexpr int BKV = CF::BKV, S = CF::S, KT = CF::KT, DK = CF::DK;
  constexpr int VEC = CF::VEC;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;               // two stages of K and V
  float* Qs = ring + 2 * CF::KV_ELTS;  // [BM][S], above hd 64 only

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int nrows = Sq * G;
  // longest first: the first blocks take the last rows
  const int R0 = (gridDim.y - 1 - blockIdx.y) * BM;

  // keys the block's rows can see
  const int qmin = R0 / G, qmax = min((R0 + BM - 1) / G, Sq - 1);
  const int blk_lo = window ? max(0, qmin - window + 1) : 0;
  const int blk_hi = causal ? min(Skv - 1, qmax) : Skv - 1;
  const int t_first = (blk_lo / BKV) * BKV;
  const int ntiles = blk_hi < t_first ? 0 : (blk_hi - t_first) / BKV + 1;

  // this warp's rows, and this lane's two (ra, rb = ra + 8)
  const int wr0 = R0 + 16 * warp;
  const bool idle = wr0 >= nrows;
  const int wq_lo = wr0 / G, wq_hi = min((wr0 + 15) / G, Sq - 1);
  const int ra = wr0 + g, rb = ra + 8;
  const int pa = ra / G, pb = rb / G;  // their query positions
  auto qrow = [&](int r) {
    return q + b * sq.b + static_cast<long long>(r / G) * sq.s +
           static_cast<long long>(kvh * G + r % G) * sq.h;
  };

  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
  const bool kvec = sk.s % VEC == 0 && sk.b % VEC == 0 && sk.h % VEC == 0 &&
                    aligned16(k);
  const bool vvec = sv.s % VEC == 0 && sv.b % VEC == 0 && sv.h % VEC == 0 &&
                    aligned16(v);
  auto load_kv = [&](int it) {
    const int t0 = t_first + it * BKV;
    float* st = ring + (it & 1) * CF::KV_ELTS;
    load_rows<BKV, HD, S, THREADS>(st, kb + t0 * sk.s, sk.s, Skv - t0, kvec);
    load_rows<BKV, HD, S, THREADS>(st + BKV * S, vb + t0 * sv.s, sv.s,
                                   Skv - t0, vvec);
  };

  // q: split once into registers, or staged with the first K/V tile
  uint32_t qb[CF::QREG ? DK : 1][4], qs[CF::QREG ? DK : 1][4];
  if constexpr (CF::QREG) {
    const float* qa = ra < nrows ? qrow(ra) : nullptr;
    const float* qc = rb < nrows ? qrow(rb) : nullptr;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      const int d = 8 * kk + qd;
      split_tf32(qa ? qa[d] : 0.0f, qb[kk][0], qs[kk][0]);
      split_tf32(qc ? qc[d] : 0.0f, qb[kk][1], qs[kk][1]);
      split_tf32(qa ? qa[d + 4] : 0.0f, qb[kk][2], qs[kk][2]);
      split_tf32(qc ? qc[d + 4] : 0.0f, qb[kk][3], qs[kk][3]);
    }
  } else {
    const bool qvec = sq.s % VEC == 0 && sq.b % VEC == 0 &&
                      sq.h % VEC == 0 && aligned16(q);
    constexpr int CPR = HD / VEC;
    for (int i = threadIdx.x; i < BM * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * VEC;
      const bool ok = R0 + r < nrows;
      const float* src = ok ? qrow(R0 + r) + c : q;
      if (qvec) {
        cp_async16(Qs + r * S + c, src, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cp_async4(Qs + r * S + c + e, ok ? src + e : q, ok ? 4 : 0);
      }
    }
  }
  if (ntiles > 0) load_kv(0);
  cp_async_commit();

  const float c2 = scale * LOG2E;  // scores in the exp2 domain
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.0f, l_b = 0.0f;
  float o[DK][4] = {};
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it landed for all; tile it - 1 is read by all
    if (it + 1 < ntiles) load_kv(it + 1);
    cp_async_commit();
    const int t0 = t_first + it * BKV;
    if (idle || (causal && t0 > wq_hi) ||
        (window && t0 + BKV - 1 <= wq_lo - window))
      continue;  // none of the warp's rows sees a key of this tile
    const bool mask = (causal && t0 + BKV - 1 > wq_lo) ||
                      (window && wq_hi - t0 >= window) || t0 + BKV > Skv;
    const float* Ks = ring + (it & 1) * CF::KV_ELTS;
    const float* Vs = Ks + BKV * S;

    // S = q k^T
    float sc[1][KT][4] = {};
    auto& s = sc[0];
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t ab[1][4], as[1][4];
      if constexpr (CF::QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ab[0][e] = qb[kk][e], as[0][e] = qs[kk][e];
      } else {
        uint32_t x[4];
        frag_a(x, Qs + 16 * warp * S + 8 * kk, S);
        split4(x, ab[0], as[0]);
      }
      uint32_t bb[KT][2], bs[KT][2];
#pragma unroll
      for (int j = 0; j < KT; j += 2) {
        uint32_t x[4], xb[4], xs[4];
        frag_b2(x, Ks + 8 * j * S + 8 * kk, S);
        split4(x, xb, xs);
        bb[j][0] = xb[0], bb[j][1] = xb[1], bb[j + 1][0] = xb[2],
        bb[j + 1][1] = xb[3];
        bs[j][0] = xs[0], bs[j][1] = xs[1], bs[j + 1][0] = xs[2],
        bs[j + 1][1] = xs[3];
      }
      mma3_tiles<1, KT>(sc, ab, as, bb, bs);
    }

    // scale, mask, row max over the quad
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * c2;
        if (mask) {
          const int key = t0 + 8 * j + 2 * qd + (e & 1);
          const int p = e < 2 ? pa : pb;
          const bool ok = key < Skv && (!causal || key <= p) &&
                          (!window || p - key < window);
          x = ok ? x : NEG_INF;
        }
        s[j][e] = x;
        if (e < 2)
          mx_a = fmaxf(mx_a, x);
        else
          mx_b = fmaxf(mx_b, x);
      }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
    m_a = mn_a, m_b = mn_b;
    l_a *= corr_a, l_b *= corr_b;  // this lane's share of the row sums

    // P in place of S
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      s[j][0] = exp2f(s[j][0] - mn_a), s[j][1] = exp2f(s[j][1] - mn_a);
      s[j][2] = exp2f(s[j][2] - mn_b), s[j][3] = exp2f(s[j][3] - mn_b);
      l_a += s[j][0] + s[j][1];
      l_b += s[j][2] + s[j][3];
    }

    // O = corr O + P v, NCH n8 tiles of O at a time
#pragma unroll
    for (int n0 = 0; n0 < DK; n0 += CF::NCH) {
      float t[1][CF::NCH][4] = {};
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        // P's A fragment, keys permuted: k = qd is key 2 qd, k = qd + 4 is
        // key 2 qd + 1 of the n8 tile
        uint32_t pb[1][4], ps[1][4];
        split_tf32(s[j][0], pb[0][0], ps[0][0]);
        split_tf32(s[j][2], pb[0][1], ps[0][1]);
        split_tf32(s[j][1], pb[0][2], ps[0][2]);
        split_tf32(s[j][3], pb[0][3], ps[0][3]);
        uint32_t bb[CF::NCH][2], bs[CF::NCH][2];
#pragma unroll
        for (int n = 0; n < CF::NCH; ++n) {
          const float* vc = Vs + (8 * j + 2 * qd) * S + 8 * (n0 + n) + g;
          split_tf32(vc[0], bb[n][0], bs[n][0]);
          split_tf32(vc[S], bb[n][1], bs[n][1]);
        }
        mma3_tiles<1, CF::NCH>(t, pb, ps, bb, bs);
      }
#pragma unroll
      for (int n = 0; n < CF::NCH; ++n) {
        o[n0 + n][0] = o[n0 + n][0] * corr_a + t[0][n][0];
        o[n0 + n][1] = o[n0 + n][1] * corr_a + t[0][n][1];
        o[n0 + n][2] = o[n0 + n][2] * corr_b + t[0][n][2];
        o[n0 + n][3] = o[n0 + n][3] * corr_b + t[0][n][3];
      }
    }
  }
  cp_async_wait<0>();
  if (idle) return;
#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
  }
  const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
  const bool pairs = so.b % 2 == 0 && so.s % 2 == 0 && so.h % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 8 == 0;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = hf ? rb : ra;
    if (r >= nrows) continue;
    const float inv = hf ? inv_b : inv_a;
    float* orow = out + b * so.b + static_cast<long long>(r / G) * so.s +
              static_cast<long long>(kvh * G + r % G) * so.h + 2 * qd;
#pragma unroll
    for (int n = 0; n < DK; ++n) {
      const float x0 = o[n][2 * hf] * inv, x1 = o[n][2 * hf + 1] * inv;
      if (pairs) {
        store2(orow + 8 * n, x0, x1);
      } else {
        orow[8 * n] = x0;
        orow[8 * n + 1] = x1;
      }
    }
  }
}

// -- the bf16 arm -------------------------------------------------------------

// Two bf16 of a row of q (columns d, d + 1) as one register, zero past hd
// or for a missing row.
__device__ __forceinline__ uint32_t q_pair(const bf16* row, int d, int hd,
                                           bool pairs) {
  if (!row || d >= hd) return 0u;
  if (pairs) return *reinterpret_cast<const uint32_t*>(row + d);
  const __nv_bfloat162 v = __halves2bfloat162(row[d], row[d + 1]);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
struct CfgBf16 {
  // a warp owns MT row tiles of 16 rows, which share every K and V
  // fragment it reads; NW warps a block
  static constexpr int MT = HD <= 64 ? 2 : 1;
  static constexpr int NW = HD <= 64 ? 4 : 16;
  static constexpr int MINB = 1;            // blocks an SM holds
  static constexpr int THREADS = 32 * NW;
  static constexpr int WROWS = 16 * MT;     // rows of a warp
  static constexpr int BM = WROWS * NW;     // rows of a block
  static constexpr int BKV = 64;            // keys of a K/V tile
  static constexpr int STAGES = 3;          // K/V tiles in the ring
  static constexpr int S = HD + 8;          // shared row stride, elements
  static constexpr int KT = BKV / 8;        // n8 key tiles of S
  static constexpr int KS = BKV / 16;       // k16 steps of P v
  static constexpr int DK = (HD + 15) / 16; // k16 steps of q k^T
  static constexpr int DN = HD / 8;         // n8 tiles of O
  // n8 tiles of O summed at once in P v (their tile sums in registers)
  static constexpr int NCH = DN < 4 ? DN : 4;
  static constexpr int KV_ELTS = 2 * BKV * S;  // one stage: K, then V
  // q's fragments: held in registers, or (QS) staged in shared memory and
  // read by ldmatrix each tile, which frees the registers a warp's O
  // needs above head_dim 64
  static constexpr bool QS = HD > 64;
  static constexpr int smem_bytes =
      2 * (STAGES * KV_ELTS + (QS ? BM * S : 0));
};

// 2^x, to about 2^-22 relative (ex2.approx; results below 2^-126 flush to
// 0, far below a softmax weight that moves a bf16 output)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The bf16 arm on bf16 mma.sync m16n8k16: q's A fragments loaded once
// into registers, K's and V's B fragments by ldmatrix (V transposed) from
// a STAGES-deep cp.async ring, S = q k^T in one exact bf16 pass, P v as
// two bf16 passes on P's two parts (split_bf16x2).  Skeleton, masking,
// online softmax and store as flash_attn_kernel's.
template <int HD>
__global__ void __launch_bounds__(CfgBf16<HD>::THREADS, CfgBf16<HD>::MINB)
    flash_attn_bf16_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           Strides sq, Strides sk, Strides sv, Strides so,
                           int KV, int G, int Sq, int Skv, int causal,
                           int window, float scale) {
  using CF = CfgBf16<HD>;
  constexpr int MT = CF::MT, BM = CF::BM, BKV = CF::BKV, S = CF::S;
  constexpr int KT = CF::KT, KS = CF::KS, DK = CF::DK, DN = CF::DN;
  constexpr int NCH = CF::NCH, STAGES = CF::STAGES;
  extern __shared__ __align__(16) unsigned char smem_bf[];
  bf16* ring = reinterpret_cast<bf16*>(smem_bf);  // STAGES x (K, V)

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int nrows = Sq * G;
  // longest first: the first blocks take the last rows
  const int R0 = (gridDim.y - 1 - blockIdx.y) * BM;

  // keys the block's rows can see
  const int qmin = R0 / G, qmax = min((R0 + BM - 1) / G, Sq - 1);
  const int blk_lo = window ? max(0, qmin - window + 1) : 0;
  const int blk_hi = causal ? min(Skv - 1, qmax) : Skv - 1;
  const int t_first = (blk_lo / BKV) * BKV;
  const int ntiles = blk_hi < t_first ? 0 : (blk_hi - t_first) / BKV + 1;

  // this warp's rows; row tile i holds this lane's rows ra = wr0 + 16 i +
  // g and rb = ra + 8, at query positions pa[i], pb[i]
  const int wr0 = R0 + CF::WROWS * warp;
  const bool idle = wr0 >= nrows;
  const int wq_lo = wr0 / G, wq_hi = min((wr0 + CF::WROWS - 1) / G, Sq - 1);
  int pa[MT], pb[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    pa[i] = (wr0 + 16 * i + g) / G;
    pb[i] = (wr0 + 16 * i + g + 8) / G;
  }

  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;
  const bool kvec = sk.s % 8 == 0 && sk.b % 8 == 0 && sk.h % 8 == 0 &&
                    aligned16(k);
  const bool vvec = sv.s % 8 == 0 && sv.b % 8 == 0 && sv.h % 8 == 0 &&
                    aligned16(v);
  auto load_kv = [&](int it) {
    const int t0 = t_first + it * BKV;
    bf16* st = ring + (it % STAGES) * CF::KV_ELTS;
    load_rows<BKV, HD, S, CF::THREADS>(st, kb + t0 * sk.s, sk.s, Skv - t0,
                                       kvec);
    load_rows<BKV, HD, S, CF::THREADS>(st + BKV * S, vb + t0 * sv.s, sv.s,
                                       Skv - t0, vvec);
  };
  auto qrow = [&](int r) -> const bf16* {
    if (r >= nrows) return nullptr;
    return q + b * sq.b + static_cast<long long>(r / G) * sq.s +
           static_cast<long long>(kvh * G + r % G) * sq.h;
  };
  bf16* Qs = ring + STAGES * CF::KV_ELTS;  // [BM][S], QS only
  if constexpr (CF::QS) {  // the block's q rows, with the first K/V tile
    const bool qvec = sq.s % 8 == 0 && sq.b % 8 == 0 && sq.h % 8 == 0 &&
                      aligned16(q);
    constexpr int CPR = HD / 8;
    for (int i = threadIdx.x; i < BM * CPR; i += CF::THREADS) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const bf16* src = qrow(R0 + r);
      if (qvec) {
        cp_async16_bf16(Qs + r * S + c, src ? src + c : q, src ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          Qs[r * S + c + e] = src ? src[c + e] : __float2bfloat16_rn(0.f);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles) load_kv(i);
    cp_async_commit();
  }

  // q's A fragments: rows ra, rb of each row tile; columns 16 kk + 2 qd
  // (+ 1) and + 8
  uint32_t qa[CF::QS ? 1 : MT][CF::QS ? 1 : DK][4];
  if constexpr (!CF::QS) {
    const bool pairs = sq.s % 2 == 0 && sq.b % 2 == 0 && sq.h % 2 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 4 == 0;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const bf16 *qra = qrow(wr0 + 16 * i + g),
                 *qrb = qrow(wr0 + 16 * i + g + 8);
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        const int d = 16 * kk + 2 * qd;
        qa[i][kk][0] = q_pair(qra, d, HD, pairs);
        qa[i][kk][1] = q_pair(qrb, d, HD, pairs);
        qa[i][kk][2] = q_pair(qra, d + 8, HD, pairs);
        qa[i][kk][3] = q_pair(qrb, d + 8, HD, pairs);
      }
    }
  }

  const float c2 = scale * LOG2E;  // scores in the exp2 domain
  float m[MT][2], l[MT][2];        // running max and sum of rows ra, rb
  float o[MT][DN][4] = {};
#pragma unroll
  for (int i = 0; i < MT; ++i)
    m[i][0] = m[i][1] = NEG_INF, l[i][0] = l[i][1] = 0.0f;
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile it landed for all; tile it - 1 is read by all
    if (it + STAGES - 1 < ntiles) load_kv(it + STAGES - 1);
    cp_async_commit();
    const int t0 = t_first + it * BKV;
    if (idle || (causal && t0 > wq_hi) ||
        (window && t0 + BKV - 1 <= wq_lo - window))
      continue;  // none of the warp's rows sees a key of this tile
    const bool mask = (causal && t0 + BKV - 1 > wq_lo) ||
                      (window && wq_hi - t0 >= window) || t0 + BKV > Skv;
    const bf16* Ks = ring + (it % STAGES) * CF::KV_ELTS;
    const bf16* Vs = Ks + BKV * S;

    // S = q k^T: keys along n (K's rows), head_dim along k; each K
    // fragment feeds every row tile
    float s[MT][KT][4] = {};
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t qf[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if constexpr (CF::QS) {
          ldmatrix_x4_bf16(qf[i], Qs + (CF::WROWS * warp + 16 * i +
                                        (lane & 15)) * S +
                                      16 * kk + (lane >> 4) * 8);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) qf[i][e] = qa[i][kk][e];
        }
      }
#pragma unroll
      for (int j = 0; j < KT; j += 2) {
        uint32_t x[4];
        ldmatrix_x4_bf16(x, Ks + (8 * j + (lane & 7) + (lane >> 4) * 8) * S +
                                16 * kk + ((lane >> 3) & 1) * 8);
        if (HD % 16 != 0 && kk == DK - 1) x[1] = x[3] = 0u;  // past hd
        const uint32_t b0[2] = {x[0], x[1]}, b1[2] = {x[2], x[3]};
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(s[i][j], qf[i], b0);
          mma_bf16(s[i][j + 1], qf[i], b1);
        }
      }
    }

    // per row tile: scale, mask, row max over the quad, P in f32 and its
    // two bf16 parts as the A fragments of P v (n8 tiles 2 kt and 2 kt + 1
    // of S, rows g, g + 8 and keys 2 qd, 2 qd + 1 of each, are the k16
    // step kt in the mma's own order)
    uint32_t ph[MT][KS][4], pl[MT][KS][4];
    float corr[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[i][j][e] * c2;
          if (mask) {
            const int key = t0 + 8 * j + 2 * qd + (e & 1);
            const int p = e < 2 ? pa[i] : pb[i];
            const bool ok = key < Skv && (!causal || key <= p) &&
                            (!window || p - key < window);
            x = ok ? x : NEG_INF;
          }
          s[i][j][e] = x;
          if (e < 2)
            mx_a = fmaxf(mx_a, x);
          else
            mx_b = fmaxf(mx_b, x);
        }
#pragma unroll
      for (int o2 = 1; o2 < 4; o2 <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
      }
      const float mn_a = fmaxf(m[i][0], mx_a), mn_b = fmaxf(m[i][1], mx_b);
      corr[i][0] = exp2_approx(m[i][0] - mn_a);
      corr[i][1] = exp2_approx(m[i][1] - mn_b);
      m[i][0] = mn_a, m[i][1] = mn_b;
      float la = l[i][0] * corr[i][0], lb = l[i][1] * corr[i][1];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float p0 = exp2_approx(s[i][j][0] - mn_a);
        const float p1 = exp2_approx(s[i][j][1] - mn_a);
        const float p2 = exp2_approx(s[i][j][2] - mn_b);
        const float p3 = exp2_approx(s[i][j][3] - mn_b);
        la += p0 + p1;
        lb += p2 + p3;
        const int kt = j >> 1, h = (j & 1) * 2;
        split_bf16x2(p0, p1, ph[i][kt][h], pl[i][kt][h]);
        split_bf16x2(p2, p3, ph[i][kt][h + 1], pl[i][kt][h + 1]);
      }
      l[i][0] = la, l[i][1] = lb;  // this lane's share of the row sums
    }

    // O = corr O + P v, NCH n8 tiles of O at a time, each tile's sum on
    // the tensor core from zero, then added in f32; each V fragment feeds
    // every row tile
#pragma unroll
    for (int n0 = 0; n0 < DN; n0 += NCH) {
      float t[MT][NCH][4] = {};
#pragma unroll
      for (int kt = 0; kt < KS; ++kt) {
        uint32_t vf[NCH + 1][2];
#pragma unroll
        for (int n = 0; n < NCH; n += 2) {
          uint32_t x[4];
          ldmatrix_x4_trans_bf16(
              x, Vs + (16 * kt + (lane & 7) + ((lane >> 3) & 1) * 8) * S +
                     8 * (n0 + n) + (lane >> 4) * 8);
          vf[n][0] = x[0], vf[n][1] = x[1];
          vf[n + 1][0] = x[2], vf[n + 1][1] = x[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < NCH; ++n) mma_bf16(t[i][n], ph[i][kt], vf[n]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < NCH; ++n) mma_bf16(t[i][n], pl[i][kt], vf[n]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int n = 0; n < NCH; ++n) {
          float* oo = o[i][n0 + n];
          oo[0] = oo[0] * corr[i][0] + t[i][n][0];
          oo[1] = oo[1] * corr[i][0] + t[i][n][1];
          oo[2] = oo[2] * corr[i][1] + t[i][n][2];
          oo[3] = oo[3] * corr[i][1] + t[i][n][3];
        }
    }
  }
  cp_async_wait<0>();
  if (idle) return;
  const bool pairs = so.b % 2 == 0 && so.s % 2 == 0 && so.h % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 4 == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float la = l[i][0], lb = l[i][1];
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      la += __shfl_xor_sync(0xffffffffu, la, o2);
      lb += __shfl_xor_sync(0xffffffffu, lb, o2);
    }
    const float inv_a = 1.0f / fmaxf(la, 1e-30f);
    const float inv_b = 1.0f / fmaxf(lb, 1e-30f);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wr0 + 16 * i + g + 8 * hf;
      if (r >= nrows) continue;
      const float inv = hf ? inv_b : inv_a;
      bf16* orow = out + b * so.b + static_cast<long long>(r / G) * so.s +
                   static_cast<long long>(kvh * G + r % G) * so.h + 2 * qd;
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        const float x0 = o[i][n][2 * hf] * inv,
                    x1 = o[i][n][2 * hf + 1] * inv;
        if (pairs) {
          store2(orow + 8 * n, x0, x1);
        } else {
          orow[8 * n] = __float2bfloat16_rn(x0);
          orow[8 * n + 1] = __float2bfloat16_rn(x1);
        }
      }
    }
  }
}

// the bf16 arm's kernel
template <int HD>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out,
           Strides sq, Strides sk, Strides sv, Strides so, int B, int KV,
           int G, int Sq, int Skv, int causal, int window, float scale,
           cudaStream_t s) {
  using CF = CfgBf16<HD>;
  // above 48 KB a block's dynamic shared memory needs this opt-in
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attn_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      CF::smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (static_cast<long long>(Sq) * G + CF::BM - 1) /
                          CF::BM;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * KV, static_cast<unsigned>(tiles));
  flash_attn_bf16_kernel<HD><<<grid, CF::THREADS, CF::smem_bytes, s>>>(
      q, k, v, out, sq, sk, sv, so, KV, G, Sq, Skv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* out,
           Strides sq, Strides sk, Strides sv, Strides so, int B, int KV,
           int G, int Sq, int Skv, int causal, int window, float scale,
           cudaStream_t s) {
  const int smem = Cfg<HD>::smem_bytes;
  // above 48 KB a block's dynamic shared memory needs this opt-in
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (static_cast<long long>(Sq) * G + BM - 1) / BM;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * KV, static_cast<unsigned>(tiles));
  flash_attn_kernel<HD><<<grid, THREADS, smem, s>>>(
      q, k, v, out, sq, sk, sv, so, KV, G, Sq, Skv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// Checks the sizes and launches the kernel at head_dim hd.
template <class E>
int run(const E* q, const E* k, const E* v, E* out, long long sq_b,
        long long sq_s, long long sq_h, long long sk_b, long long sk_s,
        long long sk_h, long long sv_b, long long sv_s, long long sv_h,
        long long so_b, long long so_s, long long so_h, int B, int KV, int G,
        int Sq, int Skv, int hd, int causal, int window, float scale,
        void* stream) {
  if (G < 1 || G > 128 || B < 1 || KV < 1 || Sq < 1 || Skv < 1)
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
    case 96:
      return launch<96>(q, k, v, out, sq, sk, sv, so, B, KV, G, Sq, Skv,
                        causal, window, scale, s);
    case 128:
      return launch<128>(q, k, v, out, sq, sk, sv, so, B, KV, G, Sq, Skv,
                         causal, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, Sq, H, hd], k and v [B, Skv, KV, hd], out [B, Sq, H, hd], each with
// unit stride along hd and the given batch / position / head strides (in
// elements); H = KV * G with G <= 128; hd one of 8, 16, 32, 64, 96, 128.
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attn_fwd(const float* q, const float* k, const float* v,
                              float* out, long long sq_b, long long sq_s,
                              long long sq_h, long long sk_b, long long sk_s,
                              long long sk_h, long long sv_b, long long sv_s,
                              long long sv_h, long long so_b, long long so_s,
                              long long so_h, int B, int KV, int G, int Sq,
                              int Skv, int hd, int causal, int window,
                              float scale, void* stream) {
  return run(q, k, v, out, sq_b, sq_s, sq_h, sk_b, sk_s, sk_h, sv_b, sv_s,
             sv_h, so_b, so_s, so_h, B, KV, G, Sq, Skv, hd, causal, window,
             scale, stream);
}

// The bf16 arm: q, k, v and out bf16; the same layout rules.
extern "C" int flash_attn_fwd_bf16(const bf16* q, const bf16* k,
                                   const bf16* v, bf16* out, long long sq_b,
                                   long long sq_s, long long sq_h,
                                   long long sk_b, long long sk_s,
                                   long long sk_h, long long sv_b,
                                   long long sv_s, long long sv_h,
                                   long long so_b, long long so_s,
                                   long long so_h, int B, int KV, int G,
                                   int Sq, int Skv, int hd, int causal,
                                   int window, float scale, void* stream) {
  return run(q, k, v, out, sq_b, sq_s, sq_h, sk_b, sk_s, sk_h, sv_b, sv_s,
             sv_h, so_b, so_s, so_h, B, KV, G, Sq, Skv, hd, causal, window,
             scale, stream);
}
