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
// The bf16 arm (flash_attn_fwd_bf16) takes q, k and v in bf16 and writes
// the output in bf16, as the Pallas body does: it casts q, k and v to f32
// at the load, keeps P in f32 for P v, and writes the output in q's
// dtype.  The kernel is templated on the element type E of q, k, v and
// out, and the bf16 instance differs from the f32 one only where an
// element is copied, widened or stored: bf16 K and V tiles (and q above hd
// 64) go into shared memory at half the bytes (rows of hd + 8 elements),
// each element is widened to f32 as its fragment is built (bf16_mma.cuh),
// the 3xTF32 products run as they are (a widened bf16's small part is 0;
// P's is not), masked keys still score -1e30 and zero-filled rows read 0,
// and the output is rounded once to bf16.  At the eval shape above the
// bf16 data is 0.067 GB (0.02 ms); q k^T multiplies two bf16 operands,
// exact in one bf16 pass (34.4 GFLOP at 989 TFLOP/s), while P v multiplies
// the f32 P (34.4 GFLOP at the 3xTF32 rate): 0.243 ms.
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

// E: the element type of q, k, v and out (float, or bf16 for the bf16 arm)
template <int HD, class E>
struct Cfg {
  static constexpr int BKV = HD <= 64 ? 64 : 32;  // keys of a K/V tile
  static constexpr bool QREG = HD <= 64;  // q's split fragments in registers
  // shared-memory row stride, in elements
  static constexpr int S = sizeof(E) == 4 ? HD + 4 : HD + 8;
  static constexpr int VEC = 16 / sizeof(E);  // elements of a 16-byte copy
  static constexpr int KT = BKV / 8;      // n8 key tiles of S
  static constexpr int DK = HD / 8;       // k8 steps of q k^T; n8 tiles of O
  // n8 tiles of O summed at once in P v (their V fragments and stage sums
  // live in registers together)
  static constexpr int NCH = DK <= 8 ? DK : DK / 2;
  static constexpr int KV_ELTS = 2 * BKV * S;  // one stage: K, then V
  static constexpr int smem_bytes = static_cast<int>(sizeof(E)) *
                                    (2 * KV_ELTS + (QREG ? 0 : BM * S));
};

template <int HD, class E>
__global__ void __launch_bounds__(THREADS, 2)
    flash_attn_kernel(const E* __restrict__ q, const E* __restrict__ k,
                      const E* __restrict__ v, E* __restrict__ out,
                      Strides sq, Strides sk, Strides sv, Strides so, int KV,
                      int G, int Sq, int Skv, int causal, int window,
                      float scale) {
  using CF = Cfg<HD, E>;
  constexpr int BKV = CF::BKV, S = CF::S, KT = CF::KT, DK = CF::DK;
  constexpr int VEC = CF::VEC;
  extern __shared__ __align__(16) float smem[];
  E* ring = reinterpret_cast<E*>(smem);  // two stages of K and V
  E* Qs = ring + 2 * CF::KV_ELTS;        // [BM][S], above hd 64 only

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

  const E* kb = k + b * sk.b + kvh * sk.h;
  const E* vb = v + b * sv.b + kvh * sv.h;
  const bool kvec = sk.s % VEC == 0 && sk.b % VEC == 0 && sk.h % VEC == 0 &&
                    aligned16(k);
  const bool vvec = sv.s % VEC == 0 && sv.b % VEC == 0 && sv.h % VEC == 0 &&
                    aligned16(v);
  auto load_kv = [&](int it) {
    const int t0 = t_first + it * BKV;
    E* st = ring + (it & 1) * CF::KV_ELTS;
    load_rows<BKV, HD, S, THREADS>(st, kb + t0 * sk.s, sk.s, Skv - t0, kvec);
    load_rows<BKV, HD, S, THREADS>(st + BKV * S, vb + t0 * sv.s, sv.s,
                                   Skv - t0, vvec);
  };

  // q: split once into registers, or staged with the first K/V tile
  uint32_t qb[CF::QREG ? DK : 1][4], qs[CF::QREG ? DK : 1][4];
  if constexpr (CF::QREG) {
    const E* qa = ra < nrows ? qrow(ra) : nullptr;
    const E* qc = rb < nrows ? qrow(rb) : nullptr;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      const int d = 8 * kk + qd;
      split_tf32(qa ? to_f32(qa[d]) : 0.0f, qb[kk][0], qs[kk][0]);
      split_tf32(qc ? to_f32(qc[d]) : 0.0f, qb[kk][1], qs[kk][1]);
      split_tf32(qa ? to_f32(qa[d + 4]) : 0.0f, qb[kk][2], qs[kk][2]);
      split_tf32(qc ? to_f32(qc[d + 4]) : 0.0f, qb[kk][3], qs[kk][3]);
    }
  } else {
    const bool qvec = sq.s % VEC == 0 && sq.b % VEC == 0 &&
                      sq.h % VEC == 0 && aligned16(q);
    constexpr int CPR = HD / VEC;
    for (int i = threadIdx.x; i < BM * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * VEC;
      const bool ok = R0 + r < nrows;
      const E* src = ok ? qrow(R0 + r) + c : q;
      if (qvec) {
        cp_async16(Qs + r * S + c, src, ok ? 16 : 0);
      } else if constexpr (sizeof(E) == 4) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cp_async4(Qs + r * S + c + e, ok ? src + e : q, ok ? 4 : 0);
      } else {  // bf16 at an odd element: plain copies
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          Qs[r * S + c + e] = ok ? src[e] : from_f32<E>(0.0f);
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
    const E* Ks = ring + (it & 1) * CF::KV_ELTS;
    const E* Vs = Ks + BKV * S;

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
          const E* vc = Vs + (8 * j + 2 * qd) * S + 8 * (n0 + n) + g;
          split_tf32(to_f32(vc[0]), bb[n][0], bs[n][0]);
          split_tf32(to_f32(vc[S]), bb[n][1], bs[n][1]);
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
                     reinterpret_cast<uintptr_t>(out) % (2 * sizeof(E)) == 0;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = hf ? rb : ra;
    if (r >= nrows) continue;
    const float inv = hf ? inv_b : inv_a;
    E* orow = out + b * so.b + static_cast<long long>(r / G) * so.s +
              static_cast<long long>(kvh * G + r % G) * so.h + 2 * qd;
#pragma unroll
    for (int n = 0; n < DK; ++n) {
      const float x0 = o[n][2 * hf] * inv, x1 = o[n][2 * hf + 1] * inv;
      if (pairs) {
        store2(orow + 8 * n, x0, x1);
      } else {
        orow[8 * n] = from_f32<E>(x0);
        orow[8 * n + 1] = from_f32<E>(x1);
      }
    }
  }
}

template <int HD, class E>
int launch(const E* q, const E* k, const E* v, E* out, Strides sq,
           Strides sk, Strides sv, Strides so, int B, int KV, int G, int Sq,
           int Skv, int causal, int window, float scale, cudaStream_t s) {
  const int smem = Cfg<HD, E>::smem_bytes;
  // above 48 KB a block's dynamic shared memory needs this opt-in
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attn_kernel<HD, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (static_cast<long long>(Sq) * G + BM - 1) / BM;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * KV, static_cast<unsigned>(tiles));
  flash_attn_kernel<HD, E><<<grid, THREADS, smem, s>>>(
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
