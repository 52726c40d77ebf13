// The intra-chunk block of Mamba-2's SSD mixer, f32, on Hopper's tensor
// cores.
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
// (8 x 32768 tokens: Bt 8, nc 128, Q 256, nh 24, hd 64, N 128) the data needs
// C B^T once per chunk over the causal pairs (Q(Q+1)/2 * N multiply-adds,
// 8.6 GFLOP; ngroups = 1, so it does not depend on the head), M x per head
// over the same pairs (103 GFLOP) and the state per head (Q * hd * N, 103
// GFLOP): 0.215 TFLOP.  Every product runs as 3xTF32 on mma.sync m16n8k8
// (tf32x3.cuh), at 165 TFLOP/s at best: 1.30 ms, against 4.3 GB of x, dt,
// B, C, y and states (1.29 ms at 3.35 TB/s).
//
// This design replaces a first one that ran every product as f32 FMAs on
// CUDA cores and formed C B^T again for every head (about 0.62 TFLOP
// executed for the 0.215 the data needs).  Two kernels run behind the one
// entry point, on the caller's stream.
//
// ssd_y_kernel forms y.  A block of 8 warps (4 along the rows, 2 along hd)
// owns one (batch, chunk, 64-row query tile) and a group of up to HG = 24
// heads of the window (the last group ragged where HG does not divide it).
// It first forms its causal strip of C B^T once for the whole group: 64
// query rows against the key tiles t0 <= its last row, contraction over
// d_state in 16-deep cp.async stages, parked in shared memory in the warps'
// own accumulator order (64 x 256 f32 at Q = 256).  Then, for each head of
// its group, it walks the visible keys in 32-deep stages of that head's x,
// three stages (and so the next head's first) in flight through a 4-deep
// cp.async ring while one is multiplied.  As a warp reads C B^T back it
// builds M = CB * exp(L_q - L_t) * dt_t, splits it and feeds it to the
// tensor core as the A operand: an accumulator fragment (rows g, g + 8;
// keys 2q, 2q + 1) is an A fragment with its contraction order permuted,
// and x's B fragment is read in the same permuted order.  The weight of an
// m16 tile's k8 step is, where every key of the 32-key stage precedes every
// row, exp(L_q - L_ref) * u_t with ref the stage's last key and u_t =
// exp(L_ref - L_t) * dt_t tabulated once a head (two exponentials a row a
// stage); else, where the step's keys precede the rows, the same with ref
// the step's last key; else, on the diagonal, exp(L_q - L_t) * dt_t with
// the mask applied before the exponential (t > q never forms exp(L_q -
// L_t), which overflows).  Every exponent is <= 0.  A warp loads the next
// head's dt at a head's first stage and tabulates it at the last, where its
// rows (q0 .. q0 + 31) see none of the keys.  Query tiles go longest first.
//
// The bf16 arm (ssd_chunk_intra_fwd_bf16) takes x, dt, B and C in bf16 (A
// in f32) and writes y in bf16, the states in f32, as the Pallas body
// does: it casts its inputs to f32 at the load, computes in f32 and
// writes y in x's dtype.  Both kernels below are templated on the element
// type E of x, dt, B, C and y, and the bf16 instances differ from the f32
// ones only where an element is copied, widened or stored: bf16 tiles go
// into shared memory (half the bytes; rows of hd + 8 and 16 + 8 elements),
// each element is widened to f32 as its fragment is built (bf16_mma.cuh),
// the 3xTF32 mainloops run as they are (a widened bf16's small part is 0),
// and y is rounded once to bf16 at the store.  At the prefill layer above
// the bf16 data is 2.2 GB (0.65 ms at 3.35 TB/s); of the operations, C B^T
// multiplies two bf16 operands, exact in one bf16 pass (8.6 GFLOP at 989
// TFLOP/s), while M x and the state multiply an f32 weight by x (206 GFLOP
// at the 3xTF32 rate): 1.26 ms.
//
// ssd_state_kernel forms S, one block per (batch, chunk, head), 4 warps
// (8 at hd 128): a 3xTF32 product hd x N over the chunk's positions, A =
// (x * w)^T with the key weight w_t = exp(L_{Q-1} - L_t) * dt_t computed
// once per (t, head), B the chunk's B rows, through a 3-deep cp.async ring.
//
// In both, the products of a stage go to the tensor core one kind at a
// time across all of a warp's tiles (mma3_tiles), so consecutive mma never
// wait on each other's accumulator.  L is a warp's scan of dt * A (each
// product rounded, as the body's dA; every weight a difference of L, never
// a sum over (t, q]): it rounds its partial sums in another order than the
// plain version's sequential cumsum, which at |L| in the hundreds moves y by
// about 1e-5 of its largest value, inside the 1e-4 the kernel is held to
// (a sequential cumsum a head would cost a millisecond at the prefill
// shape).  Copies are 16 bytes where the rows allow it (row stride a
// multiple of 4 floats, or 8 bf16, 16-byte aligned start), else 4 bytes
// (bf16: element by element, with plain loads), the ragged edges
// zero-filled.  No split of a contraction
// across blocks and no atomics: one block sums each output in a fixed
// order, so a launch gives the same bits every time.
#include <cuda_runtime.h>

#include <cstdint>

#include "bf16_mma.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int NMAX = 128;      // largest d_state
constexpr int QMAX = 256;      // largest chunk
constexpr int TQ = 64;         // query rows of a y block
constexpr int CB_BK = 16;      // d_state depth of a C B^T stage
constexpr int KS = 32;         // positions of an x (or state) stage
constexpr int STAGES = 3;      // the cp.async ring
constexpr int HG = 24;         // most heads a y block serves

// E: the element type of x, dt, B, C and y (float, or bf16 for the bf16
// arm); A and the states are f32 in both.
template <class E>
struct Args {
  const E* x;
  const E* dt;
  const float* A;
  const E* B;
  const E* C;
  E* y;
  float* states;
  long long sx_b, sx_c, sx_q, sx_h;  // x strides, unit along hd
  long long sd_b, sd_c, sd_q, sd_h;  // dt strides
  long long sb_b, sb_c, sb_q;        // B strides, unit along N
  long long sc_b, sc_c, sc_q;        // C strides, unit along N
  int nc, Q, N, win, head_offset;
};

// One warp: L[t] = cumsum(dt * Ah) (inclusive) and dts[t] = dt_t for t <
// QMAX, from lane l's v = dt_t for t = 8 l .. 8 l + 7, zero past Q (so L
// stays at L[Q - 1]).  Each lane sums its 8, then the lanes' totals are
// scanned by shuffles.
__device__ __forceinline__ void scan_L(const float (&v)[QMAX / 32], float Ah,
                                       float* L, float* dts, int lane) {
  constexpr int PER = QMAX / 32;
  const int t0 = lane * PER;
  float run[PER];
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    dts[t0 + i] = v[i];
    acc = __fadd_rn(acc, __fmul_rn(v[i], Ah));  // no contraction
    run[i] = acc;
  }
  float incl = acc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
#pragma unroll
  for (int i = 0; i < PER; ++i) L[t0 + i] = excl + run[i];
  __syncwarp();
}

// One warp: lane l's dt_t for t = 8 l .. 8 l + 7 (zero past Q), as plain
// loads into registers (widened to f32), which may stay in flight across a
// barrier.
template <class E>
__device__ __forceinline__ void load_dt(float (&v)[QMAX / 32], const E* dtp,
                                        long long sd_q, int Q, int lane) {
#pragma unroll
  for (int i = 0; i < QMAX / 32; ++i) {
    const int t = lane * (QMAX / 32) + i;
    v[i] = t < Q ? to_f32(dtp[t * sd_q]) : 0.0f;
  }
}

// The y kernel's per-head tables: L, dt, u[t] = exp(L[ref] - L[t]) * dt_t
// with ref = min(t | 31, Q - 1), the last key of t's stage, and u8[t] the
// same with ref = min(t | 7, Q - 1), the last key of t's k8 step.
__device__ __forceinline__ void head_tables(const float (&v)[QMAX / 32],
                                            float Ah, int Q, float* tab,
                                            int lane) {
  float* L = tab;
  float* dts = tab + QMAX;
  float* u = tab + 2 * QMAX;
  float* u8 = tab + 3 * QMAX;
  scan_L(v, Ah, L, dts, lane);
  for (int t = lane; t < QMAX; t += 32) {
    const bool in = t < Q;
    u[t] = in ? __fmul_rn(__expf(L[min(t | (KS - 1), Q - 1)] - L[t]), dts[t])
              : 0.0f;
    u8[t] = in ? __fmul_rn(__expf(L[min(t | 7, Q - 1)] - L[t]), dts[t]) : 0.0f;
  }
  __syncwarp();
}


template <int HD, class E>
struct YCfg {
  static constexpr bool F32 = sizeof(E) == 4;
  static constexpr int WM = 4;          // warps along the 64 rows
  static constexpr int WN = 2;          // warps along hd
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MT = 4 / WM;     // m16 tiles of a warp
  static constexpr int NT = HD / 16;    // n8 tiles of a warp (half of hd)
  // x stage row stride: the permuted fragment reads hit 32 banks (f32),
  // or distinct words (bf16)
  static constexpr int XS = F32 ? HD + 4 : HD + 8;
  static constexpr int CB_S = F32 ? CB_BK + 4 : CB_BK + 8;  // C, B stages
  static constexpr int VEC = 16 / sizeof(E);  // elements of a 16-byte copy
  static constexpr int CB_STAGE = 2 * TQ * CB_S;  // elements
  static constexpr int X_STAGE = KS * XS;
  static constexpr int XSTAGES = 4;  // the x ring's depth
  static constexpr int RING_E = STAGES * CB_STAGE > XSTAGES * X_STAGE
                                    ? STAGES * CB_STAGE
                                    : XSTAGES * X_STAGE;
  // the ring in floats, a multiple of 4 (the tables stay 16-byte aligned)
  static constexpr int RING = (RING_E * static_cast<int>(sizeof(E)) + 15) /
                              16 * 4;
  static constexpr int TABS = 4 * QMAX;  // L, dt, u, u8 of a head
  static constexpr int fixed_floats() { return RING + 2 * TABS; }
};

template <int HD, class E>
__global__ void __launch_bounds__(YCfg<HD, E>::THREADS, 2)
    ssd_y_kernel(Args<E> a, int nqt, int ngr, int hg, int nj) {
  using CF = YCfg<HD, E>;
  constexpr int MT = CF::MT, NT = CF::NT, XS = CF::XS, CB_S = CF::CB_S;
  constexpr int THREADS = CF::THREADS, TABS = CF::TABS, VEC = CF::VEC;
  constexpr int XST = CF::XSTAGES, XSTAGE = CF::X_STAGE;
  constexpr int STAGE = CF::CB_STAGE;     // the C B^T phase's ring slots
  extern __shared__ __align__(16) float smem[];
  E* ring = reinterpret_cast<E*>(smem);   // CF::RING_E elements
  float* tabs = smem + CF::RING;          // [2][TABS], by head parity
  float* cbf = tabs + 2 * TABS;           // [4 m16][nj n8][32 lanes][4]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / CF::WN, wn = warp % CF::WN;
  const int g = lane >> 2, qd = lane & 3;
  const int Q = a.Q, N = a.N;
  const int wrow = wm * MT * 16;  // the warp's first row in the tile

  // longest first: the first blocks take the last query tile
  const long long per_qt = gridDim.x / nqt;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x / per_qt);
  const long long rem = blockIdx.x % per_qt;
  const int gr = static_cast<int>(rem % ngr);
  const int c = static_cast<int>((rem / ngr) % a.nc);
  const long long b = rem / (static_cast<long long>(ngr) * a.nc);
  const int q0 = qt * TQ;
  const int h_lo = gr * hg, h_n = min(hg, a.win - h_lo);

  const E* Cp = a.C + b * a.sc_b + c * a.sc_c;
  const E* Bp = a.B + b * a.sb_b + c * a.sb_c;
  const E* xb = a.x + b * a.sx_b + c * a.sx_c;
  const E* dtb = a.dt + b * a.sd_b + c * a.sd_c;
  auto head_dt = [&](int hh) {
    return dtb + static_cast<long long>(a.head_offset + h_lo + hh) * a.sd_h;
  };
  float dtv[QMAX / 32];  // a head's dt on its way to the tables
  if (warp == 0) load_dt(dtv, head_dt(0), a.sd_q, Q, lane);

  // ---- C B^T: the strip of rows q0 .. q0 + 63 against keys 0 .. q0 + 63
  {
    const int ns = (N + CB_BK - 1) / CB_BK;  // d_state stages of a key tile
    const int total = (qt + 1) * ns;
    const bool cv = a.sc_q % VEC == 0 && aligned16(Cp);
    const bool bv = a.sb_q % VEC == 0 && aligned16(Bp);
    auto load = [&](int s) {
      E* st = ring + (s % STAGES) * STAGE;
      const int kt = s / ns, n0 = (s % ns) * CB_BK;
      load_block<TQ, CB_BK, CB_S, THREADS>(st, Cp + q0 * a.sc_q + n0, a.sc_q,
                                           Q - q0, N - n0, cv);
      load_block<TQ, CB_BK, CB_S, THREADS>(st + TQ * CB_S,
                                           Bp + kt * TQ * a.sb_q + n0,
                                           a.sb_q, Q - kt * TQ, N - n0, bv);
    };
    float cb[MT][4][4] = {};
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < total) load(s);
      cp_async_commit();
    }
    for (int s = 0; s < total; ++s) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage s landed for all; stage s - 1 is read by all
      if (s + STAGES - 1 < total) load(s + STAGES - 1);
      cp_async_commit();
      const E* Cs = ring + (s % STAGES) * STAGE;
      const E* Bs = Cs + TQ * CB_S;
      uint32_t bb[2][4][2], bs[2][4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t v[4], vb[4], vs[4];
          frag_b2(v, Bs + (wn * 32 + j * 8) * CB_S + 8 * h, CB_S);
          split4(v, vb, vs);
          bb[h][j][0] = vb[0], bb[h][j][1] = vb[1];
          bb[h][j + 1][0] = vb[2], bb[h][j + 1][1] = vb[3];
          bs[h][j][0] = vs[0], bs[h][j][1] = vs[1];
          bs[h][j + 1][0] = vs[2], bs[h][j + 1][1] = vs[3];
        }
      float t[MT][4][4] = {};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t ab[MT][4], as[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t v[4];
          frag_a(v, Cs + (wrow + 16 * i) * CB_S + 8 * h, CB_S);
          split4(v, ab[i], as[i]);
        }
        mma3_tiles<MT, 4>(t, ab, as, bb[h], bs[h]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) cb[i][j][e] += t[i][j][e];
      if (s % ns == ns - 1) {  // a key tile is done: park it, warp order
        const int kt = s / ns;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float4* dst = reinterpret_cast<float4*>(
                cbf + (((wm * MT + i) * nj + kt * 8 + wn * 4 + j) * 32 + lane) *
                          4);
            *dst = make_float4(cb[i][j][0], cb[i][j][1], cb[i][j][2],
                               cb[i][j][3]);
#pragma unroll
            for (int e = 0; e < 4; ++e) cb[i][j][e] = 0.0f;
          }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the strip is complete; the ring is free
  }

  // ---- y, head by head: keys 0 .. min(q0 + 64, Q) - 1 in 32-deep stages
  const int nks = (min(q0 + TQ, Q) + KS - 1) / KS;
  const int total = h_n * nks;
  const bool xq4 = a.sx_q % VEC == 0;
  auto head_x = [&](int hh) {
    return xb + static_cast<long long>(a.head_offset + h_lo + hh) * a.sx_h;
  };
  auto load = [&](int s) {
    const int hh = s / nks, t0 = (s % nks) * KS;
    const E* xh = head_x(hh);
    load_rows<KS, HD, XS, THREADS>(ring + (s % XST) * XSTAGE,
                                   xh + t0 * a.sx_q, a.sx_q, Q - t0,
                                   xq4 && aligned16(xh));
  };
  if (warp == 0) head_tables(dtv, a.A[a.head_offset + h_lo], Q, tabs, lane);
#pragma unroll
  for (int s = 0; s < XST - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  const long long y_row = static_cast<long long>(a.win) * HD;
  float acc[MT][NT][4] = {};
  for (int s = 0; s < total; ++s) {
    cp_async_wait<XST - 2>();
    __syncthreads();
    if (s + XST - 1 < total) load(s + XST - 1);
    cp_async_commit();
    const int hh = s / nks, ks = s % nks, t0 = ks * KS;
    // the next head's tables, into the buffer head hh - 1 used (its last
    // stage is done; head hh + 1's first stage is behind another barrier):
    // its dt is loaded at this head's first stage, the loads in flight
    // meanwhile, and tabulated at the last, keys q0 + 32 .. q0 + 63, where
    // the warps of rows q0 .. q0 + 31 (warps 0 .. 3) have no product to add
    if (hh + 1 < h_n && warp == hh % 4) {
      if (ks == 0) load_dt(dtv, head_dt(hh + 1), a.sd_q, Q, lane);
      if (ks == nks - 1)
        head_tables(dtv, a.A[a.head_offset + h_lo + hh + 1], Q,
                    tabs + ((hh + 1) & 1) * TABS, lane);
    }
    const float* Lh = tabs + (hh & 1) * TABS;
    const float* dth = Lh + QMAX;
    const float* uh = Lh + 2 * QMAX;
    const float* u8h = Lh + 3 * QMAX;
    const E* Xs = ring + (s % XST) * XSTAGE;

    // a warp whose rows all precede the stage's keys has nothing to add
    if (t0 <= q0 + wrow + MT * 16 - 1) {
      // A fragments (M, split) of the warp's m16 tiles, 4 k8 steps; masked
      // keys weigh 0, so the products below need no branch
      uint32_t ab[MT][4][4], as[MT][4][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r0 = q0 + wrow + 16 * i;     // the tile's first row
        const int ra = r0 + g, rb = ra + 8;    // this lane's rows
        const bool full = t0 + KS - 1 <= r0;   // every key precedes every row
        const float La = Lh[ra], Lb = Lh[rb];
        float fa = 0.0f, fb = 0.0f;
        if (full) {
          const float Lr = Lh[t0 + KS - 1];
          fa = __expf(La - Lr);
          fb = __expf(Lb - Lr);
        }
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int k0 = t0 + 8 * h;
          const float4 cv = *reinterpret_cast<const float4*>(
              cbf + (((wm * MT + i) * nj + (k0 >> 3)) * 32 + lane) * 4);
          // cv: (ra, t), (ra, t + 1), (rb, t), (rb, t + 1)
          const int t = k0 + 2 * qd;
          float m[4];
          if (full) {
            const float2 u = *reinterpret_cast<const float2*>(uh + t);
            m[0] = __fmul_rn(cv.x, __fmul_rn(fa, u.x));
            m[1] = __fmul_rn(cv.y, __fmul_rn(fa, u.y));
            m[2] = __fmul_rn(cv.z, __fmul_rn(fb, u.x));
            m[3] = __fmul_rn(cv.w, __fmul_rn(fb, u.y));
          } else if (k0 + 7 <= r0) {  // the k8 step precedes the rows
            const float Lr = Lh[k0 + 7];
            const float ga = __expf(La - Lr), gb = __expf(Lb - Lr);
            const float2 u = *reinterpret_cast<const float2*>(u8h + t);
            m[0] = __fmul_rn(cv.x, __fmul_rn(ga, u.x));
            m[1] = __fmul_rn(cv.y, __fmul_rn(ga, u.y));
            m[2] = __fmul_rn(cv.z, __fmul_rn(gb, u.x));
            m[3] = __fmul_rn(cv.w, __fmul_rn(gb, u.y));
          } else if (k0 > r0 + 15) {  // the k8 step follows the rows
            m[0] = m[1] = m[2] = m[3] = 0.0f;
          } else {  // on the diagonal: the mask before the exponential
            const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e < 2 ? ra : rb, tt = t + (e & 1);
              m[e] = tt <= r ? __fmul_rn(
                                   __fmul_rn(cr[e], __expf(Lh[r] - Lh[tt])),
                                   dth[tt])
                             : 0.0f;
            }
          }
          // the contraction permuted: k = qd is key t, k = qd + 4 key t + 1
          split_tf32(m[0], ab[i][h][0], as[i][h][0]);
          split_tf32(m[2], ab[i][h][1], as[i][h][1]);
          split_tf32(m[1], ab[i][h][2], as[i][h][2]);
          split_tf32(m[3], ab[i][h][3], as[i][h][3]);
        }
      }
      float t[MT][NT][4] = {};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const E* xc =
              Xs + (8 * h + 2 * qd) * XS + wn * (HD / 2) + 8 * j + g;
          split_tf32(to_f32(xc[0]), bb[j][0], bs[j][0]);   // key t
          split_tf32(to_f32(xc[XS]), bb[j][1], bs[j][1]);  // key t + 1
        }
        uint32_t a_b[MT][4], a_s[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a_b[i][e] = ab[i][h][e], a_s[i][e] = as[i][h][e];
        mma3_tiles<MT, NT>(t, a_b, a_s, bb, bs);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += t[i][j][e];
    }

    if (ks == nks - 1) {  // head hh is done: write its rows, start afresh
      E* yh = a.y + ((b * a.nc + c) * Q) * y_row + (h_lo + hh) * HD;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = q0 + wrow + 16 * i + g + 8 * hf;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (r < Q)
              store2(yh + r * y_row + wn * (HD / 2) + 8 * j + 2 * qd,
                     acc[i][j][2 * hf], acc[i][j][2 * hf + 1]);
            acc[i][j][2 * hf] = acc[i][j][2 * hf + 1] = 0.0f;
          }
        }
    }
  }
  cp_async_wait<0>();
}

// The state kernel's warps: WM along hd, WN along d_state (NMAX columns).
template <int HD, class E>
struct SCfg {
  static constexpr int WM = HD == 16 ? 1 : (HD == 128 ? 4 : 2);
  static constexpr int WN = HD == 16 ? 4 : 2;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MT = HD / (16 * WM);  // m16 tiles of a warp
  static constexpr int NT = NMAX / (8 * WN);  // n8 tiles of a warp
  static constexpr int XS = HD + 8;           // x stage row stride
  static constexpr int BS = NMAX + 8;         // B stage row stride
  static constexpr int VEC = 16 / sizeof(E);  // elements of a 16-byte copy
  static constexpr int STAGE = KS * (XS + BS);  // elements
  static constexpr int smem_bytes =
      static_cast<int>(sizeof(E)) * STAGES * STAGE + 4 * 2 * QMAX;
  // two 256-thread blocks an SM leave 128 registers a thread: too few for
  // hd 128's two m16 tiles of accumulators and their stage sums
  static constexpr int MINB = HD == 128 ? 1 : 2;
};

template <int HD, class E>
__global__ void __launch_bounds__(SCfg<HD, E>::THREADS, SCfg<HD, E>::MINB)
    ssd_state_kernel(Args<E> a) {
  using CF = SCfg<HD, E>;
  constexpr int MT = CF::MT, NT = CF::NT, XS = CF::XS, BS = CF::BS;
  constexpr int STAGE = CF::STAGE, VEC = CF::VEC;
  extern __shared__ __align__(16) float smem[];
  E* ring = reinterpret_cast<E*>(smem);
  // [QMAX] key weights (L first)
  float* w = reinterpret_cast<float*>(ring + STAGES * STAGE);
  float* dts = w + QMAX;             // [QMAX]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int m0 = (warp / CF::WN) * MT * 16, n0 = (warp % CF::WN) * NT * 8;
  const int Q = a.Q, N = a.N;
  const long long blk = blockIdx.x;
  const int hr = static_cast<int>(blk % a.win);
  const int c = static_cast<int>((blk / a.win) % a.nc);
  const long long b = blk / (static_cast<long long>(a.win) * a.nc);
  const int h = a.head_offset + hr;
  const E* xh = a.x + b * a.sx_b + c * a.sx_c + h * a.sx_h;
  const E* Bp = a.B + b * a.sb_b + c * a.sb_c;

  // dt's loads stay in flight while the first stages are issued; the
  // weights are formed once stage 0 has landed
  float dtv[QMAX / 32];
  if (warp == 0)
    load_dt(dtv, a.dt + b * a.sd_b + c * a.sd_c + h * a.sd_h, a.sd_q, Q,
            lane);
  const int total = (Q + KS - 1) / KS;
  const bool xv = a.sx_q % VEC == 0 && aligned16(xh);
  const bool bv = a.sb_q % VEC == 0 && aligned16(Bp);
  auto load = [&](int s) {
    E* st = ring + (s % STAGES) * STAGE;
    const int t0 = s * KS;
    load_block<KS, HD, XS, CF::THREADS>(st, xh + t0 * a.sx_q, a.sx_q, Q - t0,
                                        HD, xv);
    load_block<KS, NMAX, BS, CF::THREADS>(st + KS * XS, Bp + t0 * a.sb_q,
                                          a.sb_q, Q - t0, N, bv);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  float acc[MT][NT][4] = {};
  for (int s = 0; s < total; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < total) load(s + STAGES - 1);
    cp_async_commit();
    if (s == 0) {  // L, then w in its place
      if (warp == 0) {
        scan_L(dtv, a.A[h], w, dts, lane);
        const float last = w[Q - 1];
        __syncwarp();  // every lane has read L[Q - 1] before it is replaced
        for (int t = lane; t < QMAX; t += 32)
          w[t] = t < Q ? __fmul_rn(__expf(last - w[t]), dts[t]) : 0.0f;
      }
      __syncthreads();
    }
    if (n0 >= N) continue;  // a warp past d_state waits at the barriers
    const E* Xs = ring + (s % STAGES) * STAGE;
    const E* Bs = Xs + KS * XS;
    float t[MT][NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS / 8; ++kk) {
      const int tq = 8 * kk + qd;  // positions tq and tq + 4 of the stage
      const float w0 = w[s * KS + tq], w1 = w[s * KS + tq + 4];
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const E* xc = Xs + tq * XS + m0 + 16 * i + g;
        split_tf32(__fmul_rn(to_f32(xc[0]), w0), ab[i][0], as[i][0]);
        split_tf32(__fmul_rn(to_f32(xc[8]), w0), ab[i][1], as[i][1]);
        split_tf32(__fmul_rn(to_f32(xc[4 * XS]), w1), ab[i][2], as[i][2]);
        split_tf32(__fmul_rn(to_f32(xc[4 * XS + 8]), w1), ab[i][3],
                   as[i][3]);
      }
      uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {  // columns past N are zero-filled
        const E* bc = Bs + tq * BS + n0 + 8 * j + g;
        split_tf32(to_f32(bc[0]), bb[j][0], bs[j][0]);
        split_tf32(to_f32(bc[4 * BS]), bb[j][1], bs[j][1]);
      }
      mma3_tiles<MT, NT>(t, ab, as, bb, bs);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += t[i][j][e];
  }
  cp_async_wait<0>();
  float* sp = a.states + (blk * HD) * N;  // [Bt, nc, win, hd, N] contiguous
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = m0 + 16 * i + g + 8 * hf;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + 8 * j + 2 * qd;
        if (n < N) sp[p * N + n] = acc[i][j][2 * hf];
        if (n + 1 < N) sp[p * N + n + 1] = acc[i][j][2 * hf + 1];
      }
    }
}

template <int HD, class E>
int launch(const Args<E>& a, int Bt, cudaStream_t s) {
  const int nqt = (a.Q + TQ - 1) / TQ;
  const int ngr = (a.win + HG - 1) / HG;
  const int hg = (a.win + ngr - 1) / ngr;  // heads a block serves
  const int nj = nqt * TQ / 8;             // n8 key tiles of the strip
  const long long yblocks = static_cast<long long>(nqt) * Bt * a.nc * ngr;
  const int ysmem =
      4 * (YCfg<HD, E>::fixed_floats() + 4 * nj * 32 * 4);
  const auto yk = ssd_y_kernel<HD, E>;
  cudaError_t e = cudaFuncSetAttribute(
      yk, cudaFuncAttributeMaxDynamicSharedMemorySize, ysmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  yk<<<static_cast<unsigned>(yblocks), YCfg<HD, E>::THREADS, ysmem, s>>>(
      a, nqt, ngr, hg, nj);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto sk = ssd_state_kernel<HD, E>;
  e = cudaFuncSetAttribute(sk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SCfg<HD, E>::smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  sk<<<static_cast<unsigned>(static_cast<long long>(Bt) * a.nc * a.win),
       SCfg<HD, E>::THREADS, SCfg<HD, E>::smem_bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Checks the sizes and launches both kernels at head_dim hd.
template <class E>
int run(const E* x, const E* dt, const float* A, const E* B, const E* C,
        E* y, float* states, long long sx_b, long long sx_c, long long sx_q,
        long long sx_h, long long sd_b, long long sd_c, long long sd_q,
        long long sd_h, long long sb_b, long long sb_c, long long sb_q,
        long long sc_b, long long sc_c, long long sc_q, int Bt, int nc, int Q,
        int nh, int hd, int N, int head_offset, int win, void* stream) {
  const long long blocks = static_cast<long long>(Bt) * nc * win;
  if (Bt < 1 || nc < 1 || Q < 1 || Q > QMAX || N < 1 || N > NMAX ||
      win < 1 || head_offset < 0 || head_offset + win > nh ||
      4 * blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<E> a{x,    dt,   A,    B,    C,    y,    states, sx_b, sx_c,
                  sx_q, sx_h, sd_b, sd_c, sd_q, sd_h, sb_b,   sb_c, sb_q,
                  sc_b, sc_c, sc_q, nc,   Q,    N,    win,    head_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(a, Bt, s);
    case 32:
      return launch<32>(a, Bt, s);
    case 64:
      return launch<64>(a, Bt, s);
    case 128:
      return launch<128>(a, Bt, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x [Bt, nc, Q, nh, hd] (unit stride along hd), dt [Bt, nc, Q, nh], A [nh]
// (contiguous), B and C [Bt, nc, Q, N] (unit stride along N); strides in
// elements.  Writes y [Bt, nc, Q, win, hd] and states [Bt, nc, win, hd, N],
// both contiguous, for heads head_offset .. head_offset + win - 1.
// Q <= 256, N <= 128, hd one of 16, 32, 64, 128.  Returns the CUDA error of
// the launches (0 on success).
extern "C" int ssd_chunk_intra_fwd(
    const float* x, const float* dt, const float* A, const float* B,
    const float* C, float* y, float* states, long long sx_b, long long sx_c,
    long long sx_q, long long sx_h, long long sd_b, long long sd_c,
    long long sd_q, long long sd_h, long long sb_b, long long sb_c,
    long long sb_q, long long sc_b, long long sc_c, long long sc_q, int Bt,
    int nc, int Q, int nh, int hd, int N, int head_offset, int win,
    void* stream) {
  return run(x, dt, A, B, C, y, states, sx_b, sx_c, sx_q, sx_h, sd_b, sd_c,
             sd_q, sd_h, sb_b, sb_c, sb_q, sc_b, sc_c, sc_q, Bt, nc, Q, nh,
             hd, N, head_offset, win, stream);
}

// The bf16 arm: x, dt, B, C and y bf16, A and the states f32; the same
// layout rules.
extern "C" int ssd_chunk_intra_fwd_bf16(
    const bf16* x, const bf16* dt, const float* A, const bf16* B,
    const bf16* C, bf16* y, float* states, long long sx_b, long long sx_c,
    long long sx_q, long long sx_h, long long sd_b, long long sd_c,
    long long sd_q, long long sd_h, long long sb_b, long long sb_c,
    long long sb_q, long long sc_b, long long sc_c, long long sc_q, int Bt,
    int nc, int Q, int nh, int hd, int N, int head_offset, int win,
    void* stream) {
  return run(x, dt, A, B, C, y, states, sx_b, sx_c, sx_q, sx_h, sd_b, sd_c,
             sd_q, sd_h, sb_b, sb_c, sb_q, sc_b, sc_c, sc_q, Bt, nc, Q, nh,
             hd, N, head_offset, win, stream);
}
