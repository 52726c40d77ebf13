// The intra-chunk block of Mamba-2's SSD mixer, f32 and bf16, on Hopper's
// tensor cores.
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
// executed for the 0.215 the data needs).  Two kernels run behind the f32
// entry point, one behind the bf16 one, on the caller's stream.
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
// ssd_state_kernel forms S, one block per (batch, chunk, head), 4 warps
// (8 at hd 128): a 3xTF32 product hd x N over the chunk's positions, A =
// (x * w)^T with the key weight w_t = exp(L_{Q-1} - L_t) * dt_t computed
// once per (t, head), B the chunk's B rows, through a 3-deep cp.async ring.
//
// In both, the products of a stage go to the tensor core one kind at a
// time across all of a warp's tiles (mma3_tiles), so consecutive mma never
// wait on each other's accumulator.
//
// The bf16 arm (ssd_chunk_intra_fwd_bf16) takes x, dt, B and C in bf16 (A
// in f32) and writes y in bf16, the states in f32, as the Pallas body
// does: it widens its inputs, computes in f32 and writes y in x's dtype.
// It has one kernel of its own, ssd_bf16_kernel, on bf16 mma.sync
// m16n8k16 (no TF32): C B^T multiplies two bf16 operands, exact in one
// pass; M x and the state multiply an f32 weight by bf16 x, as two bf16
// passes on the weighted operand's parts hi = bf16(v) and lo = bf16(v -
// hi), within 2^-17 of v (flash attention's P, flash_attn.cu): M's parts
// are the A fragments of M x, built once a stage into shared memory, and
// the state weights x (x w_t, split as its fragments are read) against B's
// columns.  A block owns a (batch, chunk, head group) and a part of it: two
// query tiles whose key counts add up to the same for every part (tiles p
// and nqt - 1 - p) and a 64-column slice of the state (all of it where
// d_state <= 16).  It forms its tiles' C B^T strips once, then walks every
// key of each head once in 32-deep stages of x and its B columns, adding
// both y's and the state's products from the same x stage, so x is read
// once for y and the state alike; a chunk's parts run side by side and
// advance through its heads together, so the second part reads x from L2.
// Where a call has few chunks, heads go in smaller groups, so that the grid
// fills the card.  At
// the prefill layer above the bf16 data is 2.56 GB: x and y 1.61, the f32
// states 0.81, B and C 0.13, dt 0.01 (0.765 ms at 3.35 TB/s); the
// operations, C B^T in one pass and M x and the state in two, are 0.42
// TFLOP (0.43 ms at 989 TFLOP/s): bytes bound it.
//
// In all three kernels, L is a warp's scan of dt * A (each
// product rounded, as the body's dA; every weight a difference of L, never
// a sum over (t, q]): it rounds its partial sums in another order than the
// plain version's sequential cumsum, which at |L| in the hundreds moves y by
// about 1e-5 of its largest value, inside the 1e-4 the kernel is held to
// (a sequential cumsum a head would cost a millisecond at the prefill
// shape).  Copies are 16 bytes where the rows allow it (row stride a
// multiple of 4 floats, or 8 bf16, 16-byte aligned start), else 4 bytes
// (bf16: element by element, with plain loads), the ragged edges
// zero-filled, and nothing past a chunk or d_state is read.  No split of a
// contraction across blocks and no atomics: one block sums each output in
// a fixed order, so a launch gives the same bits every time.
#include <cuda_runtime.h>

#include <algorithm>
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
// loads into registers, which may stay in flight across a barrier.
__device__ __forceinline__ void load_dt(float (&v)[QMAX / 32],
                                        const float* dtp, long long sd_q,
                                        int Q, int lane) {
#pragma unroll
  for (int i = 0; i < QMAX / 32; ++i) {
    const int t = lane * (QMAX / 32) + i;
    v[i] = t < Q ? dtp[t * sd_q] : 0.0f;
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


template <int HD>
struct YCfg {
  static constexpr int WM = 4;          // warps along the 64 rows
  static constexpr int WN = 2;          // warps along hd
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MT = 4 / WM;     // m16 tiles of a warp
  static constexpr int NT = HD / 16;    // n8 tiles of a warp (half of hd)
  // x stage row stride: the permuted fragment reads hit 32 banks
  static constexpr int XS = HD + 4;
  static constexpr int CB_S = CB_BK + 4;  // C, B stages
  static constexpr int VEC = 4;           // floats of a 16-byte copy
  static constexpr int CB_STAGE = 2 * TQ * CB_S;  // floats
  static constexpr int X_STAGE = KS * XS;
  static constexpr int XSTAGES = 4;  // the x ring's depth
  // the ring, a multiple of 4 floats (the tables stay 16-byte aligned)
  static constexpr int RING = (std::max(STAGES * CB_STAGE,
                                        XSTAGES * X_STAGE) + 3) / 4 * 4;
  static constexpr int TABS = 4 * QMAX;  // L, dt, u, u8 of a head
  static constexpr int fixed_floats() { return RING + 2 * TABS; }
};

template <int HD>
__global__ void __launch_bounds__(YCfg<HD>::THREADS, 2)
    ssd_y_kernel(Args<float> a, int nqt, int ngr, int hg, int nj) {
  using CF = YCfg<HD>;
  constexpr int MT = CF::MT, NT = CF::NT, XS = CF::XS, CB_S = CF::CB_S;
  constexpr int THREADS = CF::THREADS, TABS = CF::TABS, VEC = CF::VEC;
  constexpr int XST = CF::XSTAGES, XSTAGE = CF::X_STAGE;
  constexpr int STAGE = CF::CB_STAGE;     // the C B^T phase's ring slots
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                     // CF::RING floats
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

  const float* Cp = a.C + b * a.sc_b + c * a.sc_c;
  const float* Bp = a.B + b * a.sb_b + c * a.sb_c;
  const float* xb = a.x + b * a.sx_b + c * a.sx_c;
  const float* dtb = a.dt + b * a.sd_b + c * a.sd_c;
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
      float* st = ring + (s % STAGES) * STAGE;
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
      const float* Cs = ring + (s % STAGES) * STAGE;
      const float* Bs = Cs + TQ * CB_S;
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
    const float* xh = head_x(hh);
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
    const float* Xs = ring + (s % XST) * XSTAGE;

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
          const float* xc =
              Xs + (8 * h + 2 * qd) * XS + wn * (HD / 2) + 8 * j + g;
          split_tf32(xc[0], bb[j][0], bs[j][0]);   // key t
          split_tf32(xc[XS], bb[j][1], bs[j][1]);  // key t + 1
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
      float* yh = a.y + ((b * a.nc + c) * Q) * y_row + (h_lo + hh) * HD;
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
template <int HD>
struct SCfg {
  static constexpr int WM = HD == 16 ? 1 : (HD == 128 ? 4 : 2);
  static constexpr int WN = HD == 16 ? 4 : 2;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MT = HD / (16 * WM);  // m16 tiles of a warp
  static constexpr int NT = NMAX / (8 * WN);  // n8 tiles of a warp
  static constexpr int XS = HD + 8;           // x stage row stride
  static constexpr int BS = NMAX + 8;         // B stage row stride
  static constexpr int VEC = 4;               // floats of a 16-byte copy
  static constexpr int STAGE = KS * (XS + BS);  // floats
  static constexpr int smem_bytes = 4 * (STAGES * STAGE + 2 * QMAX);
  // two 256-thread blocks an SM leave 128 registers a thread: too few for
  // hd 128's two m16 tiles of accumulators and their stage sums
  static constexpr int MINB = HD == 128 ? 1 : 2;
};

template <int HD>
__global__ void __launch_bounds__(SCfg<HD>::THREADS, SCfg<HD>::MINB)
    ssd_state_kernel(Args<float> a) {
  using CF = SCfg<HD>;
  constexpr int MT = CF::MT, NT = CF::NT, XS = CF::XS, BS = CF::BS;
  constexpr int STAGE = CF::STAGE, VEC = CF::VEC;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* w = ring + STAGES * STAGE;  // [QMAX] key weights (L first)
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
  const float* xh = a.x + b * a.sx_b + c * a.sx_c + h * a.sx_h;
  const float* Bp = a.B + b * a.sb_b + c * a.sb_c;

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
    float* st = ring + (s % STAGES) * STAGE;
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
    const float* Xs = ring + (s % STAGES) * STAGE;
    const float* Bs = Xs + KS * XS;
    float t[MT][NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS / 8; ++kk) {
      const int tq = 8 * kk + qd;  // positions tq and tq + 4 of the stage
      const float w0 = w[s * KS + tq], w1 = w[s * KS + tq + 4];
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* xc = Xs + tq * XS + m0 + 16 * i + g;
        split_tf32(__fmul_rn(xc[0], w0), ab[i][0], as[i][0]);
        split_tf32(__fmul_rn(xc[8], w0), ab[i][1], as[i][1]);
        split_tf32(__fmul_rn(xc[4 * XS], w1), ab[i][2], as[i][2]);
        split_tf32(__fmul_rn(xc[4 * XS + 8], w1), ab[i][3], as[i][3]);
      }
      uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {  // columns past N are zero-filled
        const float* bc = Bs + tq * BS + n0 + 8 * j + g;
        split_tf32(bc[0], bb[j][0], bs[j][0]);
        split_tf32(bc[4 * BS], bb[j][1], bs[j][1]);
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

// ---- the bf16 arm: one kernel on bf16 mma.sync m16n8k16 ----------------

// A block owns (batch, chunk, head group, part).  Part p takes the query
// tiles p and nqt - 1 - p (one tile where they meet, none past: every
// pair sees the same number of key tiles, so the parts of a chunk advance
// through its heads together and the second reads x from L2) and the
// state's columns [NB p, NB p + NB) (NB 64, or 16 where d_state <= 16, all
// in part 0).  It walks every key of each head once, in BK-deep stages of x
// and of its B columns, and forms from each stage both y's rows and the
// state.  Every warp does both: y for a 16-row tile of each query tile (the
// same key count for every warp) and half of hd, and the state for a
// 16-row tile of hd and SNT n8 tiles of the part's columns; the two
// products of a k16 step are independent, so they issue together.  A
// stage's M is built once: the two warps of a row tile build one k16 step
// each, into shared memory in the A fragments' lane order, and both read it
// back after a barrier.  Each head's contraction (at most 16 k16 steps of
// two passes) is summed on the tensor core directly: the card's checks at
// Q 256 hold it within one bf16 ulp plus 1e-4, and the stage sums of the
// other kernels would cost the registers that keep two blocks on an SM.
template <int HD, int NB>
struct BCfg {
  static constexpr int NW = 8;                  // warps
  static constexpr int THREADS = 32 * NW;
  static constexpr int NT = HD / 16;            // y: n8 tiles of a warp
  static constexpr int SWM = HD / 16;           // state: warps along hd
  static constexpr int SWN = NW / SWM;          // and along NB
  static constexpr int SNT = NB / 8 / SWN > 0 ? NB / 8 / SWN : 1;
  static constexpr int BK = 32;             // keys of an x (and B) stage
  static constexpr int XS = HD + 8;         // x stage row stride (elements)
  static constexpr int BS = NB + 8;         // B stage row stride
  static constexpr int CS = CB_BK + 8;      // C, B rows of a C B^T stage
  static constexpr int CNT = 32 / NW;       // C B^T: n8 key tiles of a warp
  // the cp.async ring: RINGS head stages, or CRINGS C B^T stages
  static constexpr int RINGS = 2, CRINGS = 3;
  static constexpr int STAGE = BK * (XS + BS);    // elements
  static constexpr int CSTAGE = 2 * TQ * CS;
  static constexpr int RING_E = RINGS * STAGE > CRINGS * CSTAGE
                                    ? RINGS * STAGE
                                    : CRINGS * CSTAGE;
  static constexpr int RING = (RING_E * 2 + 15) / 16 * 4;  // in floats
  static constexpr int TABS = 4 * QMAX;     // L, dt, u, w of a head
  // a stage's M in two bf16 parts, in the A fragments' lane order: [2
  // tiles][4 m16][BK / 16 k16 steps][32 lanes][hi 4, lo 4] 32-bit words
  static constexpr int MBUF = 2 * 4 * (BK / 16) * 32 * 8;
  static constexpr int fixed_floats() { return RING + 2 * TABS + MBUF; }
  // two blocks an SM (128 registers a thread) below hd 128
  static constexpr int MINB = HD > 64 ? 1 : 2;
};

// The bf16 kernel's per-head tables, in two steps: L and dt (one warp's
// scan), then u[t] = exp(L[ref] - L[t]) * dt_t with ref = min(t | 15,
// Q - 1), the last key of t's k16 step, and the state's key weights w[t] =
// exp(L[Q - 1] - L[t]) * dt_t, for the keys t0, t0 + step, ... < t1.
__device__ __forceinline__ void bf16_weights(float* tab, int Q, int t0,
                                             int t1, int step) {
  const float* L = tab;
  const float* dts = tab + QMAX;
  float* u = tab + 2 * QMAX;
  float* w = tab + 3 * QMAX;
  const float last = L[Q - 1];
  for (int t = t0; t < t1; t += step) {
    const bool in = t < Q;
    u[t] = in ? __fmul_rn(__expf(L[min(t | 15, Q - 1)] - L[t]), dts[t])
              : 0.0f;
    w[t] = in ? __fmul_rn(__expf(last - L[t]), dts[t]) : 0.0f;
  }
}

// A quad's 4 x 4 words transposed: lane q's w[k] becomes lane k's w[q]
// (two rounds of exchanges between lanes q ^ 1, then q ^ 2).
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int q) {
#pragma unroll
  for (int bit = 1; bit <= 2; bit <<= 1) {
    const bool up = q & bit;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (p & bit) continue;  // the pairs (p, p + bit)
      const uint32_t send = up ? w[p] : w[p + bit];
      const uint32_t got = __shfl_xor_sync(0xffffffffu, send, bit);
      if (up)
        w[p] = got;
      else
        w[p + bit] = got;
    }
  }
}

template <int HD, int NB>
__global__ void __launch_bounds__(BCfg<HD, NB>::THREADS, BCfg<HD, NB>::MINB)
    ssd_bf16_kernel(Args<bf16> a, int nqt, int parts, int ngr, int hg) {
  using CF = BCfg<HD, NB>;
  constexpr int NT = CF::NT, XS = CF::XS, BS = CF::BS;
  constexpr int CS = CF::CS, SNT = CF::SNT, RINGS = CF::RINGS;
  constexpr int TABS = CF::TABS, THREADS = CF::THREADS, BK = CF::BK;
  static_assert(BK == 32, "a warp builds M for the k16 step wn");
  constexpr int NW = CF::NW;
  extern __shared__ __align__(16) float smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* tabs = smem + CF::RING;  // [2][TABS], by head parity
  uint32_t* mbuf = reinterpret_cast<uint32_t*>(tabs + 2 * TABS);
  float* cbf = tabs + 2 * TABS + CF::MBUF;  // the C B^T strips, warps' order

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int Q = a.Q, N = a.N;
  // the part varies fastest: a chunk's parts run side by side
  const int part = static_cast<int>(blockIdx.x % parts);
  const long long rest = blockIdx.x / parts;
  const int gr = static_cast<int>(rest % ngr);
  const int c = static_cast<int>((rest / ngr) % a.nc);
  const long long b = rest / (static_cast<long long>(ngr) * a.nc);
  const int h_lo = gr * hg, h_n = min(hg, a.win - h_lo);
  const int qa = part, qb = nqt - 1 - part;
  const int ntile = qa < qb ? 2 : (qa == qb ? 1 : 0);
  const int n0s = part * NB;  // the state's first column
  const bool st = n0s < N;
  if (!ntile && !st) return;

  const bf16* Cp = a.C + b * a.sc_b + c * a.sc_c;
  const bf16* Bp = a.B + b * a.sb_b + c * a.sb_c;
  const bf16* xb = a.x + b * a.sx_b + c * a.sx_c;
  const bf16* dtb = a.dt + b * a.sd_b + c * a.sd_c;
  auto head_dt = [&](int hh) {
    return dtb + static_cast<long long>(a.head_offset + h_lo + hh) * a.sd_h;
  };
  auto head_x = [&](int hh) {
    return xb + static_cast<long long>(a.head_offset + h_lo + hh) * a.sx_h;
  };
  const int nkeys = st ? Q : min(TQ * (qb + 1), Q);  // keys the block needs
  const int nks = (nkeys + BK - 1) / BK;
  // a head's dt on its way to the tables: element tid, one a thread
  auto dt_at = [&](int hh) {
    return threadIdx.x < Q ? __bfloat162float(head_dt(hh)[threadIdx.x * a.sd_q])
                           : 0.0f;
  };
  float dtr = dt_at(0);

  // the strips: tile slot s (query tile qs) keeps, for its m16 tile m, the
  // 2 (4 qs + m + 1) n8 key tiles of keys 0 .. 64 qs + 16 m + 15
  auto strip = [&](int s, int m, int j) {
    const int qs = s ? qb : qa, base = s ? 32 * qa + 20 : 0;
    return cbf + ((base + 8 * qs * m + m * (m + 1) + j) * 32 + lane) * 4;
  };

  // ---- C B^T of the block's query tiles, one exact bf16 pass: warps wm
  // along 16-row tiles, wn along CNT n8 tiles of a 64-key tile; d_state in
  // CB_BK-deep stages
  if (ntile) {
    constexpr int CNT = CF::CNT;
    const int wm = warp & 3, wn = warp >> 2;
    const int ns = (N + CB_BK - 1) / CB_BK;
    const int kt_a = qa + 1;  // key tiles of slot 0
    const int ctotal = (ntile == 2 ? qa + qb + 2 : kt_a) * ns;
    const bool cv = a.sc_q % 8 == 0 && aligned16(Cp);
    const bool bv = a.sb_q % 8 == 0 && aligned16(Bp);
    auto load = [&](int s) {
      const int u = s / ns, sl = u >= kt_a, kt = sl ? u - kt_a : u;
      const int n0 = (s % ns) * CB_BK, q0 = TQ * (sl ? qb : qa);
      bf16* stp = ring + (s % CF::CRINGS) * CF::CSTAGE;
      load_block<TQ, CB_BK, CS, THREADS>(stp, Cp + q0 * a.sc_q + n0, a.sc_q,
                                         Q - q0, N - n0, cv);
      load_block<TQ, CB_BK, CS, THREADS>(stp + TQ * CS,
                                         Bp + kt * TQ * a.sb_q + n0, a.sb_q,
                                         Q - kt * TQ, N - n0, bv);
    };
#pragma unroll
    for (int s = 0; s < CF::CRINGS - 1; ++s) {
      if (s < ctotal) load(s);
      cp_async_commit();
    }
    float cb[CNT][4] = {};
    for (int s = 0; s < ctotal; ++s) {
      cp_async_wait<CF::CRINGS - 2>();
      __syncthreads();
      if (s + CF::CRINGS - 1 < ctotal) load(s + CF::CRINGS - 1);
      cp_async_commit();
      const bf16* Cs = ring + (s % CF::CRINGS) * CF::CSTAGE;
      const bf16* Bs = Cs + TQ * CS;
      uint32_t af[4];
      ldmatrix_x4_bf16(af, Cs + (16 * wm + (lane & 15)) * CS + (lane >> 4) * 8);
      float t[CNT][4] = {};
#pragma unroll
      for (int j = 0; j < CNT; j += 2) {
        uint32_t v[4];
        ldmatrix_x4_bf16(v, Bs + (8 * (CNT * wn + j) + (lane & 7) +
                                  (lane >> 4) * 8) * CS +
                                ((lane >> 3) & 1) * 8);
        const uint32_t b0[2] = {v[0], v[1]}, b1[2] = {v[2], v[3]};
        mma_bf16(t[j], af, b0);
        mma_bf16(t[j + 1], af, b1);
      }
#pragma unroll
      for (int j = 0; j < CNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) cb[j][e] += t[j][e];
      if (s % ns == ns - 1) {  // a key tile is done: park what rows see
        const int u = s / ns, sl = u >= kt_a, kt = sl ? u - kt_a : u;
        const int nvis = 2 * (4 * (sl ? qb : qa) + wm + 1);
#pragma unroll
        for (int j = 0; j < CNT; ++j) {
          const int jj = 8 * kt + CNT * wn + j;
          if (jj < nvis)
            *reinterpret_cast<float4*>(strip(sl, wm, jj)) =
                make_float4(cb[j][0], cb[j][1], cb[j][2], cb[j][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) cb[j][e] = 0.0f;
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the strips are complete; the ring is free
  }

  // ---- heads: every key the block needs, BK-deep stages of x and B.  The
  // threads copy a stage's x in 16-byte chunks (XCH of them) and its B
  // columns (BCH), where the rows allow 16-byte copies (else load_block's
  // element by element copy), RINGS - 1 stages ahead of the products
  // (across heads)
  constexpr int XCPR = HD / 8, XCH = BK * XCPR;
  constexpr int BCPR = NB / 8, BCH = BK * BCPR;
  const int tid = threadIdx.x;
  const bf16* Bn = Bp + n0s;
  const bool bv = a.sb_q % 8 == 0 && aligned16(Bn);
  // the copy cursor: head lh, stage lk
  int lh = 0, lk = 0, slot_l = 0;
  auto load_next = [&]() {
    if (lh < h_n) {
      bf16* stp = ring + slot_l * CF::STAGE;
      const int t0 = lk * BK, left = Q - t0;  // rows from this stage on
      const bf16* lx = head_x(lh) + t0 * a.sx_q;
      const bf16* lb = Bn + t0 * a.sb_q;
      if (a.sx_q % 8 == 0 && aligned16(lx)) {
#pragma unroll
        for (int q = tid; q < XCH; q += THREADS) {
          const int r = q / XCPR, cc = (q % XCPR) * 8;
          cp_async16_bf16(stp + r * XS + cc,
                          r < left ? lx + r * a.sx_q + cc : lx,
                          r < left ? 16 : 0);
        }
      } else {
        load_block<BK, HD, XS, THREADS>(stp, lx, a.sx_q, left, HD, false);
      }
      if (st) {
        if (bv) {
#pragma unroll
          for (int q = tid; q < BCH; q += THREADS) {
            const int r = q / BCPR, cc = (q % BCPR) * 8;
            const int nb = 2 * min(max(N - n0s - cc, 0), 8);
            cp_async16_bf16(stp + BK * XS + r * BS + cc,
                            r < left && nb ? lb + r * a.sb_q + cc : lb,
                            r < left ? nb : 0);
          }
        } else {
          load_block<BK, NB, BS, THREADS>(stp + BK * XS, lb, a.sb_q, left,
                                          N - n0s, false);
        }
      }
      if (++lk == nks) lk = 0, ++lh;
    }
    slot_l = (slot_l + 1) & (RINGS - 1);
    cp_async_commit();
  };
  // a head's tables from its dt in the dts slot: one warp's scan, then
  // u and w
  auto scan_dt = [&](float* tab, int hh) {
    float v[QMAX / 32];
#pragma unroll
    for (int i = 0; i < QMAX / 32; ++i)
      v[i] = tab[QMAX + lane * (QMAX / 32) + i];
    scan_L(v, a.A[a.head_offset + h_lo + hh], tab, tab + QMAX, lane);
  };
  if (threadIdx.x < QMAX) tabs[QMAX + threadIdx.x] = dtr;  // head 0's
  __syncthreads();
  if (warp == 0) {
    scan_dt(tabs, 0);
    bf16_weights(tabs, Q, lane, QMAX, 32);
  }
  for (int s = 0; s < RINGS - 1; ++s) load_next();

  // every warp: y's m16 tile wm of slot 0 and 3 - wm of slot 1 (the same
  // key count for every warp), columns wn HD / 2 ..; the state's rows 16
  // sm of hd, n8 tiles sn SNT .. of the part's columns
  const int wm = warp >> 1, wn = warp & 1;
  int r0[2];
  r0[0] = ntile ? TQ * qa + 16 * wm : -1;  // -1: none
  r0[1] = ntile == 2 ? TQ * qb + 16 * (3 - wm) : -1;
  const float* sp0 = strip(0, wm, 0);
  const float* sp1 = strip(1, 3 - wm, 0);
  const int sm = warp % CF::SWM, sn = warp / CF::SWM;
  const int sc0 = n0s + 8 * sn * SNT;  // the warp's first state column
  const bool sw = st && sn * SNT < NB / 8 && sc0 < N;
  const long long y_row = static_cast<long long>(a.win) * HD;
  float acc[2][NT][4] = {}, sacc[SNT][4] = {};
  int slot = 0;
  for (int hh = 0; hh < h_n; ++hh) {
    const float* Lh = tabs + (hh & 1) * TABS;
    const float* dth = Lh + QMAX;
    const float* uh = Lh + 2 * QMAX;
    const float* wh = Lh + 3 * QMAX;
    float* nt = tabs + ((hh + 1) & 1) * TABS;  // the next head's
    const bool next = hh + 1 < h_n;
    float La[2] = {0.0f, 0.0f}, Lb[2] = {0.0f, 0.0f};  // L of rows ra, rb
    for (int ks = 0; ks < nks; ++ks) {
      cp_async_wait<RINGS - 2>();
      __syncthreads();
      load_next();
      const int t0 = ks * BK;
      if (ks == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (r0[i] >= 0) La[i] = Lh[r0[i] + g], Lb[i] = Lh[r0[i] + g + 8];
      }
      // the next head's tables, into the buffer head hh - 1 used: every
      // thread loads an element of its dt at this head's first stage and
      // parks it three stages before the last; a warp scans it at the
      // stage before the last, where every warp then forms its share of u
      // and w (a chunk of fewer stages does all at its last, with barriers
      // between)
      if (next) {
        if (ks == 0) dtr = dt_at(hh + 1);
        if (nks >= 3) {
          if (ks == nks - 3 && threadIdx.x < QMAX) nt[QMAX + threadIdx.x] = dtr;
          if (ks == nks - 2 && warp == hh % NW) scan_dt(nt, hh + 1);
          if (ks == nks - 1)
            bf16_weights(nt, Q, warp * 32 + lane, QMAX, 32 * NW);
        } else if (ks == nks - 1) {
          if (threadIdx.x < QMAX) nt[QMAX + threadIdx.x] = dtr;
          __syncthreads();
          if (warp == 0) scan_dt(nt, hh + 1);
          __syncthreads();
          bf16_weights(nt, Q, warp * 32 + lane, QMAX, 32 * NW);
        }
      }
      const bf16* Xs = ring + slot * CF::STAGE;
      const bf16* Bs = Xs + BK * XS;
      slot = (slot + 1) & (RINGS - 1);

      // M of this stage in two bf16 parts: warp (wm, wn) builds the k16
      // step wn of its two m16 tiles (two neighbouring n8 tiles of the
      // strip, rows g, g + 8 and keys 2 qd, 2 qd + 1 of each, are a k16
      // step's A fragment in the mma's own order), for both warps of its
      // rows; keys after a tile's rows are skipped
      {
        const int k0 = t0 + 16 * wn;
        const int tk = k0 + 2 * qd;  // this lane's keys tk, tk + 1, + 8, + 9
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (k0 > r0[i]) continue;  // the step follows the tile's rows
          const int ra = r0[i] + g, rb = ra + 8;
          const float* cp = (i ? sp1 : sp0) + (k0 >> 3) * 128;
          const float4 c0 = *reinterpret_cast<const float4*>(cp);
          const float4 c1 = *reinterpret_cast<const float4*>(cp + 128);
          // (row, key): c0 (ra, tk), (ra, tk+1), (rb, tk), (rb, tk+1); c1
          // the same at tk + 8
          float m[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
          if (k0 < r0[i]) {  // every key of the step precedes every row
            const float Lr = Lh[min(k0 + 15, Q - 1)];
            const float fa = __expf(La[i] - Lr), fb = __expf(Lb[i] - Lr);
            const float2 u0 = *reinterpret_cast<const float2*>(uh + tk);
            const float2 u1 = *reinterpret_cast<const float2*>(uh + tk + 8);
            m[0] = __fmul_rn(m[0], __fmul_rn(fa, u0.x));
            m[1] = __fmul_rn(m[1], __fmul_rn(fa, u0.y));
            m[2] = __fmul_rn(m[2], __fmul_rn(fb, u0.x));
            m[3] = __fmul_rn(m[3], __fmul_rn(fb, u0.y));
            m[4] = __fmul_rn(m[4], __fmul_rn(fa, u1.x));
            m[5] = __fmul_rn(m[5], __fmul_rn(fa, u1.y));
            m[6] = __fmul_rn(m[6], __fmul_rn(fb, u1.x));
            m[7] = __fmul_rn(m[7], __fmul_rn(fb, u1.y));
          } else {  // on the diagonal: the mask before the exponential
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int r = (e & 2) ? rb : ra;
              const float Lq = (e & 2) ? Lb[i] : La[i];
              const int tt = tk + (e & 1) + (e & 4) * 2;
              m[e] = tt <= r ? __fmul_rn(__fmul_rn(m[e], __expf(Lq - Lh[tt])),
                                         dth[tt])
                             : 0.0f;
            }
          }
          // a0 (ra, tk..), a1 (rb, tk..), a2 and a3 the same at tk + 8
          uint4 hi, lo;
          split_bf16x2(m[0], m[1], hi.x, lo.x);
          split_bf16x2(m[2], m[3], hi.y, lo.y);
          split_bf16x2(m[4], m[5], hi.z, lo.z);
          split_bf16x2(m[6], m[7], hi.w, lo.w);
          uint32_t* mp = mbuf + (((i * 4 + (i ? 3 - wm : wm)) * (BK / 16) +
                                  wn) * 32 + lane) * 8;
          *reinterpret_cast<uint4*>(mp) = hi;
          *reinterpret_cast<uint4*>(mp + 4) = lo;
        }
      }
      __syncthreads();  // the stage's M is complete

      // per k16 step: y += M x for both tiles (M's parts from the buffer,
      // x's B fragments by ldmatrix.trans), and state += (x w)^T B (x's A
      // fragments by ldmatrix.trans, hd along m and keys along k, weighted
      // by w and split into two bf16 parts; B's by ldmatrix.trans)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const int k0 = t0 + 16 * kk;
        const int tk = k0 + 2 * qd;
        if (k0 <= r0[0] || k0 <= r0[1]) {
          uint32_t xf[NT][2];
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            const bf16* xp = Xs + (16 * kk + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * XS +
                             wn * (HD / 2) + 8 * n;
            if (n + 1 < NT) {
              uint32_t v[4];
              ldmatrix_x4_trans_bf16(v, xp + (lane >> 4) * 8);
              xf[n][0] = v[0], xf[n][1] = v[1];
              xf[n + 1][0] = v[2], xf[n + 1][1] = v[3];
            } else {
              ldmatrix_x2_trans_bf16(xf[n], xp);
            }
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (k0 > r0[i]) continue;
            const uint32_t* mp = mbuf + (((i * 4 + (i ? 3 - wm : wm)) *
                                          (BK / 16) + kk) * 32 + lane) * 8;
            const uint4 h4 = *reinterpret_cast<const uint4*>(mp);
            const uint4 l4 = *reinterpret_cast<const uint4*>(mp + 4);
            const uint32_t hi[4] = {h4.x, h4.y, h4.z, h4.w};
            const uint32_t lo[4] = {l4.x, l4.y, l4.z, l4.w};
            // every hi pass, then every lo pass
#pragma unroll
            for (int n = 0; n < NT; ++n) mma_bf16(acc[i][n], hi, xf[n]);
#pragma unroll
            for (int n = 0; n < NT; ++n) mma_bf16(acc[i][n], lo, xf[n]);
          }
        }
        if (sw) {
          uint32_t xa[4];
          ldmatrix_x4_trans_bf16(xa, Xs + (16 * kk + ((lane >> 4) & 1) * 8 +
                                           (lane & 7)) * XS +
                                         16 * sm + ((lane >> 3) & 1) * 8);
          const float2 w0 = *reinterpret_cast<const float2*>(wh + tk);
          const float2 w8 = *reinterpret_cast<const float2*>(wh + tk + 8);
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // rows g, g + 8; keys tk.., tk + 8..
            const float2 xv = bf16x2_to_float2(xa[e]);
            const float2 w = e < 2 ? w0 : w8;
            split_bf16x2(__fmul_rn(xv.x, w.x), __fmul_rn(xv.y, w.y), hi[e],
                         lo[e]);
          }
          uint32_t bf[SNT][2];
#pragma unroll
          for (int j = 0; j < SNT; j += 2) {
            const bf16* bp = Bs + (16 * kk + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * BS +
                             8 * (sn * SNT + j);
            if (j + 1 < SNT) {
              uint32_t v[4];
              ldmatrix_x4_trans_bf16(v, bp + (lane >> 4) * 8);
              bf[j][0] = v[0], bf[j][1] = v[1];
              bf[j + 1][0] = v[2], bf[j + 1][1] = v[3];
            } else {
              ldmatrix_x2_trans_bf16(bf[j], bp);
            }
          }
#pragma unroll
          for (int j = 0; j < SNT; ++j) mma_bf16(sacc[j], hi, bf[j]);
#pragma unroll
          for (int j = 0; j < SNT; ++j) mma_bf16(sacc[j], lo, bf[j]);
        }
      }
    }

    // head hh is done: write its rows and state, start afresh
    const int h = h_lo + hh;
    // y: a quad's lanes hold two columns of each n8 tile of a row; where
    // NT is a multiple of 4, each group of four tiles is transposed across
    // the quad, so that a lane stores eight consecutive columns (16 bytes,
    // whole sectors per row) in place of four 4-byte pieces
    if constexpr (NT % 4 == 0) {
      bf16* yh = a.y + ((b * a.nc + c) * Q) * y_row + h * HD + wn * (HD / 2) +
                 8 * qd;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0[i] + g + 8 * hf;
#pragma unroll
          for (int n4 = 0; n4 < NT; n4 += 4) {
            uint32_t w[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const __nv_bfloat162 v = __floats2bfloat162_rn(
                  acc[i][n4 + k][2 * hf], acc[i][n4 + k][2 * hf + 1]);
              w[k] = *reinterpret_cast<const uint32_t*>(&v);
            }
            quad_transpose(w, qd);
            if (r0[i] >= 0 && r < Q)
              *reinterpret_cast<uint4*>(yh + r * y_row + 8 * n4) =
                  make_uint4(w[0], w[1], w[2], w[3]);
          }
#pragma unroll
          for (int n = 0; n < NT; ++n)
            acc[i][n][2 * hf] = acc[i][n][2 * hf + 1] = 0.0f;
        }
    } else {
      bf16* yh = a.y + ((b * a.nc + c) * Q) * y_row + h * HD + wn * (HD / 2) +
                 2 * qd;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0[i] + g + 8 * hf;
          bf16* yr = yh + r * y_row;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if (r0[i] >= 0 && r < Q)
              store2(yr + 8 * n, acc[i][n][2 * hf], acc[i][n][2 * hf + 1]);
            acc[i][n][2 * hf] = acc[i][n][2 * hf + 1] = 0.0f;
          }
        }
    }
    if (sw) {
      float* sp = a.states + (((b * a.nc + c) * a.win + h) * HD) * N;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = 16 * sm + g + 8 * hf;
#pragma unroll
        for (int j = 0; j < SNT; ++j) {
          const int n = sc0 + 8 * j + 2 * qd;
          float* d = sp + p * N + n;
          float& v0 = sacc[j][2 * hf];
          float& v1 = sacc[j][2 * hf + 1];
          if (N % 2 == 0 && n < N) {
            *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
          } else {
            if (n < N) d[0] = v0;
            if (n + 1 < N) d[1] = v1;
          }
          v0 = v1 = 0.0f;
        }
      }
    }
  }
  cp_async_wait<0>();
}

// Blocks the bf16 kernel's grid aims at (about eight per SM of an H100):
// where a call has few chunks, its heads are cut into smaller groups.
constexpr long long BF16_GRID = 8 * 132;

template <int HD, int NB>
int launch_bf16(const Args<bf16>& a, int Bt, cudaStream_t s) {
  using CF = BCfg<HD, NB>;
  const int nqt = (a.Q + TQ - 1) / TQ;
  const int parts = std::max((nqt + 1) / 2, (a.N + NB - 1) / NB);
  const long long units = static_cast<long long>(Bt) * a.nc * parts;
  // the largest part's strips (n8 key tiles of both of its query tiles)
  const int strip_n8 = nqt >= 2 ? 32 * (nqt - 1) + 40 : 20;
  const long long want = (BF16_GRID + units - 1) / units;
  const int ngr0 = static_cast<int>(std::min<long long>(
      a.win, std::max<long long>((a.win + HG - 1) / HG, want)));
  const int hg = (a.win + ngr0 - 1) / ngr0;
  const int ngr = (a.win + hg - 1) / hg;
  const long long blocks = units * ngr;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 4 * (CF::fixed_floats() + strip_n8 * 32 * 4);
  const auto k = ssd_bf16_kernel<HD, NB>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  k<<<static_cast<unsigned>(blocks), CF::THREADS, smem, s>>>(a, nqt, parts,
                                                             ngr, hg);
  return static_cast<int>(cudaGetLastError());
}

// The f32 arm at head_dim HD: its two kernels.
template <int HD>
int launch_hd(const Args<float>& a, int Bt, cudaStream_t s) {
  const int nqt = (a.Q + TQ - 1) / TQ;
  const int ngr = (a.win + HG - 1) / HG;
  const int hg = (a.win + ngr - 1) / ngr;  // heads a block serves
  const int nj = nqt * TQ / 8;             // n8 key tiles of the strip
  const long long yblocks = static_cast<long long>(nqt) * Bt * a.nc * ngr;
  const int ysmem = 4 * (YCfg<HD>::fixed_floats() + 4 * nj * 32 * 4);
  const auto yk = ssd_y_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      yk, cudaFuncAttributeMaxDynamicSharedMemorySize, ysmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  yk<<<static_cast<unsigned>(yblocks), YCfg<HD>::THREADS, ysmem, s>>>(
      a, nqt, ngr, hg, nj);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto sk = ssd_state_kernel<HD>;
  e = cudaFuncSetAttribute(sk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SCfg<HD>::smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  sk<<<static_cast<unsigned>(static_cast<long long>(Bt) * a.nc * a.win),
       SCfg<HD>::THREADS, SCfg<HD>::smem_bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 arm at head_dim HD: its kernel at the state width that holds
// d_state.
template <int HD>
int launch_hd(const Args<bf16>& a, int Bt, cudaStream_t s) {
  return a.N <= 16 ? launch_bf16<HD, 16>(a, Bt, s)
                   : launch_bf16<HD, 64>(a, Bt, s);
}

// Checks the sizes and launches the arm's kernels at head_dim hd.
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
      return launch_hd<16>(a, Bt, s);
    case 32:
      return launch_hd<32>(a, Bt, s);
    case 64:
      return launch_hd<64>(a, Bt, s);
    case 128:
      return launch_hd<128>(a, Bt, s);
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

