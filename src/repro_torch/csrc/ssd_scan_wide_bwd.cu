// K4's backward at wide heads: the gradient of the SSD / decay-attention
// chunk scan at mLSTM's heads.
//
// The TPU has no kernel here: the JAX package trains mLSTM through XLA's
// autodiff of the jnp chunked_decay_attention (src/repro/models/ssm.py:45)
// that src/repro/models/ssm.py:apply_mlstm calls, while the port's forward at
// these heads is the kernel ssd_scan_wide.cu, whose gradient therefore needs
// a kernel of its own. The narrow backward (ssd_scan_bwd.cu) stops at dk,
// dv <= 128: one head's state at xlstm-1.3b (dk 1024, dv 1025) is 4.2 MB of
// f32, which no block can own, so here, as in the wide forward, it is tiled
// across blocks. The function is the narrow backward's (ssd_scan_bwd.cu, and
// the plain version ssd_scan.ssd_scan_bwd_ref), for each (b, h) and chunk n
// of Q positions, with cum the chunk's inclusive cumsum of a, tot =
// cum_{Q-1}, L_ts = exp(cum_t - cum_s) (s <= t), w_s = exp(tot - cum_s) i_s,
// H_n the state before chunk n (written by the forward) and G_n the gradient
// of the state after it:
//   S_ts = q_t . k_s,  D_ts = dy_t . v_s,  P = S L i_s,  R = D L i_s
//   dq_t = sum_s R_ts k_s + exp(cum_t) H_n dy_t
//   dk_s = sum_t R_ts q_t + w_s G_n v_s
//   dv_s = sum_t P_ts dy_t + w_s G_n^T k_s
//   di_s = sum_t S_ts D_ts L_ts + exp(tot - cum_s) k_s^T G_n v_s
//   dcum = row sums - column sums of S D L i_s, + exp(cum_t) q_t . H_n dy_t
//          at t, - w_s k_s^T G_n v_s at s, + exp(tot) <H_n, G_n> +
//          sum_s w_s k_s^T G_n v_s at Q - 1;  da = reverse cumsum of dcum
//   G_{n-1} = exp(tot_n) G_n + sum_t exp(cum_t) q_t dy_t^T,
//   G_{nc-1} = dh_final,  dh0 = G_{-1}
// over f32 q, k, v and dy (mLSTM's q, k, v are bf16 values widened; dy is
// the gradient through its normalizer, a general f32); every output f32.
//
// Products of states known to be zero are not computed: without an initial
// state H_0 = 0 (no H_0 dy_t, no <H_0, G_0>); without dh_final G_{nc-1} = 0
// (no G_{nc-1} v_s, G_{nc-1}^T k_s, and the walk starts at zero without
// reading anything); dh0 (the walk's update at chunk 0) only where the
// caller asks for it (autograd does only when there is an initial state).
// A skipped product would have added exact zeros, so no bit moves.
//
// Bound on the H100. At xlstm-1.3b's training shape (B 4, S 512, H 4, dk
// 1024, dv 1025, Q 256; no initial state, no dh_final, no dh0, as autograd
// calls it; ssd_scan.bwd_bound with q and k per head) the function needs
// 45.2 GFLOP against 302.3 MB of HBM bytes (no H_0 read, no dh0 written;
// 436.7 MB with both): 0.090 ms on the bytes, 0.674 ms with the flops on
// the ordinary f32 cores, 0.046 ms on the dense bf16 tensor cores. So
// every product runs on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulators), as in the wide forward.
//
// Accuracy, as in the wide forward. The operands that are f32 by nature,
// the gated scores P and R, the states H_n in H_n dy_t, their gradients G_n
// in G_n v_s and G_n^T k_s, and exp(cum_t) q_t in the walk's update, enter
// as two bf16 parts each (~16 bits; ssd_scan_bwd_ref(parts=2) rounds
// these as the kernel does, and one part, the fault bwd_one_part, fails
// the card check). f32 q, k, v and dy enter as three parts, which hold an
// f32 value exactly, and each operand pair takes the part products i + j <
// max(parts) (the dropped ones are ~2^-24 of a term). The emulation takes
// q, k, v and dy whole, so it is exact up to those dropped products, each
// of which holds a third part: zero for bf16-valued q, k, v (training's),
// not for dy (a general f32) or f32-valued q, k, v. A part that is zero
// over a slab of 32 positions is neither written nor multiplied: in
// training q, k and v are bf16 values, whose second and third parts are
// zero. What stays f32: the gating of S and D into P and R, from the
// accumulators; the row and column sums of S D L; the shares of q_t . H_n
// dy_t, k_s . G_n v_s and <H_n, G_n>; the carried G, in the accumulators of
// the blocks that walk it.
//
// Design: the wide forward's, turned around. Five launches on the caller's
// stream, into a scratch buffer that the wrapper allocates.
//   Launch 0 (split): one block per (b, h, chunk, 32 positions) and operand
//   writes the bf16 parts of q (and the two parts of exp(cum_t) q_t), k, v
//   or dy for those rows, only the parts in use, and their count; the q
//   blocks also write the chunk's cumsum of the gates (one warp's
//   fixed-order scan, rt::chunk_cumsum), which every later launch reads, so
//   every use of the gates agrees to the bit. One block per 32 rows of each
//   state H_n not known to be zero writes its two parts.
//   Launches 1 and 2, each block 8 warps over a 128 x 128 output tile.
//   Launch 1's score blocks compute one tile on or below the diagonal of a
//   (b, h, chunk)'s S over dk and D over dv, gate them, write P and R in
//   their parts (0 above the diagonal) and the tile's row and column sums
//   of S D L. Launch 2's walk blocks own a tile of one (b, h)'s state
//   gradient and walk the chunks in reverse: at chunk n they write G_n in
//   its parts where launch 3 reads it and their tile's share of <H_n, G_n>,
//   then G <- exp(tot) G + (exp(cum) q)^T dy in their accumulators; dh0 at
//   the end where asked for. A score block holds S and D, 128 accumulator
//   registers a thread, and runs one block an SM; a walk block fits in
//   half that and runs two, in a launch of its own: ~3 % faster a call
//   than both kinds in one launch at one block an SM, where the 96 score
//   blocks of the training shape keep 96 SMs while the 1,152 short walk
//   blocks pass through the other 36 (tools/k4_wide_bwd/walk_together.cu).
//   Launch 3: dq by (b, h, chunk, 128 rows t, 128 columns of dk), dk and dv
//   by (b, h, chunk, 128 rows s, 128 columns): first the state term (H_n
//   dy_t over dv; G_n v_s over dv; G_n^T k_s over dk), where the state is
//   not known to be zero, with dq's and dk's tile shares of q_t . H_n dy_t
//   and k_s . G_n v_s, scaled by exp(cum_t) or w_s; then the chunk's term (R
//   k, R^T q, P^T dy) over the positions on the right side of the diagonal.
//   Launch 4: one block per (b, h, chunk) adds the tiles' partial sums in
//   one fixed order into di and dcum, and da as dcum's reverse cumsum.
// In launches 1 to 3 every operand is bf16 part planes that cp.async
// brings into a ring of two or three stages of shared memory, read by
// ldmatrix (rt::wide in common.cuh, shared with the forward).
// No atomics: every output element has one block that owns it and runs its
// sums in one fixed order, so two calls give the same bits.
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// the tile, the slab, the planes and their helpers (rt::wide, common.cuh)
using namespace rt::wide;

constexpr int kMaxQ = 256;            // chunk positions (launch 4: a thread
                                      // a position)
constexpr int kNI = 3;                // parts of f32 q, k, v, dy
constexpr int kNP = 2;                // parts of P, R, H_n, G_n, exp(cum) q
constexpr int kOps = 4;               // operands whose parts are counted
enum { kQ = 0, kKey = 1, kV = 2, kDy = 3 };

constexpr int cmax(int x, int y) { return x > y ? x : y; }
// Stages of slabs in shared memory and bf16 elements a stage: a score
// block's q and k (then dy and v), a walk block's exp(cum) q and dy, launch
// 3's largest pair (dy and H_n's parts, or v and G_n's, as row planes).
// Launches 2 and 3 run two blocks an SM (128 registers a thread, a ring of
// two stages): launch 3 so is ~10 % faster a call than at one block with a
// ring of four (tools/k4_wide_bwd_designs.py).
constexpr int kScoreStages = 3, kScoreStage = 2 * kNI * kRowPlane;
constexpr int kWalkStages = 2, kWalkStage = (kNP + kNI) * kColPlane;
constexpr int kRowsStages = 2, kRowsStage = (kNI + kNP) * kRowPlane;
constexpr int kSmemScore = 2 * kScoreStages * kScoreStage;
constexpr int kSmemWalk = 2 * kWalkStages * kWalkStage;
constexpr int kSmemRows = 2 * kRowsStages * kRowsStage;

// The scratch buffer of a call, in bytes from its start (each region
// 16-byte aligned): the parts of q, k (B, H, 3, S, dkp), v, dy (B, H, 3, S,
// dvp) and exp(cum) q (B, H, 2, S, dkp); of the states before each chunk
// not known to be zero (B, H, nh, 2, dk, dvp: chunks n >= 1 without an
// initial state) and of the gradients after each chunk not known to be
// zero (B, H, ng, 2, dk, dvp: chunks n < nc - 1 without dh_final); of P
// and R (B, H, nc, 2, Q, Qp); the chunks' cumsums (B, H, S) f32; the parts
// in use of q, k, v, dy (B, H, nc, J, 4) int; then f32 partial sums: the
// score tiles' row and column sums (B, H, nc, ntt, Q), the dq and dk tiles'
// shares of q_t . H_n dy_t and k_s . G_n v_s (B, H, nc, ndt, Q) and the
// walk tiles' shares of <H_n, G_n> (B, H, nc, ndt, net). dkp, dvp and Qp
// round dk, dv and Q up to 8; J = ceil(Q / 32); ntt, ndt and net count the
// 128-wide tiles of Q, dk and dv.
// bytes of n floats, rounded up to 16
__host__ __device__ __forceinline__ int64_t f32_bytes(int64_t n) {
  return round_up(4 * n, (int64_t)16);
}

struct Layout {
  int64_t qp, kp, vp, dyp, eqp, hp, gp, p, r, cum, flags, rows, cols, pq, pk,
      hg, total;
  __host__ __device__ Layout(int B, int S, int H, int dk, int dv, int Q,
                             bool h0, bool dhf) {
    const int64_t bh = (int64_t)B * H, nc = S / Q, bhn = bh * nc;
    const int64_t dkp = round_up(dk, 8), dvp = round_up(dv, 8),
                  Qp = round_up(Q, 8), J = rt::cdiv(Q, kK);
    const int64_t nh = nc - (h0 ? 0 : 1), ng = nc - (dhf ? 0 : 1);
    const int64_t ntt = rt::cdiv(Q, kT), ndt = rt::cdiv(dk, kT),
                  net = rt::cdiv(dv, kT);
    qp = 0;
    kp = qp + 2 * bh * kNI * S * dkp;
    vp = kp + 2 * bh * kNI * S * dkp;
    dyp = vp + 2 * bh * kNI * S * dvp;
    eqp = dyp + 2 * bh * kNI * S * dvp;
    hp = eqp + 2 * bh * kNP * S * dkp;
    gp = hp + 2 * bh * nh * kNP * dk * dvp;
    p = gp + 2 * bh * ng * kNP * dk * dvp;
    r = p + 2 * bhn * kNP * Q * Qp;
    cum = r + 2 * bhn * kNP * Q * Qp;
    flags = cum + f32_bytes(bh * S);
    rows = flags + f32_bytes(bhn * J * kOps);
    cols = rows + f32_bytes(bhn * ntt * Q);
    pq = cols + f32_bytes(bhn * ntt * Q);
    pk = pq + f32_bytes(bhn * ndt * Q);
    hg = pk + f32_bytes(bhn * ndt * Q);
    total = hg + f32_bytes(bhn * ndt * net);
  }
};

// The pieces of a call that every block reads.
struct Call {
  const float *q, *k, *v, *a, *gi, *states, *dy, *dh_final;
  int B, S, H, dk, dv, Q;
  int h0;                   // 0: no initial state, H_0 = 0
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  bf16 *qp, *kp, *vp, *dyp, *eqp, *hp, *gp, *P, *R;   // scratch
  float* cum;
  int* flags;
  float *rows, *cols, *pq, *pk, *hg;
  float *dq, *dk_out, *dv_out, *da, *di, *dh0;   // dh0 null: not asked for
  __host__ __device__ int nc() const { return S / Q; }
  __host__ __device__ int64_t bhn() const { return (int64_t)B * H * nc(); }
  __host__ __device__ int J() const { return rt::cdiv(Q, kK); }
  __host__ __device__ int dkp() const { return round_up(dk, 8); }
  __host__ __device__ int dvp() const { return round_up(dv, 8); }
  __host__ __device__ int Qp() const { return round_up(Q, 8); }
  __host__ __device__ int ntt() const { return rt::cdiv(Q, kT); }
  __host__ __device__ int ndt() const { return rt::cdiv(dk, kT); }
  __host__ __device__ int net() const { return rt::cdiv(dv, kT); }
  // the first chunk whose state H_n is not known to be zero, and the count
  // of chunks whose gradient G_n is not (the first ng)
  __host__ __device__ int n_h0() const { return h0 ? 0 : 1; }
  __host__ __device__ int ng() const { return nc() - (dh_final ? 0 : 1); }
  __device__ bool h_nonzero(int n) const { return n >= n_h0(); }
  __device__ bool g_nonzero(int n) const { return n < ng(); }
  __device__ const float* qrow(int64_t b, int h, int64_t s) const {
    return q + b * qsb + h * qsh + s * qss;
  }
  __device__ const float* krow(int64_t b, int h, int64_t s) const {
    return k + b * ksb + h * ksh + s * kss;
  }
  __device__ const float* vrow(int64_t b, int h, int64_t s) const {
    return v + b * vsb + h * vsh + s * vss;
  }
  // dy, dq, dk and dv are contiguous (B, S, H, .)
  __device__ int64_t at(int64_t b, int h, int64_t s) const {
    return (b * S + s) * H + h;
  }
  // the forward's f32 state before chunk n of (b, h): dk rows of dv
  __device__ const float* state(int64_t b, int h, int n) const {
    return states + ((b * nc() + n) * H + h) * (int64_t)dk * dv;
  }
  // plane 0 of (b, h)'s q, k, exp(cum) q (S rows of dkp), v and dy (S rows
  // of dvp)
  __device__ bf16* q_plane(int64_t bh) const {
    return qp + bh * kNI * (int64_t)S * dkp();
  }
  __device__ bf16* k_plane(int64_t bh) const {
    return kp + bh * kNI * (int64_t)S * dkp();
  }
  __device__ bf16* eq_plane(int64_t bh) const {
    return eqp + bh * kNP * (int64_t)S * dkp();
  }
  __device__ bf16* v_plane(int64_t bh) const {
    return vp + bh * kNI * (int64_t)S * dvp();
  }
  __device__ bf16* dy_plane(int64_t bh) const {
    return dyp + bh * kNI * (int64_t)S * dvp();
  }
  // plane 0 of H_n (n >= n_h0()) and of G_n (n < ng()): dk rows of dvp
  __device__ bf16* h_plane(int64_t bh, int n) const {
    return hp + (bh * (nc() - n_h0()) + n - n_h0()) * kNP * (int64_t)dk *
                    dvp();
  }
  __device__ bf16* g_plane(int64_t bh, int n) const {
    return gp + (bh * ng() + n) * kNP * (int64_t)dk * dvp();
  }
  // plane 0 of (b, h, chunk)'s P and R: Q rows of Qp
  __device__ bf16* p_plane(int64_t bhn) const {
    return P + bhn * kNP * (int64_t)Q * Qp();
  }
  __device__ bf16* r_plane(int64_t bhn) const {
    return R + bhn * kNP * (int64_t)Q * Qp();
  }
  __device__ PartFlags pf() const { return PartFlags{flags, J(), kOps}; }
};

// Launch 0. Blocks [0, kOps bhn J): rows 32 j .. of (b, h, chunk) of one
// operand x (q, with exp(cum) q and, at j = 0, the chunk's cumsum; k; v;
// dy), block x bhn J + ((b H + h) nc + n) J + j; then one block per 32 rows
// of each state H_n not known to be zero, (b H + h, n - n_h0, rows).
__global__ void __launch_bounds__(kThreads, 2)
    ssd_wide_bwd_split(const Call c, int vec_qk, int vec_v, int vec_dy,
                       int vec_h) {
  __shared__ float cum[kMaxQ];
  __shared__ float e[kK];
  const int J = c.J(), nc = c.nc(), Q = c.Q, dkp = c.dkp(), dvp = c.dvp();
  const int64_t nrow = c.bhn() * J;
  if ((int64_t)blockIdx.x >= kOps * nrow) {
    // the two parts of the forward's f32 state H_n, 32 of its rows
    const int nrg = rt::cdiv(c.dk, kK), nh = nc - c.n_h0();
    const int64_t id = blockIdx.x - kOps * nrow;
    const int rg = (int)(id % nrg);
    const int n = c.n_h0() + (int)(id / nrg % nh);
    const int64_t bh = id / nrg / nh;
    const int h = (int)(bh % c.H);
    const int64_t b = bh / c.H;
    split_rows<kNP, kNP>(c.state(b, h, n) + (int64_t)kK * rg * c.dv, c.dv,
                         c.dv, dvp, vec_h, min(kK, c.dk - kK * rg),
                         c.h_plane(bh, n) + (int64_t)kK * rg * dvp,
                         (int64_t)c.dk * dvp, nullptr, nullptr, 0, true);
    return;
  }
  const int x = (int)(blockIdx.x / nrow);
  const int64_t rest = blockIdx.x % nrow;
  const int j = (int)(rest % J);
  const int64_t bhn = rest / J;
  const int n = (int)(bhn % nc);
  const int64_t bh = bhn / nc;
  const int h = (int)(bh % c.H);
  const int64_t b = bh / c.H;
  const int64_t row0 = (int64_t)n * Q + kK * j;      // in the sequence
  const int rows = min(kK, Q - kK * j);
  const int64_t pk = (int64_t)c.S * dkp, pv = (int64_t)c.S * dvp;
  int used;
  if (x == kQ) {
    // Every q block of a chunk runs the chunk's scan for the exp(cum) of
    // its own 32 rows (J = 8 times a chunk at the training shape), and the
    // first writes it: a warp's read of Q gates (1 KB at Q 256) against the
    // 32 rows of f32 q (128 KB at dk 1024) that the block splits, where
    // one scan a chunk would need a launch or a wait between blocks.
    if (threadIdx.x < 32) {
      const int64_t g0 = (b * c.S + (int64_t)n * Q) * c.H + h;
      rt::chunk_cumsum(c.a + g0, c.H, Q, cum);
      __syncwarp();
      const int s = kK * j + threadIdx.x;
      e[threadIdx.x] = s < Q ? expf(cum[s]) : 0.f;
      if (j == 0)
        for (int u = threadIdx.x; u < Q; u += 32)
          c.cum[bh * c.S + (int64_t)n * Q + u] = cum[u];
    }
    __syncthreads();
    used = split_rows<kNI, kNP>(c.qrow(b, h, row0), c.qss, c.dk, dkp, vec_qk,
                                rows, c.q_plane(bh) + row0 * dkp, pk, e,
                                c.eq_plane(bh) + row0 * dkp, pk);
  } else if (x == kKey) {
    used = split_rows<kNI, kNP>(c.krow(b, h, row0), c.kss, c.dk, dkp, vec_qk,
                                rows, c.k_plane(bh) + row0 * dkp, pk,
                                nullptr, nullptr, 0);
  } else if (x == kV) {
    used = split_rows<kNI, kNP>(c.vrow(b, h, row0), c.vss, c.dv, dvp, vec_v,
                                rows, c.v_plane(bh) + row0 * dvp, pv,
                                nullptr, nullptr, 0);
  } else {
    used = split_rows<kNI, kNP>(c.dy + c.at(b, h, row0) * c.dv,
                                (int64_t)c.H * c.dv, c.dv, dvp, vec_dy, rows,
                                c.dy_plane(bh) + row0 * dvp, pv, nullptr,
                                nullptr, 0);
  }
  if (threadIdx.x == 0) c.flags[(bhn * J + j) * kOps + x] = used;
}

// Row sums of a tile's per-thread partials part[m][e / 2] (the thread's
// rows acc_row(m, e)) into out[r] for the tile's rows r < nrows: the four
// threads of a quad, then the four warps that share the rows, in one fixed
// order through red (4 kT floats of shared memory). Every thread calls it.
__device__ __forceinline__ void row_sums(float (&part)[4][2], float* red,
                                         float* __restrict__ out,
                                         int nrows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x = part[m][hh];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if ((lane & 3) == 0) red[(warp & 3) * kT + acc_row(m, 2 * hh)] = x;
    }
  __syncthreads();
  if ((int)threadIdx.x < min(nrows, kT)) {
    const int r = threadIdx.x;
    out[r] = ((red[r] + red[kT + r]) + red[2 * kT + r]) + red[3 * kT + r];
  }
}

// Column sums of a tile's per-thread partials part[n][e % 2] (the thread's
// columns acc_col(n, e)) into out[col] for columns < ncols: the eight
// threads that share a column in a warp, then the two warps, in one fixed
// order through red (2 kT floats). Every thread calls it.
__device__ __forceinline__ void col_sums(float (&part)[4][2], float* red,
                                         float* __restrict__ out,
                                         int ncols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float x = part[n][u];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (lane < 4) red[(warp >> 2) * kT + acc_col(n, u)] = x;
    }
  __syncthreads();
  if ((int)threadIdx.x < min(ncols, kT)) {
    const int col = threadIdx.x;
    out[col] = red[col] + red[kT + col];
  }
}

// Launch 1, a score block: the 128 x 128 tile (rows t0 .., columns s0 ..
// <= t0) of one (b, h, chunk)'s S over dk and D over dv on the tensor
// cores; then P and R in their parts (0 above the diagonal; the decay is
// exp of the difference, selected, never a product of exp(cum_t) and
// exp(-cum_s)) and the tile's row sums of S D L i_s and column sums of S D
// L.
__device__ __forceinline__ void score_block(const Call& c, int bid,
                                            bf16* smem, float* red) {
  const int nc = c.nc(), Q = c.Q, Qp = c.Qp(), dkp = c.dkp(), dvp = c.dvp(),
            J = c.J(), ntt = c.ntt(), tiles = ntt * (ntt + 1) / 2;
  const int64_t bhn = bid / tiles;
  const int tile = bid % tiles;
  const int n = (int)(bhn % nc);
  const int64_t bh = bhn / nc;
  const int h = (int)(bh % c.H);
  const int64_t b = bh / c.H;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
  const int tj = tile - ti * (ti + 1) / 2;
  const int t0 = kT * ti, s0 = kT * tj;
  const int64_t row0 = (int64_t)n * Q;
  const PartFlags f = c.pf();
  const int jt = t0 / kK, js = s0 / kK;
  const int jt1 = min((t0 + kT) / kK, J), js1 = min((s0 + kT) / kK, J);
  const int nq = f.parts(bhn, jt, jt1, kQ), nk = f.parts(bhn, js, js1, kKey);
  const int ndy = f.parts(bhn, jt, jt1, kDy), nv = f.parts(bhn, js, js1, kV);
  const uint32_t qc = f.count4(bhn, jt, kQ), kc = f.count4(bhn, js, kKey);
  const uint32_t dyc = f.count4(bhn, jt, kDy), vc = f.count4(bhn, js, kV);
  const bf16* qb = c.q_plane(bh) + (row0 + t0) * dkp;
  const bf16* kb = c.k_plane(bh) + (row0 + s0) * dkp;
  const bf16* dyb = c.dy_plane(bh) + (row0 + t0) * dvp;
  const bf16* vb = c.v_plane(bh) + (row0 + s0) * dvp;
  const int64_t pk = (int64_t)c.S * dkp, pv = (int64_t)c.S * dvp;
  const int G1 = rt::cdiv(c.dk, kK), G2 = rt::cdiv(c.dv, kK);
  float sacc[4][4][4] = {}, dacc[4][4][4] = {};
  auto stage = [&](int g, int st) {
    bf16* s = smem + st * kScoreStage;
    if (g < G1) {
      stage_parts<false>(s, qb + kK * g, pk, dkp, Q - t0, dkp - kK * g, nq,
                         qc);
      stage_parts<false>(s + kNI * kRowPlane, kb + kK * g, pk, dkp, Q - s0,
                         dkp - kK * g, nk, kc);
    } else {
      const int u = kK * (g - G1);
      stage_parts<false>(s, dyb + u, pv, dvp, Q - t0, dvp - u, ndy, dyc);
      stage_parts<false>(s + kNI * kRowPlane, vb + u, pv, dvp, Q - s0,
                         dvp - u, nv, vc);
    }
  };
  auto mma = [&](int g, int st) {
    const bf16* s = smem + st * kScoreStage;
    if (g < G1)
      mma_slab<false, false, kNI, kNI>(sacc, s, s + kNI * kRowPlane, nq, nk);
    else
      mma_slab<false, false, kNI, kNI>(dacc, s, s + kNI * kRowPlane, ndy,
                                       nv);
  };
  pipeline<kScoreStages>(G1 + G2, stage, mma);
  // gate, select 0 above the diagonal, split; the sums of S D L
  const float* cum = c.cum + bh * c.S + row0;
  const float* is = c.gi + (b * c.S + row0) * c.H + h;
  float rs[4][2] = {}, cs[4][2] = {};
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int t = t0 + acc_row(m, e), s = s0 + acc_col(nn, e);
        float p[2] = {0.f, 0.f}, r[2] = {0.f, 0.f};
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (t < Q && s + u <= t) {
            const float L = expf(cum[t] - cum[s + u]);
            const float iu = is[(int64_t)(s + u) * c.H];
            const float S_ = sacc[m][nn][e + u], D_ = dacc[m][nn][e + u];
            const float sdl = S_ * D_ * L;
            rs[m][e >> 1] += sdl * iu;
            cs[nn][u] += sdl;
            p[u] = S_ * L * iu;
            r[u] = D_ * L * iu;
          }
        if (t >= Q || s >= Qp) continue;
        uint32_t pp[kNP], rp[kNP];
        rt::split_bf16<kNP>(p[0], p[1], pp);
        rt::split_bf16<kNP>(r[0], r[1], rp);
        const int64_t off = (int64_t)t * Qp + s;
#pragma unroll
        for (int x = 0; x < kNP; ++x) {
          const int64_t plane = (int64_t)x * Q * Qp;
          *reinterpret_cast<uint32_t*>(c.p_plane(bhn) + plane + off) = pp[x];
          *reinterpret_cast<uint32_t*>(c.r_plane(bhn) + plane + off) = rp[x];
        }
      }
  row_sums(rs, red, c.rows + (bhn * ntt + tj) * Q + t0, Q - t0);
  col_sums(cs, red + 4 * kT, c.cols + (bhn * ntt + ti) * Q + s0, Q - s0);
}

// Launch 2, a walk block: the tile (rows d0 .., columns e0 ..) of one (b,
// h)'s state gradient, walking the chunks in reverse from G_{nc-1} =
// dh_final (zero, not read, where there is none): at chunk n G_n in its
// parts where launch 3 reads it (n < ng) and the tile's share of <H_n, G_n>
// where neither is known to be zero, then the update to G_{n-1}, down to
// chunk 0 where dh0 is asked for and chunk 1 where not; a ring of NS
// stages.
template <int NS>
__device__ __forceinline__ void walk_block(const Call& c, int bid,
                                           bf16* smem, float* red) {
  const int nc = c.nc(), Q = c.Q, J = c.J(), dk = c.dk, dv = c.dv,
            dkp = c.dkp(), dvp = c.dvp(), ndt = c.ndt(), net = c.net();
  const int nct = rt::cdiv(dvp, kT);
  const int dt = bid / nct % ndt, et = bid % nct;
  const int64_t bh = bid / (nct * ndt);
  const int h = (int)(bh % c.H);
  const int64_t b = bh / c.H;
  const int d0 = kT * dt, e0 = kT * et;
  const int n_stop = c.dh0 ? 0 : 1;    // the last chunk updated from
  float acc[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = d0 + acc_row(m, e), col = e0 + acc_col(nn, e);
        acc[m][nn][e] = c.dh_final && d < dk && col < dv
                            ? c.dh_final[(bh * dk + d) * dv + col] : 0.f;
      }
  const PartFlags f = c.pf();
  const int ndy = f.parts(bh * nc, n_stop * J, nc * J, kDy);
  const bf16* eqb = c.eq_plane(bh) + d0;
  const bf16* dyb = c.dy_plane(bh) + e0;
  const int64_t pk = (int64_t)c.S * dkp, pv = (int64_t)c.S * dvp;
  // acc holds G_n: its parts, and the share of <H_n, G_n>
  auto visit = [&](int n) {
    const bool gz = !c.g_nonzero(n);
    if (!gz)
      store_parts<kNP>(acc, c.g_plane(bh, n), (int64_t)dk * dvp, d0, e0, dk,
                       dvp);
    float hg = 0.f;
    if (!gz && c.h_nonzero(n)) {
      const float* Hn = c.state(b, h, n);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = d0 + acc_row(m, e), col = e0 + acc_col(nn, e);
            if (d < dk && col < dv)
              hg = fmaf(__ldg(Hn + (int64_t)d * dv + col), acc[m][nn][e], hg);
          }
    }
    red[threadIdx.x] = hg;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int u = 0; u < kThreads; ++u) s += red[u];
      c.hg[((bh * nc + n) * ndt + dt) * net + et] = s;
    }
    __syncthreads();
  };
  auto stage = [&](int g, int st) {
    const int n = nc - 1 - g / J, j = g % J;
    const int64_t row = (int64_t)n * Q + kK * j;
    bf16* s = smem + st * kWalkStage;
    stage_parts<true>(s, eqb + row * dkp, pk, dkp, Q - kK * j, dkp - d0, kNP,
                      ~0u);
    stage_parts<true>(s + kNP * kColPlane, dyb + row * dvp, pv, dvp,
                      Q - kK * j, dvp - e0, ndy,
                      (uint32_t)f.count(bh * nc + n, j, kDy));
  };
  auto mma = [&](int g, int st) {
    const int n = nc - 1 - g / J, j = g % J;
    if (j == 0) {
      visit(n);
      const float dec = expf(c.cum[bh * c.S + (int64_t)n * Q + Q - 1]);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][nn][e] *= dec;
    }
    const bf16* s = smem + st * kWalkStage;
    // G += (exp(cum) q)^T dy over the slab's positions
    mma_slab<true, true, kNP, kNI>(acc, s, s + kNP * kColPlane, kNP, ndy);
  };
  pipeline<NS>((nc - n_stop) * J, stage, mma);
  if (n_stop == 1) visit(0);
  if (c.dh0)
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = d0 + acc_row(m, e), col = e0 + acc_col(nn, e);
          if (d < dk && col < dv) c.dh0[(bh * dk + d) * dv + col] =
                                      acc[m][nn][e];
        }
}

// Launch 1: score blocks, one block an SM.
__global__ void __launch_bounds__(kThreads, 1)
    ssd_wide_bwd_scores(const Call c) {
  extern __shared__ __align__(16) bf16 smem[];
  __shared__ float red[6 * kT];
  score_block(c, blockIdx.x, smem, red);
}

// Launch 2: walk blocks, two blocks an SM.
__global__ void __launch_bounds__(kThreads, 2)
    ssd_wide_bwd_walk(const Call c) {
  extern __shared__ __align__(16) bf16 smem[];
  __shared__ float red[kThreads];
  walk_block<kWalkStages>(c, blockIdx.x, smem, red);
}

// Launch 3: one output tile of dq, dk or dv for one (b, h, chunk). Blocks
// [0, nq) are dq's (b, h, chunk, rows t, columns of dk), the next nq dk's
// and the rest dv's (b, h, chunk, rows s, columns of dv).
__global__ void __launch_bounds__(kThreads, 2)
    ssd_wide_bwd_rows(const Call c, int nq) {
  extern __shared__ __align__(16) bf16 smem[];
  __shared__ float red[4 * kT];
  __shared__ float scl[kT];
  const int nc = c.nc(), Q = c.Q, Qp = c.Qp(), dk = c.dk, dv = c.dv,
            dkp = c.dkp(), dvp = c.dvp(), J = c.J(), ntt = c.ntt(),
            ndt = c.ndt(), net = c.net();
  int bid = blockIdx.x;
  const int kind = bid < nq ? 0 : bid < 2 * nq ? 1 : 2;
  bid -= kind < 2 ? kind * nq : 2 * nq;
  const int ncol = kind < 2 ? ndt : net;
  const int cj = bid % ncol, ti = bid / ncol % ntt;
  const int64_t bhn = bid / (ncol * ntt);
  const int n = (int)(bhn % nc);
  const int64_t bh = bhn / nc;
  const int h = (int)(bh % c.H);
  const int64_t b = bh / c.H;
  const int r0 = kT * ti, c0 = kT * cj;
  const int64_t row0 = (int64_t)n * Q;
  const float* cum = c.cum + bh * c.S + row0;
  const float tot = cum[Q - 1];
  // the rows' scale of the state term: exp(cum_t) for dq, w_s for dk, dv
  if (threadIdx.x < kT) {
    const int t = r0 + threadIdx.x;
    scl[threadIdx.x] =
        t >= Q ? 0.f
        : kind == 0 ? expf(cum[t])
                    : expf(tot - cum[t]) * c.gi[c.at(b, h, row0 + t)];
  }
  __syncthreads();
  // the state term's slabs (none where the state is known to be zero) and
  // the chunk term's, positions j0 .. j1 - 1 of 32
  const bool state = kind == 0 ? c.h_nonzero(n) : c.g_nonzero(n);
  const int G1 = state ? rt::cdiv(kind < 2 ? dv : dk, kK) : 0;
  const int j0 = kind == 0 ? 0 : r0 / kK;
  const int j1 = kind == 0 ? rt::cdiv(min(r0 + kT, Q), kK) : J;
  const PartFlags f = c.pf();
  // the state term's A operand (dy, v or k at the tile's rows) and the
  // chunk term's B operand (k, q or dy): their parts in use
  const int xa = kind == 0 ? kDy : kind == 1 ? kV : kKey;
  const int xb = kind == 0 ? kKey : kind == 1 ? kQ : kDy;
  const int na = f.parts(bhn, r0 / kK, min((r0 + kT) / kK, J), xa);
  const uint32_t ca = f.count4(bhn, r0 / kK, xa);
  const int nb = f.parts(bhn, j0, j1, xb);
  const int64_t pk = (int64_t)c.S * dkp, pv = (int64_t)c.S * dvp;
  const int64_t ps = (int64_t)dk * dvp, pq = (int64_t)Q * Qp;
  const bf16* sa = kind == 0 ? c.dy_plane(bh) + (row0 + r0) * dvp
                 : kind == 1 ? c.v_plane(bh) + (row0 + r0) * dvp
                             : c.k_plane(bh) + (row0 + r0) * dkp;
  const bf16* sb = !state ? nullptr
                 : kind == 0 ? c.h_plane(bh, n) + (int64_t)c0 * dvp
                 : kind == 1 ? c.g_plane(bh, n) + (int64_t)c0 * dvp
                             : c.g_plane(bh, n) + c0;
  const bf16* ca_ = kind == 0 ? c.r_plane(bhn) + (int64_t)r0 * Qp
                  : kind == 1 ? c.r_plane(bhn) + r0 : c.p_plane(bhn) + r0;
  const bf16* cb = kind == 0 ? c.k_plane(bh) + row0 * dkp + c0
                 : kind == 1 ? c.q_plane(bh) + row0 * dkp + c0
                             : c.dy_plane(bh) + row0 * dvp + c0;
  const int64_t lda = kind == 2 ? dkp : dvp, ldb = kind == 2 ? dvp : dkp;
  const int64_t pa = kind == 2 ? pk : pv;
  float acc[4][4][4] = {};
  auto stage = [&](int g, int st) {
    bf16* s = smem + st * kRowsStage;
    if (g < G1) {
      const int u = kK * g;
      stage_parts<false>(s, sa + u, pa, lda, Q - r0, (int)lda - u, na, ca);
      if (kind < 2)     // H_n or G_n as [dk][dv]: rows c0 .., columns u ..
        stage_parts<false>(s + kNI * kRowPlane, sb + u, ps, dvp, dk - c0,
                           dvp - u, kNP, ~0u);
      else              // G_n: rows u .., columns c0 ..
        stage_parts<true>(s + kNI * kRowPlane, sb + (int64_t)u * dvp, ps,
                          dvp, dk - u, dvp - c0, kNP, ~0u);
      return;
    }
    const int j = j0 + g - G1, u = kK * j;
    if (kind == 0)      // R: rows t0 .., columns s = u ..
      stage_parts<false>(s, ca_ + u, pq, Qp, Q - r0, Qp - u, kNP, ~0u);
    else                // R or P: rows t = u .., columns s0 ..
      stage_parts<true>(s, ca_ + (int64_t)u * Qp, pq, Qp, Q - u, Qp - r0,
                        kNP, ~0u);
    stage_parts<true>(s + kNP * (kind == 0 ? kRowPlane : kColPlane),
                      cb + (int64_t)u * ldb, kind == 2 ? pv : pk, ldb, Q - u,
                      (int)ldb - c0, nb, (uint32_t)f.count(bhn, j, xb));
  };
  // the state term's end: the tile's share of q_t . H_n dy_t (dq) or k_s .
  // G_n v_s (dk), then the rows' scale
  auto state_done = [&]() {
    if (kind < 2) {
      const float* x0 = kind == 0 ? c.qrow(b, h, row0) : c.krow(b, h, row0);
      const int64_t xs = kind == 0 ? c.qss : c.kss;
      float part[4][2] = {};
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int t = r0 + acc_row(m, e);
          if (t >= Q) continue;
#pragma unroll
          for (int nn = 0; nn < 4; ++nn)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int d = c0 + acc_col(nn, e + u);
              if (d < dk)
                part[m][e >> 1] = fmaf(__ldg(x0 + t * xs + d),
                                       acc[m][nn][e + u], part[m][e >> 1]);
            }
        }
      row_sums(part, red,
               (kind == 0 ? c.pq : c.pk) + (bhn * ndt + cj) * Q + r0, Q - r0);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sc = scl[acc_row(m, e)];
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) acc[m][nn][e] *= sc;
      }
  };
  auto mma = [&](int g, int st) {
    const bf16* s = smem + st * kRowsStage;
    if (g < G1) {
      if (kind < 2)
        mma_slab<false, false, kNI, kNP>(acc, s, s + kNI * kRowPlane, na,
                                         kNP);
      else
        mma_slab<false, true, kNI, kNP>(acc, s, s + kNI * kRowPlane, na,
                                        kNP);
      return;
    }
    if (g == G1 && G1 > 0) state_done();
    if (kind == 0)
      mma_slab<false, true, kNP, kNI>(acc, s, s + kNP * kRowPlane, kNP, nb);
    else
      mma_slab<true, true, kNP, kNI>(acc, s, s + kNP * kColPlane, kNP, nb);
  };
  pipeline<kRowsStages>(G1 + j1 - j0, stage, mma);
  if (G1 == 0 && kind < 2 && (int)threadIdx.x < min(Q - r0, kT))
    (kind == 0 ? c.pq : c.pk)[(bhn * ndt + cj) * Q + r0 + threadIdx.x] = 0.f;
  float* out = kind == 0 ? c.dq : kind == 1 ? c.dk_out : c.dv_out;
  const int width = kind < 2 ? dk : dv;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = r0 + acc_row(m, e);
      if (t >= Q) continue;
      float* o = out + c.at(b, h, row0 + t) * width;
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const int col = c0 + acc_col(nn, e);
        if (col < width) o[col] = acc[m][nn][e];
      }
    }
}

// Launch 4: one block per (b, h, chunk): di, and da as the reverse cumsum
// of dcum, from the tiles' partial sums, each added in one fixed order.
__global__ void __launch_bounds__(kThreads)
    ssd_wide_bwd_gates(const Call c) {
  __shared__ float dcum[kMaxQ];
  __shared__ float sw[kMaxQ];
  const int nc = c.nc(), Q = c.Q, ntt = c.ntt(), ndt = c.ndt(),
            net = c.net();
  const int64_t bhn = blockIdx.x;
  const int n = (int)(bhn % nc);
  const int64_t bh = bhn / nc;
  const int h = (int)(bh % c.H);
  const int64_t b = bh / c.H;
  const int64_t row0 = (int64_t)n * Q;
  const float* cum = c.cum + bh * c.S + row0;
  const float tot = cum[Q - 1];
  const int t = threadIdx.x;
  if (t < Q) {
    float rg = 0.f, cs = 0.f, inter = 0.f, kz = 0.f;
    for (int j = 0; j <= t / kT; ++j) rg += c.rows[(bhn * ntt + j) * Q + t];
    for (int i = t / kT; i < ntt; ++i) cs += c.cols[(bhn * ntt + i) * Q + t];
    for (int j = 0; j < ndt; ++j) {
      inter += c.pq[(bhn * ndt + j) * Q + t];
      kz += c.pk[(bhn * ndt + j) * Q + t];
    }
    inter *= expf(cum[t]);
    const float ew = expf(tot - cum[t]), is = c.gi[c.at(b, h, row0 + t)];
    const float w = ew * is;
    c.di[c.at(b, h, row0 + t)] = fmaf(ew, kz, cs);
    dcum[t] = rg - is * cs + inter - w * kz;
    sw[t] = w * kz;
  }
  __syncthreads();
  if (t == 0) {
    // the gradient of tot joins dcum at Q - 1; da is dcum's reverse cumsum
    float hg = 0.f, s_w = 0.f;
    for (int u = 0; u < ndt * net; ++u) hg += c.hg[bhn * ndt * net + u];
    for (int s = 0; s < Q; ++s) s_w += sw[s];
    float run = fmaf(expf(tot), hg, s_w);
    for (int s = Q - 1; s >= 0; --s) {
      run += dcum[s];
      c.da[c.at(b, h, row0 + s)] = run;
    }
  }
}

bool valid(int B, int S, int H, int dk, int dv, int chunk) {
  return B >= 1 && S >= 1 && H >= 1 && chunk >= 1 && chunk <= kMaxQ &&
         S % chunk == 0 && dk >= 1 && dv >= 1;
}

// A call's Call and its grids: launch 0's blocks (g0), launch 1's score
// blocks (nscore), launch 2's walk blocks (nwalk), launch 3's dq blocks (nq
// of them, as many dk blocks, then dv's, to g3), launch 4's (bhn), and
// whether launch 0 may read q and k, v, dy and the states 16 bytes at a
// time. Arguments as repro_ssd_scan_wide_bwd's below.
struct Grids {
  long long g0, nscore, nwalk, nq, g3, bhn;
  int vec_qk, vec_v, vec_dy, vec_h;
};

int prepare(const float* q, const float* k, const float* v, const float* a,
            const float* i, const float* states, const float* dy,
            const float* dh_final, int B, int S, int H, int dk, int dv,
            int chunk, int has_h0, long long qsb, long long qss,
            long long qsh, long long ksb, long long kss, long long ksh,
            long long vsb, long long vss, long long vsh, void* scratch,
            long long scratch_bytes, float* dq, float* dk_out, float* dv_out,
            float* da, float* di, float* dh0, Call& c, Grids& g) {
  if (!valid(B, S, H, dk, dv, chunk) || !states || !rt::aligned16(scratch))
    return cudaErrorInvalidValue;
  const Layout lay(B, S, H, dk, dv, chunk, has_h0, dh_final != nullptr);
  if (scratch_bytes < lay.total) return cudaErrorInvalidValue;
  char* base = static_cast<char*>(scratch);
  auto b16 = [&](int64_t off) { return reinterpret_cast<bf16*>(base + off); };
  auto fp = [&](int64_t off) { return reinterpret_cast<float*>(base + off); };
  c.q = q, c.k = k, c.v = v, c.a = a, c.gi = i, c.states = states;
  c.dy = dy, c.dh_final = dh_final;
  c.B = B, c.S = S, c.H = H, c.dk = dk, c.dv = dv, c.Q = chunk;
  c.h0 = has_h0 ? 1 : 0;
  c.qsb = qsb, c.qss = qss, c.qsh = qsh, c.ksb = ksb, c.kss = kss;
  c.ksh = ksh, c.vsb = vsb, c.vss = vss, c.vsh = vsh;
  c.qp = b16(lay.qp), c.kp = b16(lay.kp), c.vp = b16(lay.vp);
  c.dyp = b16(lay.dyp), c.eqp = b16(lay.eqp), c.hp = b16(lay.hp);
  c.gp = b16(lay.gp), c.P = b16(lay.p), c.R = b16(lay.r);
  c.cum = fp(lay.cum), c.flags = reinterpret_cast<int*>(base + lay.flags);
  c.rows = fp(lay.rows), c.cols = fp(lay.cols), c.pq = fp(lay.pq);
  c.pk = fp(lay.pk), c.hg = fp(lay.hg);
  c.dq = dq, c.dk_out = dk_out, c.dv_out = dv_out;
  c.da = da, c.di = di, c.dh0 = dh0;
  g.vec_qk = rt::aligned16(q) && rt::aligned16(k) && qsb % 4 == 0 &&
             qss % 4 == 0 && qsh % 4 == 0 && ksb % 4 == 0 && kss % 4 == 0 &&
             ksh % 4 == 0;
  g.vec_v = rt::aligned16(v) && vsb % 4 == 0 && vss % 4 == 0 && vsh % 4 == 0;
  g.vec_dy = rt::aligned16(dy) && dv % 4 == 0;
  g.vec_h = rt::aligned16(states) && dv % 4 == 0;
  const long long bh = (long long)B * H, ntt = c.ntt(), ndt = c.ndt();
  g.bhn = c.bhn();
  g.g0 = kOps * g.bhn * c.J() + bh * (c.nc() - c.n_h0()) * rt::cdiv(dk, kK);
  g.nscore = g.bhn * (ntt * (ntt + 1) / 2);
  g.nwalk = bh * ndt * rt::cdiv(c.dvp(), kT);
  g.nq = g.bhn * ntt * ndt;
  g.g3 = 2 * g.nq + g.bhn * ntt * c.net();
  if (g.g0 > INT_MAX || g.nscore > INT_MAX || g.nwalk > INT_MAX ||
      g.g3 > INT_MAX)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The launches of a call, the first `launches` of them (the design tool
// times them one by one; a call makes all five). Arguments as
// repro_ssd_scan_wide_bwd's below.
int launch_wide_bwd(const float* q, const float* k, const float* v,
                    const float* a, const float* i, const float* states,
                    const float* dy, const float* dh_final, int B, int S,
                    int H, int dk, int dv, int chunk, int has_h0,
                    long long qsb, long long qss, long long qsh,
                    long long ksb, long long kss, long long ksh,
                    long long vsb, long long vss, long long vsh,
                    void* scratch, long long scratch_bytes, float* dq,
                    float* dk_out, float* dv_out, float* da, float* di,
                    float* dh0, cudaStream_t st, int launches) {
  Call c;
  Grids g;
  cudaError_t err = static_cast<cudaError_t>(prepare(
      q, k, v, a, i, states, dy, dh_final, B, S, H, dk, dv, chunk, has_h0,
      qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, scratch, scratch_bytes,
      dq, dk_out, dv_out, da, di, dh0, c, g));
  if (err != cudaSuccess) return err;
  // devices where the limit is up, a mask a kernel
  static uint32_t raised1 = 0, raised2 = 0, raised3 = 0;
  err = rt::raise_smem_once(ssd_wide_bwd_scores, kSmemScore, raised1);
  if (err == cudaSuccess)
    err = rt::raise_smem_once(ssd_wide_bwd_walk, kSmemWalk, raised2);
  if (err == cudaSuccess)
    err = rt::raise_smem_once(ssd_wide_bwd_rows, kSmemRows, raised3);
  if (err != cudaSuccess || launches < 1) return err;
  ssd_wide_bwd_split<<<(unsigned)g.g0, kThreads, 0, st>>>(
      c, g.vec_qk, g.vec_v, g.vec_dy, g.vec_h);
  err = cudaGetLastError();
  if (err != cudaSuccess || launches < 2) return err;
  ssd_wide_bwd_scores<<<(unsigned)g.nscore, kThreads, kSmemScore, st>>>(c);
  err = cudaGetLastError();
  if (err != cudaSuccess || launches < 3) return err;
  ssd_wide_bwd_walk<<<(unsigned)g.nwalk, kThreads, kSmemWalk, st>>>(c);
  err = cudaGetLastError();
  if (err != cudaSuccess || launches < 4) return err;
  ssd_wide_bwd_rows<<<(unsigned)g.g3, kThreads, kSmemRows, st>>>(c,
                                                                (int)g.nq);
  err = cudaGetLastError();
  if (err != cudaSuccess || launches < 5) return err;
  ssd_wide_bwd_gates<<<(unsigned)g.bhn, kThreads, 0, st>>>(c);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the scratch buffer a call needs (Layout above) into *bytes: with
// or without an initial state and a dh_final, which decide the states and
// gradients whose parts it holds.
extern "C" int repro_ssd_scan_wide_bwd_scratch(int B, int S, int H, int dk,
                                               int dv, int chunk,
                                               int has_h0, int has_dh_final,
                                               long long* bytes) {
  if (!valid(B, S, H, dk, dv, chunk)) return cudaErrorInvalidValue;
  *bytes = Layout(B, S, H, dk, dv, chunk, has_h0, has_dh_final).total;
  return cudaSuccess;
}

// q, k: (B, S, H, dk), v: (B, S, H, dv), f32 with element strides (sb, ss,
// sh, 1) each (a head stride may be 0). a, i: (B, S, H) f32 contiguous;
// states: (B, S / chunk, H, dk, dv) f32, the state before each chunk as
// ssd_scan_wide.cu writes it (the first not read without an initial state:
// has_h0 0); dy: (B, S, H, dv) f32 contiguous; dh_final: (B, H, dk, dv) f32
// or null for zeros. scratch: scratch_bytes (at least
// repro_ssd_scan_wide_bwd_scratch with the same has_h0 and dh_final),
// 16-byte aligned, for the launches' own use. Out, all f32 contiguous: dq,
// dk (B, S, H, dk), dv (B, S, H, dv), da, di (B, S, H), dh0 (B, H, dk, dv)
// or null where it is not asked for. S % chunk == 0, chunk <= 256. Five
// launches on ``stream``. Returns a cudaError_t.
extern "C" int repro_ssd_scan_wide_bwd(
    const float* q, const float* k, const float* v, const float* a,
    const float* i, const float* states, const float* dy,
    const float* dh_final, int B, int S, int H, int dk, int dv, int chunk,
    int has_h0, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, void* scratch, long long scratch_bytes, float* dq,
    float* dk_out, float* dv_out, float* da, float* di, float* dh0,
    void* stream) {
  return launch_wide_bwd(q, k, v, a, i, states, dy, dh_final, B, S, H, dk,
                         dv, chunk, has_h0, qsb, qss, qsh, ksb, kss, ksh,
                         vsb, vss, vsh, scratch, scratch_bytes, dq, dk_out,
                         dv_out, da, di, dh0,
                         static_cast<cudaStream_t>(stream), 5);
}
