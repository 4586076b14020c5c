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
// over f32 q, k, v and dy (mLSTM's, bf16 values widened); every output f32.
//
// Bound on the H100. At xlstm-1.3b's training shape (B 4, S 512, H 4, dk
// 1024, dv 1025, Q 256; ssd_scan.bwd_bound with q and k per head) the
// function needs 79.6 GFLOP against 503.8 MB of HBM bytes: 0.150 ms on the
// bytes, 1.19 ms with the flops on the ordinary f32 cores (where this design
// does them), 0.081 ms on the dense bf16 tensor cores.
//
// Design: simple and right first. Every product is a 128 x 128 output tile
// of f32 FMAs on the ordinary cores (tile_mm: 256 threads, 8 x 8 a thread,
// slabs of 16 along the reduction through shared memory, the next slab read
// into registers while this one is multiplied). Three launches on the
// caller's stream, into a scratch buffer that the wrapper allocates:
//   Launch 1, two kinds of block. Score blocks, one per 128 x 128 tile on or
//   below the diagonal of a (b, h, chunk): S over the whole dk and D over
//   the whole dv, then P and R (0 above the diagonal; the decay is exp of
//   the difference, selected, never a product of exp(cum_t) and
//   exp(-cum_s)) and the tile's row sums of S D L i_s and column sums of S
//   D L. Walk blocks, one per 128 x 128 tile of a (b, h)'s state gradient,
//   walk the chunks in reverse: at chunk n they write G_n to the scratch
//   buffer and their tile's share of <H_n, G_n>, then G <- exp(tot) G +
//   sum_t exp(cum_t) q_t dy_t^T in their accumulators; dh0 at the end.
//   Launch 2: dq by (b, h, chunk, 128 rows t, 128 columns of dk), dk and dv
//   by (b, h, chunk, 128 rows s, 128 columns): first the state term (H_n
//   dy_t over dv; G_n v_s over dv; G_n^T k_s over dk) with dq's and dk's
//   tile shares of q_t . H_n dy_t and k_s . G_n v_s, scaled by exp(cum_t) or
//   w_s, then the chunk's term (R k, R^T q, P^T dy) over the positions on
//   the right side of the diagonal.
//   Launch 3: one block per (b, h, chunk) adds the tiles' partial sums in
//   one fixed order into di and dcum, and da as dcum's reverse cumsum.
// No atomics: every output element has one block that owns it and runs its
// sums in one fixed order, so two calls give the same bits.
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 256;              // chunk positions (launch 3: a thread
                                        // a position)
constexpr int kT = 128;                 // a block's output tile is kT x kT
constexpr int kK = 16;                  // the reduction's slab
constexpr int kLd = kT + 4;             // row stride of a [kK][kT] slab
constexpr int kPer = kK * kT / kThreads;  // slab elements a thread loads
static_assert(kK * kLd >= 16 * kT,
              "a slab holds the 16 partial sums of each row of a tile");

// The scratch buffer of a call, in floats from its start: G_n, the state's
// gradient after each chunk (B, H, nc, dk, dv); the scores P and R (B, H,
// nc, Q, Q); the score tiles' row and column sums (B, H, nc, ntt, Q); the dq
// and dk tiles' sums q_t . H_n dy_t and k_s . G_n v_s (B, H, nc, ndt, Q);
// the walk tiles' shares of <H_n, G_n> (B, H, nc, ndt, net). ntt, ndt and
// net count the 128-wide tiles of Q, dk and dv.
struct Layout {
  int64_t g, p, r, rows, cols, pq, pk, hg, total;
  __host__ __device__ Layout(int B, int S, int H, int dk, int dv, int Q) {
    const int64_t bhn = (int64_t)B * H * (S / Q);
    const int64_t ntt = rt::cdiv(Q, kT), ndt = rt::cdiv(dk, kT),
                  net = rt::cdiv(dv, kT);
    g = 0;
    p = g + bhn * dk * dv;
    r = p + bhn * Q * Q;
    rows = r + bhn * Q * Q;
    cols = rows + bhn * ntt * Q;
    pq = cols + bhn * ntt * Q;
    pk = pq + bhn * ndt * Q;
    hg = pk + bhn * ndt * Q;
    total = hg + bhn * ndt * net;
  }
};

// The pieces of a call that every block reads.
struct Call {
  const float *q, *k, *v, *a, *gi, *states, *dy, *dh_final;
  int S, H, dk, dv, Q;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float *G, *P, *R, *rows, *cols, *pq, *pk, *hg;   // scratch
  float *dq, *dk_out, *dv_out, *da, *di, *dh0;
  __host__ __device__ int nc() const { return S / Q; }
  __host__ __device__ int ntt() const { return rt::cdiv(Q, kT); }
  __host__ __device__ int ndt() const { return rt::cdiv(dk, kT); }
  __host__ __device__ int net() const { return rt::cdiv(dv, kT); }
  // the first row of (b, h)'s q, k or v at position s
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
};

// An operand of a tile product: element (x, k) at p[x * sx + k * sk], x
// the row of the output tile (the A operand) or its column (B), k the
// reduction's index; read where x < nx and k < nk and 0 elsewhere, times
// scale[k] (shared memory) where scale is given.
struct Opnd {
  const float* p;
  int64_t sx, sk;
  int nx, nk;
  const float* scale;
};

// Slab k0 .. k0 + kK of an operand into registers: element e of the
// [kK][kT] slab in r[e / kThreads], neighbouring threads on neighbouring
// addresses (k-contiguous operands: along k, else along x).
__device__ __forceinline__ void fetch(const Opnd& o, int k0,
                                      float (&r)[kPer]) {
  const bool kc = o.sk == 1;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + kThreads * u;
    const int x = kc ? e / kK : e % kT, k = k0 + (kc ? e % kK : e / kT);
    float val = 0.f;
    if (x < o.nx && k < o.nk) {
      val = __ldg(o.p + x * o.sx + k * o.sk);
      if (o.scale) val *= o.scale[k];
    }
    r[u] = val;
  }
}

__device__ __forceinline__ void put(const Opnd& o, const float (&r)[kPer],
                                    float* __restrict__ sh) {
  const bool kc = o.sk == 1;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + kThreads * u;
    const int x = kc ? e / kK : e % kT, kk = kc ? e % kK : e / kT;
    sh[kk * kLd + x] = r[u];
  }
}

// Where a thread's acc[i][j] sits in the tile: rows 4 ty .. and 64 + 4 ty
// .., columns 4 tx .. and 64 + 4 tx .. (ty, tx the thread's row and column
// in a 16 x 16 grid), so that a warp's reads of a slab row are float4s
// that broadcast (A) or lie side by side (B).
__device__ __forceinline__ int row_of(int i) {
  return (i < 4 ? 0 : 60) + 4 * (threadIdx.x >> 4) + i;
}
__device__ __forceinline__ int col_of(int j) {
  return (j < 4 ? 0 : 60) + 4 * (threadIdx.x & 15) + j;
}

// acc[i][j] += sum_{k0 <= k < k1} A(row i, k) B(column j, k), k in order,
// on the ordinary f32 cores. sa and sb: two [kK][kLd] slabs of shared
// memory. Every thread calls it; it begins with a barrier, so the caller
// may have read the slabs before.
__device__ void tile_mm(float (&acc)[8][8], Opnd A, Opnd B, int k0, int k1,
                        float* __restrict__ sa, float* __restrict__ sb) {
  A.nk = min(A.nk, k1);
  B.nk = min(B.nk, k1);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float ra[kPer], rb[kPer];
  if (k0 < k1) {
    fetch(A, k0, ra);
    fetch(B, k0, rb);
  }
  for (int k = k0; k < k1; k += kK) {
    __syncthreads();                   // every thread is done with the slabs
    put(A, ra, sa);
    put(B, rb, sb);
    __syncthreads();
    if (k + kK < k1) {                 // the next slab, while this one runs
      fetch(A, k + kK, ra);
      fetch(B, k + kK, rb);
    }
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const float* pa = sa + kk * kLd + 4 * ty;
      const float* pb = sb + kk * kLd + 4 * tx;
      const float4 a0 = *reinterpret_cast<const float4*>(pa);
      const float4 a1 = *reinterpret_cast<const float4*>(pa + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(pb);
      const float4 b1 = *reinterpret_cast<const float4*>(pb + 64);
      const float x[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float y[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// Shared memory of every block: the two slabs, and three (Q,) vectors.
struct Smem {
  float a[kK * kLd];
  float b[kK * kLd];
  float cum[kMaxQ];
  float x[kMaxQ];
  float y[kMaxQ];
};

// The chunk's cumsum of the log-decays (cum) and its input gates (x) of
// (b, h, chunk n) into shared memory, for every thread to read.
__device__ void gates(const Call& c, int64_t b, int h, int n, Smem& sm) {
  const int64_t g0 = c.at(b, h, (int64_t)n * c.Q);
  __syncthreads();                     // earlier reads of the vectors done
  rt::chunk_cumsum(c.a + g0, c.H, c.Q, sm.cum);
  for (int s = threadIdx.x; s < c.Q; s += kThreads)
    sm.x[s] = c.gi[g0 + (int64_t)s * c.H];
  __syncthreads();
}

// sums[r] (r < kT) of part[u][r] over the 16 threads u of a row or column
// of the thread grid, in u order, through the slab sa: put(part) by every
// thread, then take(r) by the thread that writes r's sum.
__device__ __forceinline__ void row_parts(float* sa, const float (&part)[8]) {
  __syncthreads();                     // every thread is done with the slab
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) sa[tx * kT + row_of(i)] = part[i];
}
__device__ __forceinline__ void col_parts(float* sb, const float (&part)[8]) {
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) sb[ty * kT + col_of(j)] = part[j];
}
__device__ __forceinline__ float sum16(const float* s, int r) {
  float out = 0.f;
  for (int u = 0; u < 16; ++u) out += s[u * kT + r];
  return out;
}

// Launch 1, a score block: tile (rows t0 .., columns s0 .. <= t0) of one
// (b, h, chunk)'s P and R, and its row and column sums.
__device__ void score_block(const Call& c, int bid, Smem& sm) {
  const int nc = c.nc(), Q = c.Q, ntt = c.ntt(),
            tiles = ntt * (ntt + 1) / 2;
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
  gates(c, b, h, n, sm);
  float* P = c.P + bhn * Q * Q;
  float* R = c.R + bhn * Q * Q;
  float acc[8][8];
  zero(acc);
  // S = q k^T over dk, kept in P's place until D is formed
  tile_mm(acc,
          Opnd{c.qrow(b, h, row0 + t0), c.qss, 1, Q - t0, c.dk, nullptr},
          Opnd{c.krow(b, h, row0 + s0), c.kss, 1, Q - s0, c.dk, nullptr}, 0,
          c.dk, sm.a, sm.b);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = t0 + row_of(i), s = s0 + col_of(j);
      if (t < Q && s < Q) P[t * Q + s] = acc[i][j];
      acc[i][j] = 0.f;
    }
  // D = dy v^T over dv
  tile_mm(acc,
          Opnd{c.dy + c.at(b, h, row0 + t0) * c.dv, (int64_t)c.H * c.dv, 1,
               Q - t0, c.dv, nullptr},
          Opnd{c.vrow(b, h, row0 + s0), c.vss, 1, Q - s0, c.dv, nullptr}, 0,
          c.dv, sm.a, sm.b);
  float rs[8] = {}, cs[8] = {};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = t0 + row_of(i), s = s0 + col_of(j);
      if (t >= Q || s >= Q) continue;
      float p = 0.f, r = 0.f;
      if (s <= t) {
        const float S_ = P[t * Q + s], D_ = acc[i][j];
        const float L = expf(sm.cum[t] - sm.cum[s]), is = sm.x[s];
        const float sdl = S_ * D_ * L;
        rs[i] += sdl * is;
        cs[j] += sdl;
        p = S_ * L * is;
        r = D_ * L * is;
      }
      P[t * Q + s] = p;
      R[t * Q + s] = r;
    }
  row_parts(sm.a, rs);
  col_parts(sm.b, cs);
  __syncthreads();
  const int u = threadIdx.x & (kT - 1);
  if (threadIdx.x < kT) {
    if (t0 + u < Q)
      c.rows[(bhn * ntt + tj) * Q + t0 + u] = sum16(sm.a, u);
  } else if (s0 + u < Q) {
    c.cols[(bhn * ntt + ti) * Q + s0 + u] = sum16(sm.b, u);
  }
}

// Launch 1, a walk block: the tile (rows d0 .., columns e0 ..) of one
// (b, h)'s state gradient, walking the chunks in reverse.
__device__ void walk_block(const Call& c, int bid, Smem& sm) {
  const int nc = c.nc(), Q = c.Q, dk = c.dk, dv = c.dv, ndt = c.ndt(),
            net = c.net();
  const int ej = bid % net, di = bid / net % ndt;
  const int64_t bh = bid / (net * ndt);
  const int h = (int)(bh % c.H);
  const int64_t b = bh / c.H;
  const int d0 = kT * di, e0 = kT * ej;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = d0 + row_of(i), e = e0 + col_of(j);
      acc[i][j] = c.dh_final && d < dk && e < dv
                      ? c.dh_final[(bh * dk + d) * dv + e] : 0.f;
    }
  for (int n = nc - 1; n >= 0; --n) {
    gates(c, b, h, n, sm);
    for (int t = threadIdx.x; t < Q; t += kThreads)
      sm.y[t] = expf(sm.cum[t]);
    // G_n, and this tile's share of <H_n, G_n>
    const int64_t bhn = bh * nc + n;
    float* G = c.G + bhn * dk * dv;
    const float* Hn = c.state(b, h, n);
    float hg = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = d0 + row_of(i), e = e0 + col_of(j);
        if (d < dk && e < dv) {
          G[(int64_t)d * dv + e] = acc[i][j];
          hg = fmaf(Hn[(int64_t)d * dv + e], acc[i][j], hg);
        }
      }
    sm.a[threadIdx.x] = hg;            // the slab is free: tile_mm ended
    __syncthreads();                   // (and sm.y is written)
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int u = 0; u < kThreads; ++u) s += sm.a[u];
      c.hg[(bhn * ndt + di) * net + ej] = s;
    }
    const float etot = expf(sm.cum[Q - 1]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= etot;
    // G <- exp(tot) G + sum_t exp(cum_t) q_t dy_t^T
    tile_mm(acc,
            Opnd{c.qrow(b, h, (int64_t)n * Q) + d0, 1, c.qss, dk - d0, Q,
                 sm.y},
            Opnd{c.dy + c.at(b, h, (int64_t)n * Q) * dv + e0, 1,
                 (int64_t)c.H * dv, dv - e0, Q, nullptr},
            0, Q, sm.a, sm.b);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = d0 + row_of(i), e = e0 + col_of(j);
      if (d < dk && e < dv) c.dh0[(bh * dk + d) * dv + e] = acc[i][j];
    }
}

// Launch 1: blocks [0, nscore) are score blocks, the rest walk blocks.
__global__ void __launch_bounds__(kThreads, 2)
    ssd_wide_bwd_walk(const Call c, int nscore) {
  __shared__ __align__(16) Smem sm;
  if ((int)blockIdx.x < nscore)
    score_block(c, blockIdx.x, sm);
  else
    walk_block(c, blockIdx.x - nscore, sm);
}

// Launch 2: one output tile of dq, dk or dv for one (b, h, chunk). Blocks
// [0, nq) are dq's (b, h, chunk, rows t, columns of dk), the next nq dk's
// and the rest dv's (b, h, chunk, rows s, columns of dv).
__global__ void __launch_bounds__(kThreads, 2)
    ssd_wide_bwd_rows(const Call c, int nq) {
  __shared__ __align__(16) Smem sm;
  const int nc = c.nc(), Q = c.Q, dk = c.dk, dv = c.dv, ntt = c.ntt(),
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
  gates(c, b, h, n, sm);
  // the rows' scale of the state term: exp(cum_t) for dq, w_s for dk, dv
  const float tot = sm.cum[Q - 1];
  for (int t = threadIdx.x; t < Q; t += kThreads)
    sm.y[t] = kind == 0 ? expf(sm.cum[t]) : expf(tot - sm.cum[t]) * sm.x[t];
  const float* G = c.G + bhn * dk * dv;
  const float* Pm = (kind == 2 ? c.P : c.R) + bhn * Q * Q;
  float acc[8][8];
  zero(acc);
  if (kind == 0)        // H_n dy_t over dv
    tile_mm(acc,
            Opnd{c.dy + c.at(b, h, row0 + r0) * dv, (int64_t)c.H * dv, 1,
                 Q - r0, dv, nullptr},
            Opnd{c.state(b, h, n) + (int64_t)c0 * dv, dv, 1, dk - c0, dv,
                 nullptr},
            0, dv, sm.a, sm.b);
  else if (kind == 1)   // G_n v_s over dv
    tile_mm(acc,
            Opnd{c.vrow(b, h, row0 + r0), c.vss, 1, Q - r0, dv, nullptr},
            Opnd{G + (int64_t)c0 * dv, dv, 1, dk - c0, dv, nullptr}, 0, dv,
            sm.a, sm.b);
  else                  // G_n^T k_s over dk
    tile_mm(acc,
            Opnd{c.krow(b, h, row0 + r0), c.kss, 1, Q - r0, dk, nullptr},
            Opnd{G + c0, 1, dv, dv - c0, dk, nullptr}, 0, dk, sm.a, sm.b);
  if (kind < 2) {
    // the tile's share of q_t . H_n dy_t (dq) or k_s . G_n v_s (dk)
    float part[8] = {};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = r0 + row_of(i);
      if (t >= Q) continue;
      const float* x = kind == 0 ? c.qrow(b, h, row0 + t) : c.krow(b, h,
                                                                  row0 + t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = c0 + col_of(j);
        if (d < dk) part[i] = fmaf(x[d], acc[i][j], part[i]);
      }
    }
    row_parts(sm.a, part);
    __syncthreads();
    if (threadIdx.x < kT && r0 + threadIdx.x < Q)
      (kind == 0 ? c.pq : c.pk)[(bhn * ndt + cj) * Q + r0 + threadIdx.x] =
          sum16(sm.a, threadIdx.x);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = r0 + row_of(i);
    const float f = t < Q ? sm.y[t] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] *= f;
  }
  // the chunk's term: R k over s <= t (dq), R^T q (dk) and P^T dy (dv) over
  // t >= s
  if (kind == 0)
    tile_mm(acc, Opnd{Pm + (int64_t)r0 * Q, Q, 1, Q - r0, Q, nullptr},
            Opnd{c.krow(b, h, row0) + c0, 1, c.kss, dk - c0, Q, nullptr}, 0,
            min(Q, r0 + kT), sm.a, sm.b);
  else if (kind == 1)
    tile_mm(acc, Opnd{Pm + r0, 1, Q, Q - r0, Q, nullptr},
            Opnd{c.qrow(b, h, row0) + c0, 1, c.qss, dk - c0, Q, nullptr}, r0,
            Q, sm.a, sm.b);
  else
    tile_mm(acc, Opnd{Pm + r0, 1, Q, Q - r0, Q, nullptr},
            Opnd{c.dy + c.at(b, h, row0) * dv + c0, 1, (int64_t)c.H * dv,
                 dv - c0, Q, nullptr},
            r0, Q, sm.a, sm.b);
  float* out = kind == 0 ? c.dq : kind == 1 ? c.dk_out : c.dv_out;
  const int width = kind < 2 ? dk : dv;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = r0 + row_of(i);
    if (t >= Q) continue;
    float* o = out + c.at(b, h, row0 + t) * width;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + col_of(j);
      if (col < width) o[col] = acc[i][j];
    }
  }
}

// Launch 3: one block per (b, h, chunk): di, and da as the reverse cumsum
// of dcum, from the tiles' partial sums, each added in one fixed order.
__global__ void __launch_bounds__(kThreads)
    ssd_wide_bwd_gates(const Call c) {
  __shared__ __align__(16) Smem sm;
  const int nc = c.nc(), Q = c.Q, ntt = c.ntt(), ndt = c.ndt(),
            net = c.net();
  const int64_t bhn = blockIdx.x;
  const int n = (int)(bhn % nc);
  const int64_t bh = bhn / nc;
  const int h = (int)(bh % c.H);
  const int64_t b = bh / c.H;
  const int64_t row0 = (int64_t)n * Q;
  gates(c, b, h, n, sm);
  const float tot = sm.cum[Q - 1];
  const int t = threadIdx.x;
  if (t < Q) {
    float rg = 0.f, cs = 0.f, inter = 0.f, kz = 0.f;
    for (int j = 0; j <= t / kT; ++j) rg += c.rows[(bhn * ntt + j) * Q + t];
    for (int i = t / kT; i < ntt; ++i) cs += c.cols[(bhn * ntt + i) * Q + t];
    for (int j = 0; j < ndt; ++j) {
      inter += c.pq[(bhn * ndt + j) * Q + t];
      kz += c.pk[(bhn * ndt + j) * Q + t];
    }
    inter *= expf(sm.cum[t]);
    const float ew = expf(tot - sm.cum[t]), is = sm.x[t], w = ew * is;
    c.di[c.at(b, h, row0 + t)] = fmaf(ew, kz, cs);
    sm.y[t] = rg - is * cs + inter - w * kz;     // dcum
    sm.a[t] = w * kz;
  }
  __syncthreads();
  if (t == 0) {
    // the gradient of tot joins dcum at Q - 1; da is dcum's reverse cumsum
    float hg = 0.f, sw = 0.f;
    for (int u = 0; u < ndt * net; ++u) hg += c.hg[bhn * ndt * net + u];
    for (int s = 0; s < Q; ++s) sw += sm.a[s];
    float run = fmaf(expf(tot), hg, sw);
    for (int s = Q - 1; s >= 0; --s) {
      run += sm.y[s];
      c.da[c.at(b, h, row0 + s)] = run;
    }
  }
}

bool valid(int B, int S, int H, int dk, int dv, int chunk) {
  return B >= 1 && S >= 1 && H >= 1 && chunk >= 1 && chunk <= kMaxQ &&
         S % chunk == 0 && dk >= 1 && dv >= 1;
}

}  // namespace

// Floats of the scratch buffer a call needs (Layout above), as bytes, into
// *bytes.
extern "C" int repro_ssd_scan_wide_bwd_scratch(int B, int S, int H, int dk,
                                               int dv, int chunk,
                                               long long* bytes) {
  if (!valid(B, S, H, dk, dv, chunk)) return cudaErrorInvalidValue;
  *bytes = 4 * Layout(B, S, H, dk, dv, chunk).total;
  return cudaSuccess;
}

// q, k: (B, S, H, dk), v: (B, S, H, dv), f32 with element strides (sb, ss,
// sh, 1) each (a head stride may be 0). a, i: (B, S, H) f32 contiguous;
// states: (B, S / chunk, H, dk, dv) f32, the state before each chunk as
// ssd_scan_wide.cu writes it; dy: (B, S, H, dv) f32 contiguous; dh_final:
// (B, H, dk, dv) f32 or null for zeros. scratch: scratch_bytes (at least
// repro_ssd_scan_wide_bwd_scratch), 16-byte aligned, for the launches' own
// use. Out, all f32 contiguous: dq, dk (B, S, H, dk), dv (B, S, H, dv), da,
// di (B, S, H), dh0 (B, H, dk, dv). S % chunk == 0, chunk <= 256. Three
// launches on ``stream``. Returns a cudaError_t.
extern "C" int repro_ssd_scan_wide_bwd(
    const float* q, const float* k, const float* v, const float* a,
    const float* i, const float* states, const float* dy,
    const float* dh_final, int B, int S, int H, int dk, int dv, int chunk,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, void* scratch,
    long long scratch_bytes, float* dq, float* dk_out, float* dv_out,
    float* da, float* di, float* dh0, void* stream) {
  if (!valid(B, S, H, dk, dv, chunk) || !states || !rt::aligned16(scratch))
    return cudaErrorInvalidValue;
  const Layout lay(B, S, H, dk, dv, chunk);
  if (scratch_bytes < 4 * lay.total) return cudaErrorInvalidValue;
  float* base = static_cast<float*>(scratch);
  Call c;
  c.q = q, c.k = k, c.v = v, c.a = a, c.gi = i, c.states = states;
  c.dy = dy, c.dh_final = dh_final;
  c.S = S, c.H = H, c.dk = dk, c.dv = dv, c.Q = chunk;
  c.qsb = qsb, c.qss = qss, c.qsh = qsh, c.ksb = ksb, c.kss = kss;
  c.ksh = ksh, c.vsb = vsb, c.vss = vss, c.vsh = vsh;
  c.G = base + lay.g, c.P = base + lay.p, c.R = base + lay.r;
  c.rows = base + lay.rows, c.cols = base + lay.cols;
  c.pq = base + lay.pq, c.pk = base + lay.pk, c.hg = base + lay.hg;
  c.dq = dq, c.dk_out = dk_out, c.dv_out = dv_out;
  c.da = da, c.di = di, c.dh0 = dh0;
  const long long bh = (long long)B * H, bhn = bh * (S / chunk);
  const long long ntt = c.ntt(), ndt = c.ndt(), net = c.net();
  const long long nscore = bhn * (ntt * (ntt + 1) / 2);
  const long long g1 = nscore + bh * ndt * net;
  const long long nq = bhn * ntt * ndt;
  const long long g2 = 2 * nq + bhn * ntt * net;
  if (g1 > INT_MAX || g2 > INT_MAX || bhn > INT_MAX)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  ssd_wide_bwd_walk<<<(unsigned)g1, kThreads, 0, st>>>(c, (int)nscore);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_wide_bwd_rows<<<(unsigned)g2, kThreads, 0, st>>>(c, (int)nq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_wide_bwd_gates<<<(unsigned)bhn, kThreads, 0, st>>>(c);
  return cudaGetLastError();
}
