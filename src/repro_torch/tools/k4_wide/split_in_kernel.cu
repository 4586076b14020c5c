// A candidate of tools/k4_wide_designs.py, not built into the kernel
// library: the chunk-parallel split on the tensor cores in two launches,
// each block splitting its f32 operands into bf16 parts in its own product
// loops (q, k and v once for every 128-column tile that reads them). At
// the serve shape on an H100 SXM (700 W) it took ~1.72 ms against ~1.17
// for csrc/ssd_scan_wide.cu, which splits them once in a launch of its
// own; the same bits.
//
// K4 at wide heads: the SSD / decay-attention chunk scan of mLSTM's prefill.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py:_kernel (wrapped
// by ssd_scan) where the reference calls its chunked_decay_attention at
// mLSTM's heads (src/repro/models/ssm.py:apply_mlstm): dk = dh, dv = dh + 1
// (v with the normalizer's ones column appended) and chunks of up to 256
// positions; xlstm-1.3b has dh = 1024 and chunk 256. The function is the
// narrow kernel's (ssd_scan.cu), with cum the chunk's inclusive cumsum of
// the log-decays a, tot = cum_{Q-1} and w_s = exp(tot - cum_s) i_s:
//   y_t  = sum_{s<=t} P_ts v_s + exp(cum_t) q_t . h_n,
//          P_ts = (q_t . k_s) exp(cum_t - cum_s) i_s                (s <= t)
//   h_n+1 = exp(tot) h_n + sum_s k_s (x) (w_s v_s)
// over f32 q, k, v; y, the gates and the states are f32.
//
// Bound on the H100. At xlstm-1.3b's prefill (B 4, S 1024, H 4, dk 1024,
// dv 1025, Q 256) the function needs 77.4 GFLOP against 336 MB of HBM bytes
// (q and k per head): 230 flops per byte, below the bf16 tensor cores' ridge
// (295) but eleven times the f32 ordinary cores' (20). 88.9 % of the flops
// are two dense products a chunk, q . h and k^T (w v), each 256 x 1024 x
// 1025. So every product runs on the tensor cores (mma.sync m16n8k16, bf16
// in, f32 accumulators, operands by ldmatrix).
//
// Accuracy, as in the narrow kernel. The operands that are f32 by nature,
// the gated scores P, the state h_n in q . h_n and w v, enter as two bf16
// parts each (rt::split_bf16: part j rounds what parts 0 .. j - 1 left;
// ~16 bits, a relative error of ~2^-17, inside the card check of 1e-4 of
// max|plain f32|; ssd_scan_ref(parts=2) emulates it on the CPU, and one
// part, the fault p_one_part, fails). f32 q, k and v enter as three parts,
// which hold an f32 value exactly, and each operand pair takes the part
// products i + j < max(parts): five for q . h, k^T (w v) and P v, six for
// q k^T (the dropped ones are ~2^-24 of a term). The products of a part
// that is zero across a slab are skipped: at the serve q, k and v are bf16
// values upcast (models/ssm.py), their second and third parts are zero, and
// each of the two large products takes two part products, not five. A
// skipped product would have added exact zeros, so the skip moves no bit.
// The carried state stays f32 in the accumulators of the blocks that own
// it; only its operand copy for q . h_n is split.
//
// The decay is not folded into q and k: exp(cum_t - cum_s) cannot be
// factored as exp(cum_t) exp(-cum_s), which overflows. It is computed from
// the difference at or below the diagonal, and the score is selected to 0
// above it, never multiplied by a mask.
//
// Design: the chunk-parallel split of Mamba2's SSD (ssd_scan_ref computes
// the same), two launches a call, every block 8 warps over a 128 x 128
// output tile (a warp 64 x 32), its reduction in slabs of 32 that run
// through two stages of shared memory, each operand in bf16 part planes
// read by ldmatrix (rows padded to an odd count of 16-byte pieces, so the
// eight row reads of an ldmatrix hit distinct banks).
//   Launch 1, two kinds of block. State blocks own a 128 x 128 tile of one
//   (b, h)'s dk x dv state and walk the chunks in order: at each chunk they
//   write the state before it, in its two parts, to a scratch buffer (the
//   states of every (b, h, chunk), 270 MB at the serve shape), then
//   h = exp(tot) h + k^T (w v) in their accumulators (the k rows and w v of
//   the tile, 32 positions a slab). Score blocks (after the state blocks in
//   the grid) compute one 128 x 128 tile of P on or below the diagonal of a
//   (b, h, chunk), q k^T over dk in slabs of 32, gate it and write its two
//   parts (zeros above the diagonal) to the scratch buffer.
//   Launch 2: one block per (b, h, chunk, 128 rows, 128 columns of y):
//   q . h_n over dk (none at the first chunk without an initial state, whose
//   state is zero), scaled by exp(cum_t), then P v over the chunk's
//   positions up to the tile's last row.
// So no block re-reads a whole chunk's q and k (the first design, at f5f169e:
// 1,040 blocks of 16 columns each read every chunk's q, k and P), the states'
// round trip through HBM is the price of the parallelism, and every sum has
// one order.
// f32 operands come into registers a slab ahead (16-byte loads where rows
// are 16-byte aligned; v's rows of dv = 1025 floats are not) and are split
// into the other stage after the slab's products; bf16 parts written by
// launch 1 come in by cp.async. The chunk's cumsum of the gates is one
// warp's fixed-order scan (chunk_cumsum), the same code in every block, so
// all blocks agree to the bit. No atomics: two calls give the same bits.
//
// No bf16 path and no backward here: mLSTM hands over f32 q, k (upcast from
// the model dtype) and v; the wrapper raises for other dtypes at these
// shapes, and for a call whose gradient is wanted.
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxQ = 256;            // chunk positions
constexpr int kMaxDk = 1024;          // state rows
constexpr int kNI = 3;                // parts of f32 q, k, v
constexpr int kNP = 2;                // parts of P, the states, w v
constexpr int kT = 128;               // a block's output tile is kT x kT
constexpr int kK = 32;                // the reduction's slab
constexpr int kRS = kK + 8;           // row stride (bf16) of a [128][32] plane
constexpr int kCS = kT + 8;           // row stride of a [32][128] plane
constexpr int kRowPlane = kT * kRS;   // bf16 elements of a plane
constexpr int kColPlane = kK * kCS;
constexpr int kGateFloats = 1024;     // gates at the start of shared memory

constexpr int cmax(int x, int y) { return x > y ? x : y; }
// bf16 elements of one stage: launch 1 (a state block's k and w v, or a
// score block's q and k), launch 2 (q and h_n's parts, or P's parts and v)
constexpr int kStage1 = cmax((kNI + kNP) * kColPlane, 2 * kNI * kRowPlane);
constexpr int kStage2 = cmax(kNI * kRowPlane + kNP * kColPlane,
                             kNP * kRowPlane + kNI * kColPlane);
constexpr int smem_bytes(int stage) { return kGateFloats * 4 + 2 * stage * 2; }

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The chunk's inclusive cumsum of the log-decays a[s * stride], s < Q, into
// cum[0 .. Q): warp 0 alone, lane l summing its strip of ceil(Q / 32)
// positions in order after the shuffle scan of the strip totals. The same
// code in every block, so the same bits. The caller synchronizes.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ a,
                                             int64_t stride, int Q,
                                             float* __restrict__ cum) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int per = (Q + 31) / 32;
  const int s0 = lane * per;
  float tot = 0.f;
  for (int j = 0; j < per; ++j)
    if (s0 + j < Q) tot += a[(int64_t)(s0 + j) * stride];
  float inc = tot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float x = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += x;
  }
  float run = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) run = 0.f;
  for (int j = 0; j < per; ++j)
    if (s0 + j < Q) {
      run += a[(int64_t)(s0 + j) * stride];
      cum[s0 + j] = run;
    }
}

// A thread's share of an f32 slab: four runs of 4 columns. In a [128][32]
// slab (kWide false) run j is row tid / 8 + 32 j, columns 4 (tid % 8) ..;
// in a [32][128] slab (kWide) row tid / 32 + 8 j, columns 4 (tid % 32) ...
template <bool kWide>
__device__ __forceinline__ int run_row(int j) {
  return kWide ? threadIdx.x / 32 + 8 * j : threadIdx.x / 8 + 32 * j;
}
template <bool kWide>
__device__ __forceinline__ int run_col() {
  return kWide ? 4 * (threadIdx.x % 32) : 4 * (threadIdx.x % 8);
}

// The thread's 16 values of an f32 slab into registers: element (r, c) at
// base[r * rs + c], read where r < nrows and c < ncols, else 0; 16-byte
// loads where vec (base and rs keep every row 16-byte aligned).
template <bool kWide>
__device__ __forceinline__ void load_f32(float (&x)[4][4],
                                         const float* __restrict__ base,
                                         int64_t rs, int nrows, int ncols,
                                         bool vec) {
  const int c = run_col<kWide>();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = run_row<kWide>(j);
    if (r < nrows && vec && c + 4 <= ncols) {
      const float4 f =
          __ldg(reinterpret_cast<const float4*>(base + r * rs + c));
      x[j][0] = f.x, x[j][1] = f.y, x[j][2] = f.z, x[j][3] = f.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[j][e] = r < nrows && c + e < ncols ? __ldg(base + r * rs + c + e)
                                             : 0.f;
    }
  }
}

// The thread's 16 values (row r times scale[r] where scale is given) split
// into N bf16 part planes of a slab in shared memory (plane p at planes +
// p * plane). Returns the mask of the parts p >= 1 that hold a nonzero
// value here (bit p).
template <bool kWide, int N>
__device__ __forceinline__ int store_parts(const float (&x)[4][4],
                                           bf16* planes, int plane,
                                           const float* scale) {
  constexpr int stride = kWide ? kCS : kRS;
  const int c = run_col<kWide>();
  int nz = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = run_row<kWide>(j);
    const float s = scale ? scale[r] : 1.f;
    uint32_t lo[N], hi[N];
    rt::split_bf16<N>(x[j][0] * s, x[j][1] * s, lo);
    rt::split_bf16<N>(x[j][2] * s, x[j][3] * s, hi);
#pragma unroll
    for (int p = 0; p < N; ++p) {
      *reinterpret_cast<uint2*>(planes + p * plane + r * stride + c) =
          make_uint2(lo[p], hi[p]);
      if (p > 0 && (lo[p] | hi[p])) nz |= 1 << p;
    }
  }
  return nz;
}

// How many leading parts of a slab are in use anywhere in the block, given
// each thread's mask from store_parts: a part that is zero leaves a zero
// remainder, so the parts in use are a prefix. Every thread calls it: it is
// the block's barrier after a stage is filled.
template <int N>
__device__ __forceinline__ int parts_in_use(int nz) {
  int n = 1;
  if (__syncthreads_or(nz)) {
#pragma unroll
    for (int p = 1; p < N; ++p) n += __syncthreads_or(nz >> p & 1) ? 1 : 0;
  }
  return n;
}

// NP planes of bf16 parts of a [32][128] (kWide) or [128][32] slab from
// global memory (plane p at src + p * splane, rows rs elements apart; row
// r read where r < nrows, the 8-wide piece at column c where c < ncols)
// into shared memory by cp.async, zero where not read.
template <bool kWide>
__device__ __forceinline__ void stage_parts(bf16* dst,
                                            const bf16* __restrict__ src,
                                            int64_t splane, int64_t rs,
                                            int nrows, int ncols) {
  constexpr int per_row = (kWide ? kT : kK) / 8;
  constexpr int pieces = (kWide ? kK : kT) * per_row;     // 512 a plane
  constexpr int stride = kWide ? kCS : kRS;
  constexpr int dplane = kWide ? kColPlane : kRowPlane;
#pragma unroll
  for (int it = 0; it < kNP * pieces / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int p = e / pieces, r = e % pieces / per_row,
              c = 8 * (e % per_row);
    const bool ok = r < nrows && c < ncols;
    rt::cp_async16_zfill(dst + p * dplane + r * stride + c,
                         ok ? src + p * splane + r * rs + c : src,
                         ok ? 16 : 0);
  }
}

// acc += A B over one slab on the tensor cores. A (128 x 32) in NA part
// planes, stored [K][M] (kAK, read by ldmatrix.trans) or [M][K]; B (32 x
// 128) in NB planes, stored [K][N] (kBK) or [N][K]; only the first na and
// nb parts are in use, and of those the products i + j < max(NA, NB) run,
// in one fixed order. Warp w owns rows 64 (w / 4) .. + 64 and columns
// 32 (w % 4) .. + 32 of the tile: acc[m][n] is the 16 x 8 tile m, n there.
template <bool kAK, bool kBK, int NA, int NB>
__device__ __forceinline__ void mma_slab(float (&acc)[4][4][4],
                                         const bf16* A, const bf16* B,
                                         int na, int nb) {
  constexpr int AP = kAK ? kColPlane : kRowPlane;
  constexpr int BP = kBK ? kColPlane : kRowPlane;
  constexpr int kTerms = NA > NB ? NA : NB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = 64 * (warp >> 2), wn = 32 * (warp & 3);
  const int l7 = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
#pragma unroll
  for (int ks = 0; ks < kK; ks += 16) {
    uint32_t b[NB][4][2];
#pragma unroll
    for (int p = 0; p < NB; ++p) {
      if (p >= nb) break;
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        const int n0 = wn + 16 * np;
        if constexpr (kBK)
          rt::ldmatrix_x4_trans(
              r, B + p * BP + (ks + l7 + 8 * l8) * kCS + n0 + 8 * l16);
        else
          rt::ldmatrix_x4(
              r, B + p * BP + (n0 + l7 + 8 * l16) * kRS + ks + 8 * l8);
        b[p][2 * np][0] = r[0], b[p][2 * np][1] = r[1];
        b[p][2 * np + 1][0] = r[2], b[p][2 * np + 1][1] = r[3];
      }
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      if (i >= na) break;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t af[4];
        const int m0 = wm + 16 * m;
        if constexpr (kAK)
          rt::ldmatrix_x4_trans(
              af, A + i * AP + (ks + l7 + 8 * l16) * kCS + m0 + 8 * l8);
        else
          rt::ldmatrix_x4(
              af, A + i * AP + (m0 + (lane & 15)) * kRS + ks + 8 * l16);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          if (i + j < kTerms && j < nb)
#pragma unroll
            for (int n = 0; n < 4; ++n)
              rt::mma(acc[m][n], af, b[j][n][0], b[j][n][1]);
      }
    }
  }
}

// Where the thread's accumulator acc[m][n][e] sits in the 128 x 128 tile.
__device__ __forceinline__ int acc_row(int m, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return 64 * (warp >> 2) + 16 * m + (lane >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int n, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return 32 * (warp & 3) + 8 * n + 2 * (lane & 3) + (e & 1);
}

// The pieces of a call that every block reads.
struct Call {
  const float* q;
  const float* k;
  const float* v;
  const float* a;
  const float* gi;
  const float* h0;          // null: a zero initial state
  int S, H, dk, dv, Q;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  bool vec_qk, vec_v;       // 16-byte loads of q and k rows, of v rows
  bf16* hb;                 // parts of the state before each chunk
  bf16* P;                  // parts of the gated scores
  __host__ __device__ int nc() const { return S / Q; }
  __host__ __device__ int dvp() const { return round_up(dv, 8); }
  __host__ __device__ int Qp() const { return round_up(Q, 8); }
  // plane p of (b, h)'s state before chunk n: dk rows of dvp
  __device__ bf16* hb_plane(int64_t bh, int n, int p) const {
    return hb + ((bh * nc() + n) * kNP + p) * (int64_t)dk * dvp();
  }
  // plane p of (b, h, chunk)'s gated scores: Q rows of Qp
  __device__ bf16* p_plane(int64_t bhn, int p) const {
    return P + (bhn * kNP + p) * (int64_t)Q * Qp();
  }
};

// Launch 1, a state block: the tile (rows d0 .., columns e0 ..) of one
// (b, h)'s state, walking the chunks; the f32 final state at the end.
__device__ __forceinline__ void state_block(const Call& c, int bid, float* sm,
                                            float* __restrict__ h_out) {
  const int dvp = c.dvp(), nc = c.nc(), Q = c.Q, dk = c.dk, dv = c.dv;
  const int nrt = rt::cdiv(dk, kT), nct = rt::cdiv(dvp, kT);
  const int d0 = kT * (bid / nct % nrt), e0 = kT * (bid % nct);
  const int64_t bh = bid / (nct * nrt);
  const int h = (int)(bh % c.H);
  const int64_t b = bh / c.H;
  constexpr int GW = kMaxQ + 1;        // w_s, then tot at [kMaxQ]
  float* cum = sm;
  float* gw = sm + kMaxQ;              // two chunks' gates
  bf16* stage = reinterpret_cast<bf16*>(sm + kGateFloats);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float acc[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = d0 + acc_row(m, e), col = e0 + acc_col(n, e);
        acc[m][n][e] = c.h0 && d < dk && col < dv
                           ? c.h0[(bh * dk + d) * dv + col] : 0.f;
      }
  // warp 0: chunk n's w and tot into w
  auto gates = [&](int n, float* w) {
    const int64_t g0 = (b * c.S + (int64_t)n * Q) * c.H + h;
    chunk_cumsum(c.a + g0, c.H, Q, cum);
    __syncwarp();
    const float tot = cum[Q - 1];
    for (int s = lane; s < kMaxQ; s += 32)
      w[s] = s < Q ? expf(tot - cum[s]) * c.gi[g0 + (int64_t)s * c.H] : 0.f;
    if (lane == 0) w[kMaxQ] = tot;
    __syncwarp();
  };
  const int J = rt::cdiv(Q, kK), G = nc * J;
  const float* kb = c.k + b * c.ksb + h * c.ksh + d0;
  const float* vb = c.v + b * c.vsb + h * c.vsh + e0;
  float xk[4][4], xv[4][4];
  auto load = [&](int g) {
    const int j = g % J;
    const int64_t s0 = (int64_t)(g / J) * Q + kK * j;
    load_f32<true>(xk, kb + s0 * c.kss, c.kss, Q - kK * j, dk - d0,
                   c.vec_qk);
    load_f32<true>(xv, vb + s0 * c.vss, c.vss, Q - kK * j, dv - e0,
                   c.vec_v);
  };
  auto store = [&](int g, int buf) {
    bf16* st = stage + buf * kStage1;
    const int nz = store_parts<true, kNI>(xk, st, kColPlane, nullptr);
    store_parts<true, kNP>(xv, st + kNI * kColPlane, kColPlane,
                           gw + (g / J & 1) * GW + kK * (g % J));
    return nz;
  };

  if (warp == 0) gates(0, gw);
  load(0);
  __syncthreads();
  int nk = parts_in_use<kNI>(store(0, 0));
  for (int g = 0; g < G; ++g) {
    const int n = g / J, buf = g & 1;
    if (g % J == 0) {
      // chunk n + 1's gates into the buffer chunk n - 1 has left
      if (warp == 0 && n + 1 < nc) gates(n + 1, gw + ((n + 1) & 1) * GW);
      if (J == 1) __syncthreads();   // they are read below, this slab
      if (n > 0 || c.h0) {           // launch 2 reads no zero state
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int nn = 0; nn < 4; ++nn)
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              const int d = d0 + acc_row(m, e), col = e0 + acc_col(nn, e);
              if (d >= dk || col >= dvp) continue;
              uint32_t part[kNP];
              rt::split_bf16<kNP>(acc[m][nn][e], acc[m][nn][e + 1], part);
#pragma unroll
              for (int p = 0; p < kNP; ++p)
                *reinterpret_cast<uint32_t*>(c.hb_plane(bh, n, p) +
                                             (int64_t)d * dvp + col) = part[p];
            }
      }
      const float dec = expf(gw[(n & 1) * GW + kMaxQ]);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][nn][e] *= dec;
    }
    if (g + 1 < G) load(g + 1);
    bf16* st = stage + buf * kStage1;
    mma_slab<true, true, kNI, kNP>(acc, st, st + kNI * kColPlane, nk, kNP);
    int nz = 0;
    if (g + 1 < G) nz = store(g + 1, buf ^ 1);
    nk = parts_in_use<kNI>(nz);
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = d0 + acc_row(m, e), col = e0 + acc_col(n, e);
        if (d < dk && col < dv) h_out[(bh * dk + d) * dv + col] = acc[m][n][e];
      }
}

// Launch 1, a score block: the 128 x 128 tile (rows t0 .., columns s0 ..
// <= t0) of one (b, h, chunk)'s gated scores P, in parts; 0 above the
// diagonal.
__device__ __forceinline__ void score_block(const Call& c, int bid,
                                            float* sm) {
  const int nc = c.nc(), Q = c.Q, Qp = c.Qp(), dk = c.dk;
  const int ntt = rt::cdiv(Q, kT), tiles = ntt * (ntt + 1) / 2;
  const int64_t bhn = bid / tiles;
  const int tile = bid % tiles;
  const int n = (int)(bhn % nc);
  const int64_t bh = bhn / nc;
  const int h = (int)(bh % c.H);
  const int64_t b = bh / c.H;
  int tt = 0;
  while ((tt + 1) * (tt + 2) / 2 <= tile) ++tt;
  const int t0 = kT * tt, s0 = kT * (tile - tt * (tt + 1) / 2);
  float* cum = sm;
  float* is = sm + kMaxQ;
  bf16* stage = reinterpret_cast<bf16*>(sm + kGateFloats);
  const int64_t g0 = (b * c.S + (int64_t)n * Q) * c.H + h;
  if (threadIdx.x < 32) {
    chunk_cumsum(c.a + g0, c.H, Q, cum);
    for (int s = threadIdx.x; s < kMaxQ; s += 32)
      is[s] = s < Q ? c.gi[g0 + (int64_t)s * c.H] : 0.f;
  }
  const int64_t row0 = (int64_t)n * Q;
  const float* qb = c.q + b * c.qsb + h * c.qsh + (row0 + t0) * c.qss;
  const float* kb = c.k + b * c.ksb + h * c.ksh + (row0 + s0) * c.kss;
  float xq[4][4], xk[4][4];
  auto load = [&](int g) {
    load_f32<false>(xq, qb + kK * g, c.qss, Q - t0, dk - kK * g, c.vec_qk);
    load_f32<false>(xk, kb + kK * g, c.kss, Q - s0, dk - kK * g, c.vec_qk);
  };
  int nq, nk;
  auto store = [&](int g, int buf) {
    bf16* st = stage + buf * kStage1;
    const int zq = store_parts<false, kNI>(xq, st, kRowPlane, nullptr);
    const int zk = store_parts<false, kNI>(xk, st + kNI * kRowPlane,
                                           kRowPlane, nullptr);
    nq = parts_in_use<kNI>(zq);
    nk = parts_in_use<kNI>(zk);
  };
  float acc[4][4][4] = {};
  const int G = rt::cdiv(dk, kK);
  load(0);
  store(0, 0);
  for (int g = 0; g < G; ++g) {
    const int buf = g & 1;
    if (g + 1 < G) load(g + 1);
    bf16* st = stage + buf * kStage1;
    mma_slab<false, false, kNI, kNI>(acc, st, st + kNI * kRowPlane, nq, nk);
    if (g + 1 < G) store(g + 1, buf ^ 1);
  }
  // gate, select 0 above the diagonal, split
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int t = t0 + acc_row(m, e), s = s0 + acc_col(nn, e);
        if (t >= Q || s >= Qp) continue;
        const float p0 =
            s <= t ? acc[m][nn][e] * expf(cum[t] - cum[s]) * is[s] : 0.f;
        const float p1 = s + 1 <= t ? acc[m][nn][e + 1] *
                                          expf(cum[t] - cum[s + 1]) *
                                          is[s + 1]
                                    : 0.f;
        uint32_t part[kNP];
        rt::split_bf16<kNP>(p0, p1, part);
#pragma unroll
        for (int p = 0; p < kNP; ++p)
          *reinterpret_cast<uint32_t*>(c.p_plane(bhn, p) + (int64_t)t * Qp +
                                       s) = part[p];
      }
}

// Launch 1: blocks [0, nstate) are state blocks, the rest score blocks.
__global__ void __launch_bounds__(kThreads, 1)
    ssd_wide_chunks(const Call c, int nstate, float* __restrict__ h_out) {
  extern __shared__ __align__(16) float sm[];
  if ((int)blockIdx.x < nstate)
    state_block(c, blockIdx.x, sm, h_out);
  else
    score_block(c, blockIdx.x - nstate, sm);
}

// Launch 2: the tile (rows t0 .., columns e0 ..) of y for one (b, h, chunk):
// exp(cum_t) q_t . h_n over dk (slabs g < G1), then P v over the positions
// up to the tile's last row.
__global__ void __launch_bounds__(kThreads, 1)
    ssd_wide_y(const Call c, float* __restrict__ y) {
  extern __shared__ __align__(16) float sm[];
  const int nc = c.nc(), Q = c.Q, Qp = c.Qp(), dk = c.dk, dv = c.dv,
            dvp = c.dvp();
  const int ntt = rt::cdiv(Q, kT), nct = rt::cdiv(dv, kT);
  const int bid = blockIdx.x;
  const int t0 = kT * (bid / nct % ntt), e0 = kT * (bid % nct);
  const int64_t bhn = bid / (nct * ntt);
  const int n = (int)(bhn % nc);
  const int64_t bh = bhn / nc;
  const int h = (int)(bh % c.H);
  const int64_t b = bh / c.H;
  float* ecum = sm;
  bf16* stage = reinterpret_cast<bf16*>(sm + kGateFloats);
  const int64_t row0 = (int64_t)n * Q;
  const int64_t g0 = (b * c.S + row0) * c.H + h;
  if (threadIdx.x < 32) {
    chunk_cumsum(c.a + g0, c.H, Q, ecum);
    __syncwarp();
    for (int t = threadIdx.x; t < kMaxQ; t += 32)
      ecum[t] = t < Q ? expf(ecum[t]) : 0.f;
  }
  const int t_end = min(t0 + kT, Q);
  const int G1 = n > 0 || c.h0 ? rt::cdiv(dk, kK) : 0;
  const int G = G1 + rt::cdiv(t_end, kK);
  const float* qb = c.q + b * c.qsb + h * c.qsh + (row0 + t0) * c.qss;
  const float* vb = c.v + b * c.vsb + h * c.vsh + row0 * c.vss + e0;
  const bf16* hb = G1 ? c.hb_plane(bh, n, 0) + e0 : nullptr;
  const bf16* pb = c.p_plane(bhn, 0) + (int64_t)t0 * Qp;
  float x[4][4];
  // slab g's bf16 operand by cp.async and its f32 operand into registers
  auto stage_slab = [&](int g, int buf) {
    bf16* st = stage + buf * kStage2;
    if (g < G1) {
      stage_parts<true>(st + kNI * kRowPlane, hb + (int64_t)kK * g * dvp,
                        (int64_t)dk * dvp, dvp, dk - kK * g, dvp - e0);
      load_f32<false>(x, qb + kK * g, c.qss, Q - t0, dk - kK * g, c.vec_qk);
    } else {
      const int s0 = kK * (g - G1);
      stage_parts<false>(st, pb + s0, (int64_t)Q * Qp, Qp, Q - t0, Qp - s0);
      load_f32<true>(x, vb + s0 * c.vss, c.vss, Q - s0, dv - e0, c.vec_v);
    }
    rt::cp_async_commit();
  };
  auto split_slab = [&](int g, int buf) {
    bf16* st = stage + buf * kStage2;
    return g < G1 ? store_parts<false, kNI>(x, st, kRowPlane, nullptr)
                  : store_parts<true, kNI>(x, st + kNP * kRowPlane, kColPlane,
                                           nullptr);
  };
  float acc[4][4][4] = {};
  stage_slab(0, 0);
  int nz = split_slab(0, 0);
  rt::cp_async_wait<0>();
  int nf = parts_in_use<kNI>(nz);      // parts of q or v in use
  for (int g = 0; g < G; ++g) {
    const int buf = g & 1;
    if (g + 1 < G) stage_slab(g + 1, buf ^ 1);
    const bf16* st = stage + buf * kStage2;
    if (g < G1) {
      mma_slab<false, true, kNI, kNP>(acc, st, st + kNI * kRowPlane, nf, kNP);
    } else {
      if (g == G1 && G1 > 0) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int nn = 0; nn < 4; ++nn)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[m][nn][e] *= ecum[t0 + acc_row(m, e)];
      }
      mma_slab<false, true, kNP, kNI>(acc, st, st + kNP * kRowPlane, kNP, nf);
    }
    nz = g + 1 < G ? split_slab(g + 1, buf ^ 1) : 0;
    rt::cp_async_wait<0>();
    nf = parts_in_use<kNI>(nz);
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + acc_row(m, e), col = e0 + acc_col(nn, e);
        if (t < Q && col < dv)
          y[((b * c.S + row0 + t) * c.H + h) * dv + col] = acc[m][nn][e];
      }
}

}  // namespace

// Bytes of the scratch buffer a call needs: the two bf16 parts of the state
// before each chunk (B, H, nc, 2, dk, round_up(dv, 8)) and of the gated
// scores (B, H, nc, 2, chunk, round_up(chunk, 8)).
extern "C" int repro_ssd_scan_wide_scratch(int B, int S, int H, int dk,
                                           int dv, int chunk,
                                           long long* bytes) {
  if (B < 1 || S < 1 || H < 1 || chunk < 1 || S % chunk || dk < 1 || dv < 1)
    return cudaErrorInvalidValue;
  const long long nc = S / chunk, bhn = (long long)B * H * nc;
  *bytes = 2LL * kNP * bhn *
           ((long long)dk * round_up(dv, 8) +
            (long long)chunk * round_up(chunk, 8));
  return cudaSuccess;
}

// q, k: (B, S, H, dk), v: (B, S, H, dv), all f32 with element strides
// (sb, ss, sh, 1) each (a head stride may be 0). a, i: (B, S, H) f32
// contiguous. h0: (B, H, dk, dv) f32 contiguous, or null for a zero
// initial state. scratch: scratch_bytes (at least
// repro_ssd_scan_wide_scratch), 16-byte aligned, written by the first
// launch and read by the second. y: (B, S, H, dv) f32 contiguous; h_out:
// (B, H, dk, dv) f32, the final state. S % chunk == 0, chunk <= 256, dk <=
// 1024, any dv. Two launches on ``stream``. Returns a cudaError_t.
extern "C" int repro_ssd_scan_wide(
    const float* q, const float* k, const float* v, const float* a,
    const float* i, const float* h0, int B, int S, int H, int dk, int dv,
    int chunk, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, void* scratch, long long scratch_bytes, float* y,
    float* h_out, void* stream) {
  const int Q = chunk;
  long long need = 0;
  if (B < 1 || S < 1 || H < 1 || Q < 1 || Q > kMaxQ || S % Q != 0 ||
      dk < 1 || dk > kMaxDk || dv < 1 || !rt::aligned16(scratch) ||
      repro_ssd_scan_wide_scratch(B, S, H, dk, dv, Q, &need) ||
      scratch_bytes < need)
    return cudaErrorInvalidValue;
  Call c;
  c.q = q, c.k = k, c.v = v, c.a = a, c.gi = i, c.h0 = h0;
  c.S = S, c.H = H, c.dk = dk, c.dv = dv, c.Q = Q;
  c.qsb = qsb, c.qss = qss, c.qsh = qsh, c.ksb = ksb, c.kss = kss,
  c.ksh = ksh, c.vsb = vsb, c.vss = vss, c.vsh = vsh;
  c.vec_qk = rt::aligned16(q) && rt::aligned16(k) && qsb % 4 == 0 &&
             qss % 4 == 0 && qsh % 4 == 0 && ksb % 4 == 0 && kss % 4 == 0 &&
             ksh % 4 == 0;
  c.vec_v = rt::aligned16(v) && vsb % 4 == 0 && vss % 4 == 0 &&
            vsh % 4 == 0;
  const int nc = S / Q;
  const long long bhn = (long long)B * H * nc;
  c.hb = static_cast<bf16*>(scratch);
  c.P = c.hb + bhn * kNP * (long long)dk * c.dvp();
  const int ntt = rt::cdiv(Q, kT);
  const long long nstate = (long long)B * H * rt::cdiv(dk, kT) *
                           rt::cdiv(c.dvp(), kT);
  const long long g1 = nstate + bhn * (ntt * (ntt + 1) / 2);
  const long long g2 = bhn * ntt * rt::cdiv(dv, kT);
  if (g1 > INT_MAX || g2 > INT_MAX) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  static uint32_t raised1 = 0, raised2 = 0;   // devices where the limit is up
  cudaError_t err =
      rt::raise_smem_once(ssd_wide_chunks, smem_bytes(kStage1), raised1);
  if (err == cudaSuccess)
    err = rt::raise_smem_once(ssd_wide_y, smem_bytes(kStage2), raised2);
  if (err != cudaSuccess) return err;
  ssd_wide_chunks<<<(unsigned)g1, kThreads, smem_bytes(kStage1), st>>>(
      c, (int)nstate, h_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_wide_y<<<(unsigned)g2, kThreads, smem_bytes(kStage2), st>>>(c, y);
  return cudaGetLastError();
}
