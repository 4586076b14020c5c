// K4 at wide heads: the SSD / decay-attention chunk scan of mLSTM's prefill.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py:_kernel (wrapped
// by ssd_scan) where the reference calls its chunked_decay_attention at
// mLSTM's heads (src/repro/models/ssm.py:apply_mlstm): dk = dh, dv = dh + 1
// (v with the normalizer's ones column appended) and chunks of up to 256
// positions; xlstm-1.3b has dh = 1024 and chunk 256. The function is the
// narrow kernel's (ssd_scan.cu), with cum the chunk's inclusive cumsum of
// the log-decays a, tot = cum_{Q-1} and w_s = exp(tot - cum_s) i_s:
//   y_t   = sum_{s<=t} P_ts v_s + exp(cum_t) q_t . h_n,
//           P_ts = (q_t . k_s) exp(cum_t - cum_s) i_s              (s <= t)
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
// q k^T (the dropped ones are ~2^-24 of a term). A part that is zero over
// a slab of 32 positions is neither written nor multiplied: at the serve
// q, k and v are bf16 values upcast (models/ssm.py), their second and third
// parts are zero, and each of the two large products takes two part
// products, not five. A skipped product would have added exact zeros, so
// the skip moves no bit. The carried state stays f32 in the accumulators of
// the blocks that own it; only its operand copy for q . h_n is split.
//
// The decay is not folded into q and k: exp(cum_t - cum_s) cannot be
// factored as exp(cum_t) exp(-cum_s), which overflows. It is computed from
// the difference at or below the diagonal, and the score is selected to 0
// above it, never multiplied by a mask.
//
// Design: the chunk-parallel split of Mamba2's SSD (ssd_scan_ref computes
// the same), three launches a call on the caller's stream, into a scratch
// buffer that the wrapper allocates.
//   Launch 0 (split): one block per (b, h, chunk, 32 positions) writes the
//   bf16 parts of q, k, v and w v for those rows (only the parts in use,
//   and their count), and the chunk's cumsum of the gates: one warp's
//   fixed-order scan (rt::chunk_cumsum), so every later use of the gates
//   agrees to the bit. Splitting each operand once here, and not in every
//   block that multiplies it, keeps the products' loops lean: a version that
//   split f32 operands inside them was ~1.5x slower
//   (tools/k4_wide/split_in_kernel.cu).
//   Launch 1, two kinds of block, each 8 warps over a 128 x 128 output tile
//   (a warp 64 x 32). State blocks own a tile of one (b, h)'s dk x dv state
//   and walk the chunks in order: at each chunk they write the state before
//   it, in its two parts, to the scratch buffer (every (b, h, chunk)'s, 270
//   MB at the serve shape), and where the caller asks for them (autograd
//   records: the backward, ssd_scan_wide_bwd.cu, reads them) also in f32
//   into an output of its own (B, nc, H, dk, dv), then h = exp(tot) h +
//   k^T (w v) in their accumulators. Score blocks (after the state blocks
//   in the grid) compute
//   one 128 x 128 tile of P on or below the diagonal of a (b, h, chunk),
//   q k^T over dk, gate it and write its two parts (zeros above the
//   diagonal).
//   Launch 2: one block per (b, h, chunk, 128 rows, 128 columns of y):
//   q . h_n over dk (none at the first chunk without an initial state, whose
//   state is zero), scaled by exp(cum_t), then P v over the chunk's
//   positions up to the tile's last row.
// In launches 1 and 2 every operand is bf16 part planes that cp.async brings
// into a ring of three or four stages of shared memory, slabs of 32 along
// the reduction, read by ldmatrix (rows padded to an odd count of 16-byte
// pieces, so the eight row reads of an ldmatrix hit distinct banks; these
// helpers are rt::wide in common.cuh, shared with the backward). So no
// block re-reads a whole chunk's q and k (the first design, at f5f169e:
// 1,040 blocks of 16 columns each read every chunk's q, k and P), the
// states' round trip through HBM is the price of the parallelism, and every
// sum has one order.
// No atomics: two calls give the same bits. At the serve shape on an H100
// SXM (700 W) a call takes ~1.17 ms, launch 0 ~0.20 of it and launch 1
// ~0.58; the products take less than a third (tools/k4_wide_designs.py
// times copies of this source without them, without the copies, without
// the states' writes). The same split with wgmma (warpgroup products from
// shared memory, tools/k4_wide/wgmma.cu) was slower, ~1.49 ms.
//
// No bf16 path here: mLSTM hands over f32 q, k (upcast from the model
// dtype) and v; the wrapper raises for other dtypes at these shapes.
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// the tile, the slab, the planes and their helpers (rt::wide, common.cuh)
using namespace rt::wide;

constexpr int kMaxQ = 256;            // chunk positions
constexpr int kMaxDk = 1024;          // state rows
constexpr int kNI = 3;                // parts of f32 q, k, v
constexpr int kNP = 2;                // parts of P, the states, w v
constexpr int kCountTab = 4096;       // slabs' part counts a block keeps

constexpr int cmax(int x, int y) { return x > y ? x : y; }
// Stages of slabs in shared memory and bf16 elements a stage: a state
// block's k and w v, a score block's q and k, launch 2's q and h_n's parts
// or P's parts and v
constexpr int kStatStages = 4, kStatStage = (kNI + kNP) * kColPlane;
constexpr int kScoreStages = 3, kScoreStage = 2 * kNI * kRowPlane;
constexpr int kYStages = 4, kYStage = cmax(kNI * kRowPlane + kNP * kColPlane,
                                           kNP * kRowPlane + kNI * kColPlane);
constexpr int kSmem1 = 2 * cmax(kStatStages * kStatStage,
                                kScoreStages * kScoreStage);
constexpr int kSmem2 = 2 * kYStages * kYStage;

// The scratch buffer of a call, in bytes from its start (each region
// 16-byte aligned): the parts of the state before each chunk (B, H, nc, 2,
// dk, dvp) and of the gated scores (B, H, nc, 2, Q, Qp), written by launch
// 1; the parts of q and k (B, H, 3, S, dkp), of v (B, H, 3, S, dvp) and of
// w v (B, H, 2, S, dvp), the chunks' cumsums (B, H, S) f32 and the parts in
// use of q, k and v (B, H, nc, J, 3) int, written by launch 0. dkp, dvp
// and Qp round dk, dv and Q up to 8; J = ceil(Q / 32).
struct Layout {
  int64_t hb, p, qp, kp, vp, wvp, cum, flags, total;
  __host__ __device__ Layout(int B, int S, int H, int dk, int dv, int Q) {
    const int64_t bh = (int64_t)B * H, bhn = bh * (S / Q);
    const int64_t dkp = round_up(dk, 8), dvp = round_up(dv, 8);
    hb = 0;
    p = hb + 2 * bhn * kNP * dk * dvp;
    qp = p + 2 * bhn * kNP * Q * round_up(Q, 8);
    kp = qp + 2 * bh * kNI * S * dkp;
    vp = kp + 2 * bh * kNI * S * dkp;
    wvp = vp + 2 * bh * kNI * S * dvp;
    cum = wvp + 2 * bh * kNP * S * dvp;
    flags = cum + round_up(4 * bh * S, (int64_t)16);
    total = flags + round_up(12 * bhn * ((Q + kK - 1) / kK), (int64_t)16);
  }
};

// The pieces of a call that every block reads.
struct Call {
  const float* q;
  const float* k;
  const float* v;
  const float* gi;
  const float* h0;          // null: a zero initial state
  int S, H, dk, dv, Q;
  bf16 *hb, *P, *qp, *kp, *vp, *wvp;
  float* cum;               // the chunks' cumsums of the log-decays
  int* flags;               // parts in use of q, k, v in a slab
  __host__ __device__ int nc() const { return S / Q; }
  __host__ __device__ int J() const { return (Q + kK - 1) / kK; }
  __host__ __device__ int dkp() const { return round_up(dk, 8); }
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
  // plane 0 of (b, h)'s q, k (S rows of dkp), v and w v (S rows of dvp)
  __device__ bf16* q_plane(int64_t bh) const {
    return qp + bh * kNI * (int64_t)S * dkp();
  }
  __device__ bf16* k_plane(int64_t bh) const {
    return kp + bh * kNI * (int64_t)S * dkp();
  }
  __device__ bf16* v_plane(int64_t bh) const {
    return vp + bh * kNI * (int64_t)S * dvp();
  }
  __device__ bf16* wv_plane(int64_t bh) const {
    return wvp + bh * kNP * (int64_t)S * dvp();
  }
  // the parts in use of q (x 0), k (1) or v (2) over the slabs of a (b, h,
  // chunk)
  __device__ PartFlags pf() const { return PartFlags{flags, J(), 3}; }
};

// Launch 0: rows 32 j .. of (b, h, chunk) of one operand (blockIdx.y 0: q,
// 1: k, 2: v with w v): its parts and their count, and (q, j = 0) the
// chunk's cumsum. Block x = (b H + h) nc + n) J + j.
__global__ void __launch_bounds__(kThreads, 2) ssd_wide_split(
    const Call c, const float* __restrict__ a, int64_t qsb, int64_t qss,
    int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb,
    int64_t vss, int64_t vsh, int vec_qk, int vec_v) {
  __shared__ float cum[kMaxQ];
  __shared__ float w[kK];
  const int J = c.J(), nc = c.nc(), Q = c.Q, x = blockIdx.y;
  const int j = blockIdx.x % J;
  const int64_t bhn = blockIdx.x / J;
  const int n = (int)(bhn % nc);
  const int64_t bh = bhn / nc;
  const int h = (int)(bh % c.H);
  const int64_t b = bh / c.H;
  const int64_t row0 = (int64_t)n * Q + kK * j;      // in the sequence
  const int64_t g0 = (b * c.S + (int64_t)n * Q) * c.H + h;
  const int rows = min(kK, Q - kK * j);
  const int dkp = c.dkp(), dvp = c.dvp();
  int used;
  if (x < 2) {
    const float* src = x ? c.k + b * ksb + h * ksh + row0 * kss
                         : c.q + b * qsb + h * qsh + row0 * qss;
    used = split_rows<kNI, kNP>(
        src, x ? kss : qss, c.dk, dkp, vec_qk, rows,
        (x ? c.k_plane(bh) : c.q_plane(bh)) + row0 * dkp, (int64_t)c.S * dkp,
        nullptr, nullptr, 0);
    if (x == 0 && j == 0 && threadIdx.x < 32) {
      rt::chunk_cumsum(a + g0, c.H, Q, cum);
      __syncwarp();
      for (int s = threadIdx.x; s < Q; s += 32)
        c.cum[bh * c.S + (int64_t)n * Q + s] = cum[s];
    }
  } else {
    if (threadIdx.x < 32) {
      rt::chunk_cumsum(a + g0, c.H, Q, cum);
      __syncwarp();
      const int s = kK * j + threadIdx.x;
      w[threadIdx.x] = s < Q ? expf(cum[Q - 1] - cum[s]) *
                                   c.gi[g0 + (int64_t)s * c.H]
                             : 0.f;
    }
    __syncthreads();
    const int64_t pv = (int64_t)c.S * dvp;
    used = split_rows<kNI, kNP>(c.v + b * vsb + h * vsh + row0 * vss, vss,
                                c.dv, dvp, vec_v, rows,
                                c.v_plane(bh) + row0 * dvp, pv, w,
                                c.wv_plane(bh) + row0 * dvp, pv);
  }
  if (threadIdx.x == 0) c.flags[(bhn * J + j) * 3 + x] = used;
}

// Launch 1, a state block: the tile (rows d0 .., columns e0 ..) of one
// (b, h)'s state, walking the chunks; the f32 final state at the end, and
// with kStates the f32 state before each chunk into states (B, nc, H, dk,
// dv).
template <bool kStates>
__device__ __forceinline__ void state_block(const Call& c, int bid,
                                            bf16* smem,
                                            float* __restrict__ h_out,
                                            float* __restrict__ states) {
  const int dkp = c.dkp(), dvp = c.dvp(), nc = c.nc(), J = c.J(), Q = c.Q,
            dk = c.dk, dv = c.dv;
  const int nrt = rt::cdiv(dk, kT), nct = rt::cdiv(dvp, kT);
  const int d0 = kT * (bid / nct % nrt), e0 = kT * (bid % nct);
  const int64_t bh = bid / (nct * nrt);
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
  const bf16* kb = c.k_plane(bh) + d0;
  const bf16* wvb = c.wv_plane(bh) + e0;
  // k's parts written for each slab of the walk, the first kCountTab of
  // them in shared memory
  __shared__ uint8_t kc[kCountTab];
  for (int g = threadIdx.x; g < min(nc * J, kCountTab); g += kThreads)
    kc[g] = (uint8_t)c.pf().count(bh * nc, g, 1);
  const int nk = c.pf().parts(bh * nc, 0, nc * J, 1);
  const int64_t pk = (int64_t)c.S * dkp, pv = (int64_t)c.S * dvp;
  auto stage = [&](int g, int st) {
    const int n = g / J, j = g % J;
    const int64_t row = (int64_t)n * Q + kK * j;
    bf16* s = smem + st * kStatStage;
    stage_parts<true>(s, kb + row * dkp, pk, dkp, Q - kK * j, dkp - d0, nk,
                      g < kCountTab ? kc[g] : c.pf().count(bh * nc, g, 1));
    stage_parts<true>(s + kNI * kColPlane, wvb + row * dvp, pv, dvp,
                      Q - kK * j, dvp - e0, kNP, ~0u);
  };
  auto mma = [&](int g, int st) {
    const int n = g / J, j = g % J;
    if (j == 0) {
      if constexpr (kStates) {         // the f32 state before chunk n
        const int64_t b = bh / c.H, h = bh % c.H;
        float* out = states + ((b * nc + n) * c.H + h) * dk * dv;
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int nn = 0; nn < 4; ++nn)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int d = d0 + acc_row(m, e), col = e0 + acc_col(nn, e);
              if (d < dk && col < dv) out[(int64_t)d * dv + col] =
                                          acc[m][nn][e];
            }
      }
      if (n > 0 || c.h0) {             // launch 2 reads no zero state
        // the state before chunk n in its parts
        store_parts<kNP>(acc, c.hb_plane(bh, n, 0), (int64_t)dk * dvp, d0,
                         e0, dk, dvp);
      }
      const float dec = expf(c.cum[bh * c.S + (int64_t)n * Q + Q - 1]);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][nn][e] *= dec;
    }
    const bf16* s = smem + st * kStatStage;
    mma_slab<true, true, kNI, kNP>(acc, s, s + kNI * kColPlane, nk, kNP);
  };
  pipeline<kStatStages>(nc * J, stage, mma);
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
                                            bf16* smem) {
  const int nc = c.nc(), Q = c.Q, Qp = c.Qp(), dkp = c.dkp();
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
  const int64_t row0 = (int64_t)n * Q;
  const bf16* qb = c.q_plane(bh) + (row0 + t0) * dkp;
  const bf16* kb = c.k_plane(bh) + (row0 + s0) * dkp;
  const int64_t pk = (int64_t)c.S * dkp;
  const int J = c.J();
  const int nq = c.pf().parts(bhn, t0 / kK, min((t0 + kT) / kK, J), 0);
  const int nk = c.pf().parts(bhn, s0 / kK, min((s0 + kT) / kK, J), 1);
  const uint32_t qc = c.pf().count4(bhn, t0 / kK, 0);
  const uint32_t kc = c.pf().count4(bhn, s0 / kK, 1);
  float acc[4][4][4] = {};
  auto stage = [&](int g, int st) {
    bf16* s = smem + st * kScoreStage;
    stage_parts<false>(s, qb + kK * g, pk, dkp, Q - t0, dkp - kK * g, nq, qc);
    stage_parts<false>(s + kNI * kRowPlane, kb + kK * g, pk, dkp, Q - s0,
                       dkp - kK * g, nk, kc);
  };
  auto mma = [&](int, int st) {
    const bf16* s = smem + st * kScoreStage;
    mma_slab<false, false, kNI, kNI>(acc, s, s + kNI * kRowPlane, nq, nk);
  };
  pipeline<kScoreStages>(rt::cdiv(c.dk, kK), stage, mma);
  // gate, select 0 above the diagonal, split
  const float* cum = c.cum + bh * c.S + row0;
  const float* is = c.gi + (b * c.S + row0) * c.H + h;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int t = t0 + acc_row(m, e), s = s0 + acc_col(nn, e);
        if (t >= Q || s >= Qp) continue;
        const float p0 = s <= t ? acc[m][nn][e] * expf(cum[t] - cum[s]) *
                                      is[(int64_t)s * c.H]
                                : 0.f;
        const float p1 = s + 1 <= t ? acc[m][nn][e + 1] *
                                          expf(cum[t] - cum[s + 1]) *
                                          is[(int64_t)(s + 1) * c.H]
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
// kStates: also the f32 states (an instantiation of its own, with the
// states as an argument of its own: with them in Call, one pointer
// larger, ptxas scheduled every launch of a call without states otherwise,
// and slower).
template <bool kStates>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_wide_chunks(const Call c, int nstate, float* __restrict__ h_out,
                    float* __restrict__ states) {
  extern __shared__ __align__(16) bf16 smem[];
  if ((int)blockIdx.x < nstate)
    state_block<kStates>(c, blockIdx.x, smem, h_out, states);
  else
    score_block(c, blockIdx.x - nstate, smem);
}

// Launch 2: the tile (rows t0 .., columns e0 ..) of y for one (b, h, chunk):
// exp(cum_t) q_t . h_n over dk (slabs g < G1), then P v over the positions
// up to the tile's last row.
__global__ void __launch_bounds__(kThreads, 1)
    ssd_wide_y(const Call c, float* __restrict__ y) {
  extern __shared__ __align__(16) bf16 smem[];
  const int nc = c.nc(), Q = c.Q, Qp = c.Qp(), dk = c.dk, dv = c.dv,
            dkp = c.dkp(), dvp = c.dvp();
  const int ntt = rt::cdiv(Q, kT), nct = rt::cdiv(dv, kT);
  const int bid = blockIdx.x;
  const int t0 = kT * (bid / nct % ntt), e0 = kT * (bid % nct);
  const int64_t bhn = bid / (nct * ntt);
  const int n = (int)(bhn % nc);
  const int64_t bh = bhn / nc;
  const int h = (int)(bh % c.H);
  const int64_t b = bh / c.H;
  const int64_t row0 = (int64_t)n * Q;
  const int t_end = min(t0 + kT, Q);
  const int G1 = n > 0 || c.h0 ? rt::cdiv(dk, kK) : 0;
  const bf16* qb = c.q_plane(bh) + (row0 + t0) * dkp;
  const bf16* hb = c.hb + (bhn * kNP * (int64_t)dk * dvp + e0);
  const bf16* pb = c.p_plane(bhn, 0) + (int64_t)t0 * Qp;
  const bf16* vb = c.v_plane(bh) + row0 * dvp + e0;
  const int64_t pk = (int64_t)c.S * dkp, pv = (int64_t)c.S * dvp;
  const int J = c.J();
  const int nq = c.pf().parts(bhn, t0 / kK, min((t0 + kT) / kK, J), 0);
  const int nv = c.pf().parts(bhn, 0, J, 2);
  const uint32_t qc = c.pf().count4(bhn, t0 / kK, 0);
  uint64_t vc = 0;                     // v's, a byte a slab (J <= 8)
  for (int j = 0; j < J; ++j)
    vc |= (uint64_t)c.pf().count(bhn, j, 2) << (8 * j);
  float acc[4][4][4] = {};
  auto stage = [&](int g, int st) {
    bf16* s = smem + st * kYStage;
    if (g < G1) {
      stage_parts<false>(s, qb + kK * g, pk, dkp, Q - t0, dkp - kK * g, nq,
                         qc);
      stage_parts<true>(s + kNI * kRowPlane, hb + (int64_t)kK * g * dvp,
                        (int64_t)dk * dvp, dvp, dk - kK * g, dvp - e0, kNP,
                        ~0u);
    } else {
      const int j = g - G1, s0 = kK * j;
      stage_parts<false>(s, pb + s0, (int64_t)Q * Qp, Qp, Q - t0, Qp - s0,
                         kNP, ~0u);
      stage_parts<true>(s + kNP * kRowPlane, vb + (int64_t)s0 * dvp, pv, dvp,
                        Q - s0, dvp - e0, nv, (uint32_t)(vc >> (8 * j)));
    }
  };
  auto mma = [&](int g, int st) {
    const bf16* s = smem + st * kYStage;
    if (g < G1) {
      mma_slab<false, true, kNI, kNP>(acc, s, s + kNI * kRowPlane, nq, kNP);
      return;
    }
    if (g == G1 && G1 > 0) {
      const float* cum = c.cum + bh * c.S + row0 + t0;
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int t = acc_row(m, e);
          const float f = t0 + t < Q ? expf(cum[t]) : 0.f;
#pragma unroll
          for (int nn = 0; nn < 4; ++nn)
            acc[m][nn][e] *= f, acc[m][nn][e + 1] *= f;
        }
    }
    mma_slab<false, true, kNP, kNI>(acc, s, s + kNP * kRowPlane, kNP, nv);
  };
  pipeline<kYStages>(G1 + rt::cdiv(t_end, kK), stage, mma);
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

// The launches of a call, the first `launches` of them (a probe of the
// design tool times them one by one; a call makes all three). Arguments as
// repro_ssd_scan_wide's below, `states` last.
int launch_wide(const float* q, const float* k, const float* v,
                const float* a, const float* i, const float* h0, int B,
                int S, int H, int dk, int dv, int Q, long long qsb,
                long long qss, long long qsh, long long ksb, long long kss,
                long long ksh, long long vsb, long long vss, long long vsh,
                void* scratch, long long scratch_bytes, float* y,
                float* h_out, cudaStream_t st, int launches,
                float* states = nullptr) {
  if (B < 1 || S < 1 || H < 1 || Q < 1 || Q > kMaxQ || S % Q != 0 ||
      dk < 1 || dk > kMaxDk || dv < 1 || !rt::aligned16(scratch))
    return cudaErrorInvalidValue;
  const Layout lay(B, S, H, dk, dv, Q);
  if (scratch_bytes < lay.total) return cudaErrorInvalidValue;
  char* base = static_cast<char*>(scratch);
  Call c;
  c.q = q, c.k = k, c.v = v, c.gi = i, c.h0 = h0;
  c.S = S, c.H = H, c.dk = dk, c.dv = dv, c.Q = Q;
  c.hb = reinterpret_cast<bf16*>(base + lay.hb);
  c.P = reinterpret_cast<bf16*>(base + lay.p);
  c.qp = reinterpret_cast<bf16*>(base + lay.qp);
  c.kp = reinterpret_cast<bf16*>(base + lay.kp);
  c.vp = reinterpret_cast<bf16*>(base + lay.vp);
  c.wvp = reinterpret_cast<bf16*>(base + lay.wvp);
  c.cum = reinterpret_cast<float*>(base + lay.cum);
  c.flags = reinterpret_cast<int*>(base + lay.flags);
  const int vec_qk = rt::aligned16(q) && rt::aligned16(k) && qsb % 4 == 0 &&
                     qss % 4 == 0 && qsh % 4 == 0 && ksb % 4 == 0 &&
                     kss % 4 == 0 && ksh % 4 == 0;
  const int vec_v = rt::aligned16(v) && vsb % 4 == 0 && vss % 4 == 0 &&
                    vsh % 4 == 0;
  const long long bhn = (long long)B * H * (S / Q);
  const int ntt = rt::cdiv(Q, kT);
  const long long g0 = bhn * c.J();
  const long long nstate = (long long)B * H * rt::cdiv(dk, kT) *
                           rt::cdiv(c.dvp(), kT);
  const long long g1 = nstate + bhn * (ntt * (ntt + 1) / 2);
  const long long g2 = bhn * ntt * rt::cdiv(dv, kT);
  if (g0 > INT_MAX || g1 > INT_MAX || g2 > INT_MAX)
    return cudaErrorInvalidValue;
  // devices where the limit is up, a mask a kernel
  static uint32_t raised1 = 0, raised1s = 0, raised2 = 0;
  cudaError_t err = rt::raise_smem_once(ssd_wide_chunks<false>, kSmem1,
                                        raised1);
  if (err == cudaSuccess)
    err = rt::raise_smem_once(ssd_wide_chunks<true>, kSmem1, raised1s);
  if (err == cudaSuccess)
    err = rt::raise_smem_once(ssd_wide_y, kSmem2, raised2);
  if (err != cudaSuccess || launches < 1) return err;
  ssd_wide_split<<<dim3((unsigned)g0, 3), kThreads, 0, st>>>(
      c, a, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, vec_qk, vec_v);
  err = cudaGetLastError();
  if (err != cudaSuccess || launches < 2) return err;
  if (states)
    ssd_wide_chunks<true><<<(unsigned)g1, kThreads, kSmem1, st>>>(
        c, (int)nstate, h_out, states);
  else
    ssd_wide_chunks<false><<<(unsigned)g1, kThreads, kSmem1, st>>>(
        c, (int)nstate, h_out, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess || launches < 3) return err;
  ssd_wide_y<<<(unsigned)g2, kThreads, kSmem2, st>>>(c, y);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the scratch buffer a call needs (Layout above) into *bytes.
extern "C" int repro_ssd_scan_wide_scratch(int B, int S, int H, int dk,
                                           int dv, int chunk,
                                           long long* bytes) {
  if (B < 1 || S < 1 || H < 1 || chunk < 1 || S % chunk || dk < 1 || dv < 1)
    return cudaErrorInvalidValue;
  *bytes = Layout(B, S, H, dk, dv, chunk).total;
  return cudaSuccess;
}

// q, k: (B, S, H, dk), v: (B, S, H, dv), all f32 with element strides
// (sb, ss, sh, 1) each (a head stride may be 0). a, i: (B, S, H) f32
// contiguous. h0: (B, H, dk, dv) f32 contiguous, or null for a zero
// initial state. scratch: scratch_bytes (at least
// repro_ssd_scan_wide_scratch), 16-byte aligned, for the launches' own
// use. y: (B, S, H, dv) f32 contiguous; h_out: (B, H, dk, dv) f32, the
// final state; states: (B, S / chunk, H, dk, dv) f32, the state before each
// chunk, or null for none. S % chunk == 0, chunk <= 256, dk <= 1024, any
// dv. Three launches on ``stream``. Returns a cudaError_t.
extern "C" int repro_ssd_scan_wide(
    const float* q, const float* k, const float* v, const float* a,
    const float* i, const float* h0, int B, int S, int H, int dk, int dv,
    int chunk, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, void* scratch, long long scratch_bytes, float* y,
    float* h_out, float* states, void* stream) {
  return launch_wide(q, k, v, a, i, h0, B, S, H, dk, dv, chunk, qsb, qss,
                     qsh, ksb, kss, ksh, vsb, vss, vsh, scratch,
                     scratch_bytes, y, h_out,
                     static_cast<cudaStream_t>(stream), 3, states);
}
