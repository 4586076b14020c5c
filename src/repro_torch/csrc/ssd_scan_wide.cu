// K4 at wide heads: the SSD / decay-attention chunk scan of mLSTM's prefill.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py:_kernel (wrapped
// by ssd_scan) where the reference calls its chunked_decay_attention at
// mLSTM's heads (src/repro/models/ssm.py:apply_mlstm): dk = dh, dv = dh + 1
// (v with the normalizer's ones column appended) and chunks of up to 256
// positions; xlstm-1.3b has dh = 1024 and chunk 256. The function is the
// narrow kernel's (ssd_scan.cu):
//   y_t  = sum_{s<=t} (q_t . k_s) exp(cum_t - cum_s) i_s v_s      (intra)
//        + exp(cum_t) q_t . h                                     (inter)
//   h'   = exp(cum_{Q-1}) h + sum_s exp(cum_{Q-1} - cum_s) i_s k_s (x) v_s
// in f32 throughout: q, k, v, y, the gates and the states are f32, and every
// product is an f32 FMA on the ordinary cores.
//
// Bound on the H100. At xlstm-1.3b's prefill (B 4, S 1024, H 4, dk 1024,
// dv 1025, Q 256) the function needs 77.4 GFLOP against 336 MB of HBM bytes
// (q and k per head): 230 flops per byte. On the bf16 tensor cores that is
// 0.078 ms against 0.100 ms of bytes; on the ordinary f32 cores, where this
// design does them, 1.16 ms. So the design is bound by operations.
//
// Why two launches. One (b, h) state is dk x dv f32 = 4.2 MB, far beyond a
// block's 227 KB of shared memory, and B * H = 16 blocks would fill 16 of
// the 132 SMs. So the state is tiled by dv columns: a block of launch 2 owns
// h[:, j : j + 16] for all dk rows (64 KB) and walks the chunks in order, and
// the grid is B * H * ceil(dv / 16) blocks (1,040 at the serve shape). Each
// column of y and of the state then comes from one block: no sum crosses
// blocks, there are no atomics, and two launches give the same bits. The
// gated scores P_ts = (q_t . k_s) exp(cum_t - cum_s) i_s are the same for
// every column tile of a (b, h, chunk), and recomputing them in every block
// would make the call 4-7 times its useful flops. They do not depend on the
// state, so launch 1 computes them once for every (b, h, chunk), a 64 x 64
// tile a block (only the tiles on and below the diagonal), and writes them
// to a (B, H, nc, Q, Q) f32 buffer (16.8 MB at the serve shape) that
// launch 2 reads; the tiles above the diagonal are neither written nor read.
// A call is those two launches, in order on the caller's stream.
//
// Launch 2, per chunk: the chunk's gates; the column tile of v (rows of dv =
// 1025 f32 are 4,100 bytes, no multiple of 16, so every row is read with
// scalar loads, and the ones column is an ordinary column of v); then
// y = exp(cum_t) (q . h) + P v over 32-wide slabs of q and P, then
// h = exp(tot) h + k^T (w v) over 32-row slabs of k, 256 state rows at a
// time. The slabs run through two stages of shared memory: while the block
// multiplies one, the next (across chunk boundaries too) is in flight as
// 16-byte cp.async copies, since the first design, which loaded each slab
// with scalar loads behind a barrier, spent most of its time waiting on
// them (12.6 ms a call at the serve shape on an H100 SXM at 700 W, against
// 5.2 ms for this one, which does the same FMAs in the same order). Each
// thread keeps a 4 x 4 tile of outputs in registers and reads its operands
// as 16-byte vectors from rows padded to 36 floats, so a quarter warp's
// reads hit distinct banks. The chunk's cumsum of the gates is one warp's
// fixed-order scan (chunk_cumsum), the same code in both launches, so P
// and launch 2's exp(cum_t) and w_s agree to the bit. Every sum has one
// order: the state's rows advance in d order, the scores in d order, P v
// in s order.
//
// No bf16 path and no backward here: mLSTM hands over f32 q, k (upcast from
// the model dtype, which is exact) and v; the wrapper raises for other
// dtypes at these shapes, and for a call whose gradient is wanted.
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 256;            // chunk positions
constexpr int kMaxDk = 1024;          // state rows
constexpr int kTV = 16;               // state columns a block of launch 2 owns
constexpr int kSlab = 32;             // reduction slab
constexpr int kRow = kSlab + 4;       // row stride of a (rows x 32) slab
constexpr int kDBlk = 256;            // state rows a pass of the update takes
constexpr int kKRow = kDBlk + 4;      // row stride of a (32 x 256) k slab
constexpr int kSlabFloats = kMaxQ * kRow;   // one stage of launch 2
constexpr int kTile = 64;             // score tile of launch 1

static_assert(kSlab * kKRow <= kSlabFloats, "the k slab fits a stage");

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared memory of a block of launch 2, in floats: the state's column tile
// (dk rounded up to the slab), two stages of slabs, v's column tile and w v
// (kMaxQ rows each), and cum, exp(cum), w.
__host__ __device__ inline int64_t state_smem_floats(int dk) {
  return (int64_t)round_up(dk, kSlab) * kTV + 2 * kSlabFloats +
         2 * kMaxQ * kTV + 3 * kMaxQ;
}

// The chunk's inclusive cumsum of the log-decays a[s * stride], s < Q, into
// cum[0 .. Q): warp 0 alone, lane l summing its strip of ceil(Q / 32)
// positions in order after the shuffle scan of the strip totals. The same
// code in both launches, so the same bits. The caller synchronizes.
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[r][c] += sum_{e < 4} x[r].e * y[e].c, e in order
__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 (&x)[4],
                                       const float4 (&y)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float xr[4] = {x[r].x, x[r].y, x[r].z, x[r].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[r][0] = fmaf(xr[e], y[e].x, acc[r][0]);
      acc[r][1] = fmaf(xr[e], y[e].y, acc[r][1]);
      acc[r][2] = fmaf(xr[e], y[e].z, acc[r][2]);
      acc[r][3] = fmaf(xr[e], y[e].w, acc[r][3]);
    }
  }
}

// Launch 1: the gated scores of one 64 x 64 tile (rows t, columns s <= t)
// of one (b, h, chunk): P[t][s] = (q_t . k_s) exp(cum_t - cum_s) i_s, and 0
// for s > t. Block x = (b * H + h) * nc + n) * tiles + tile, tile =
// tt (tt + 1) / 2 + ts with ts <= tt.
__global__ void __launch_bounds__(kThreads) ssd_wide_scores(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ a, const float* __restrict__ gi, int S, int H,
    int dk, int Q, int tiles, int64_t qsb, int64_t qss, int64_t qsh,
    int64_t ksb, int64_t kss, int64_t ksh, float* __restrict__ P) {
  __shared__ __align__(16) float qs[kTile * kRow];
  __shared__ __align__(16) float ks[kTile * kRow];
  __shared__ float cum[kMaxQ];
  __shared__ float is[kTile];
  const int nc = S / Q;
  const int64_t bhn = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int n = (int)(bhn % nc);
  const int64_t bh = bhn / nc;
  const int h = (int)(bh % H);
  const int64_t b = bh / H;
  int tt = 0;
  while ((tt + 1) * (tt + 2) / 2 <= tile) ++tt;
  const int ts = tile - tt * (tt + 1) / 2;
  const int t0 = tt * kTile, s0 = ts * kTile;
  const int64_t row0 = (int64_t)n * Q;
  const float* qb = q + b * qsb + h * qsh + row0 * qss;
  const float* kb = k + b * ksb + h * ksh + row0 * kss;
  const int64_t g0 = (b * S + row0) * H + h;        // gate of position 0
  chunk_cumsum(a + g0, H, Q, cum);
  const int tid = threadIdx.x;
  if (tid < kTile) is[tid] = s0 + tid < Q ? gi[g0 + (int64_t)(s0 + tid) * H]
                                          : 0.f;
  const int tr = tid / 16, sc = tid % 16;
  float acc[4][4] = {};
  for (int d0 = 0; d0 < dk; d0 += kSlab) {
    __syncthreads();
    for (int e = tid; e < kTile * kSlab; e += kThreads) {
      const int r = e / kSlab, c = e % kSlab, d = d0 + c;
      qs[r * kRow + c] = t0 + r < Q && d < dk ? qb[(t0 + r) * qss + d] : 0.f;
      ks[r * kRow + c] = s0 + r < Q && d < dk ? kb[(s0 + r) * kss + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kSlab; c += 4) {
      float4 x[4], y[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) x[r] = ld4(&qs[(tr + 16 * r) * kRow + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = ld4(&ks[(sc + 16 * j) * kRow + c]);
      // acc[r][j] += x[r] . y[j], the four terms in order
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = acc[r][j];
          s = fmaf(x[r].x, y[j].x, s);
          s = fmaf(x[r].y, y[j].y, s);
          s = fmaf(x[r].z, y[j].z, s);
          acc[r][j] = fmaf(x[r].w, y[j].w, s);
        }
    }
  }
  float* out = P + bhn * Q * Q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = t0 + tr + 16 * r;
    if (t >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + sc + 16 * j;
      if (s >= Q) continue;
      // above the diagonal cum_t - cum_s > 0 and the exp may overflow:
      // select 0 there, never multiply by a mask
      out[(int64_t)t * Q + s] =
          s <= t ? acc[r][j] * expf(cum[t] - cum[s]) * is[s - s0] : 0.f;
    }
  }
}

// Four floats from src to dst (16-byte aligned): the first n (clamped to
// 0 .. 4) read, the rest zero. With vec, asynchronously (cp.async, in the
// thread's next commit group; safe is any valid address, read for none);
// else at once.
__device__ __forceinline__ void load4(float* dst, const float* src, int n,
                                      bool vec, const float* safe) {
  n = max(0, min(n, 4));
  if (vec) {
    rt::cp_async16_zfill(dst, n ? src : safe, 4 * n);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) dst[c] = c < n ? src[c] : 0.f;
  }
}

// Launch 2's operands for one chunk.
struct Chunk {
  const float* q;      // q of position 0 of the chunk, this (b, h)
  const float* k;
  const float* p;      // the chunk's gated scores, (Q, Q)
};

// Job j of a chunk into one stage: j < nd: q[t][32 j ..] for all t (the
// y = q h products, d in order); then ns jobs P[t][32 s ..] (P v, s in
// order; only groups of 4 with s <= t are read: above the diagonal P is
// zero inside launch 1's tiles and unwritten beyond them); then for each
// 256-row pass of the state, ns jobs k[32 s + ..][pass rows] (the update).
__device__ __forceinline__ void stage_job(float* buf, int j, const Chunk& c,
                                          int64_t qss, int64_t kss, int dk,
                                          int Q, int nd, int ns, bool vec,
                                          const float* safe) {
  const int tid = threadIdx.x;
  constexpr int G = kSlab / 4;          // groups of 4 in a slab row
  if (j < nd) {
    const int d0 = j * kSlab;
    for (int e = tid; e < kMaxQ * G; e += kThreads) {
      const int t = e / G, d = 4 * (e % G);
      load4(&buf[t * kRow + d], c.q + t * qss + d0 + d,
            t < Q ? dk - d0 - d : 0, vec, safe);
    }
  } else if (j < nd + ns) {
    const int s0 = (j - nd) * kSlab;
    for (int e = tid; e < kMaxQ * G; e += kThreads) {
      const int t = e / G, s = 4 * (e % G);
      load4(&buf[t * kRow + s], c.p + (int64_t)t * Q + s0 + s,
            t < Q && s0 + s <= t ? Q - s0 - s : 0, vec, safe);
    }
  } else {
    const int jj = j - nd - ns;
    const int db = (jj / ns) * kDBlk, s0 = (jj % ns) * kSlab;
    constexpr int GK = kDBlk / 4;
    for (int e = tid; e < kSlab * GK; e += kThreads) {
      const int s = e / GK, d = 4 * (e % GK);
      load4(&buf[s * kKRow + d], c.k + (s0 + s) * kss + db + d,
            s0 + s < Q ? dk - db - d : 0, vec, safe);
    }
  }
}

// Launch 2: the column tile c0 = tile * 16 of one (b, h)'s state, walking
// the chunks. Block x = (b * H + h) * ntv + tile. The operand slabs of a
// chunk are a sequence of jobs (stage_job) run through two stages: while
// the block multiplies one, the next is in flight (cp.async where the
// operands allow 16-byte copies, vec), across chunk boundaries too.
__global__ void __launch_bounds__(kThreads, 1) ssd_wide_state(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ a,
    const float* __restrict__ gi, const float* __restrict__ h0,
    const float* __restrict__ P, int S, int H, int dk, int dv, int Q,
    int ntv, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
    int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
    int vec, float* __restrict__ y, float* __restrict__ h_out) {
  extern __shared__ __align__(16) float sm[];
  const int dkp = round_up(dk, kSlab);
  float* hs = sm;                            // [dkp][16]
  float* slab = hs + dkp * kTV;              // 2 x [256][36] or [32][260]
  float* vs = slab + 2 * kSlabFloats;        // [256][16]
  float* wv = vs + kMaxQ * kTV;              // [256][16]
  float* cum = wv + kMaxQ * kTV;             // [256]
  float* ecum = cum + kMaxQ;                 // [256]
  float* w = ecum + kMaxQ;                   // [256]

  const int nc = S / Q;
  const int64_t bh = blockIdx.x / ntv;
  const int c0 = (blockIdx.x % ntv) * kTV;
  const int h = (int)(bh % H);
  const int64_t b = bh / H;
  const int tid = threadIdx.x;
  const int cg = tid % 4;                    // columns 4 cg .. 4 cg + 3
  const int tg = tid / 4;                    // rows tg + 64 r of y; state
                                             // rows 4 tg .. 4 tg + 3 of a pass
  const int nd = (dk + kSlab - 1) / kSlab, ns = (Q + kSlab - 1) / kSlab;
  const int J = nd + ns + (dk + kDBlk - 1) / kDBlk * ns;
  auto chunk = [&](int n) {
    const int64_t row0 = (int64_t)n * Q;
    return Chunk{q + b * qsb + h * qsh + row0 * qss,
                 k + b * ksb + h * ksh + row0 * kss,
                 P + (bh * nc + n) * Q * Q};
  };
  for (int e = tid; e < dkp * kTV; e += kThreads) {
    const int d = e / kTV, col = c0 + e % kTV;
    hs[e] = h0 && d < dk && col < dv ? h0[(bh * dk + d) * dv + col] : 0.f;
  }
  Chunk cur = chunk(0);
  stage_job(slab, 0, cur, qss, kss, dk, Q, nd, ns, vec, q);
  rt::cp_async_commit();
  for (int n = 0; n < nc; ++n) {
    const int64_t row0 = (int64_t)n * Q;
    const int64_t g0 = (b * S + row0) * H + h;
    const float* vb = v + b * vsb + h * vsh + row0 * vss;
    cur = chunk(n);
    __syncthreads();               // the last chunk is done with the gates
    chunk_cumsum(a + g0, H, Q, cum);
    for (int e = tid; e < kMaxQ * kTV; e += kThreads) {
      const int s = e / kTV, col = c0 + e % kTV;
      vs[e] = s < Q && col < dv ? vb[s * vss + col] : 0.f;
    }
    __syncthreads();
    const float tot = cum[Q - 1];
    for (int s = tid; s < kMaxQ; s += kThreads) {
      ecum[s] = s < Q ? expf(cum[s]) : 0.f;
      w[s] = s < Q ? expf(tot - cum[s]) * gi[g0 + (int64_t)s * H] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < kMaxQ * kTV; e += kThreads)
      wv[e] = w[e / kTV] * vs[e];
    const float etot = expf(tot);

    // y = exp(cum_t) (q_t . h) + sum_s P_ts v_s, then
    // h = exp(tot) h + sum_s k_s (x) (w_s v_s), 256 state rows a pass
    float acc[4][4] = {}, up[4][4];
    for (int j = 0; j < J; ++j) {
      const int g = n * J + j;
      if (j + 1 < J)
        stage_job(slab + ((g + 1) & 1) * kSlabFloats, j + 1, cur, qss, kss,
                  dk, Q, nd, ns, vec, q);
      else if (n + 1 < nc)
        stage_job(slab + ((g + 1) & 1) * kSlabFloats, 0, chunk(n + 1), qss,
                  kss, dk, Q, nd, ns, vec, q);
      rt::cp_async_commit();
      rt::cp_async_wait<1>();      // job j's stage has landed
      __syncthreads();
      const float* sb = slab + (g & 1) * kSlabFloats;
      if (j < nd + ns) {
        const float* rows = j < nd ? hs + j * kSlab * kTV
                                   : vs + (j - nd) * kSlab * kTV;
#pragma unroll 2
        for (int c = 0; c < kSlab; c += 4) {
          float4 x[4], hv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) x[r] = ld4(&sb[(tg + 64 * r) * kRow + c]);
#pragma unroll
          for (int e = 0; e < 4; ++e) hv[e] = ld4(&rows[(c + e) * kTV + 4 * cg]);
          fma4x4(acc, x, hv);
        }
        if (j == nd - 1) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float f = ecum[tg + 64 * r];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) acc[r][jj] *= f;
          }
        }
        if (j == nd + ns - 1) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int t = tg + 64 * r;
            if (t >= Q) continue;
            float* yr = y + ((b * S + row0 + t) * H + h) * dv;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int col = c0 + 4 * cg + jj;
              if (col < dv) yr[col] = acc[r][jj];
            }
          }
        }
      } else {
        const int jj = j - nd - ns, si = jj % ns;
        if (si == 0) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) up[r][cc] = 0.f;
        }
        const float* wr0 = wv + si * kSlab * kTV + 4 * cg;
#pragma unroll 4
        for (int s = 0; s < kSlab; ++s) {
          const float4 kv = ld4(&sb[s * kKRow + 4 * tg]);
          const float4 wr = ld4(&wr0[s * kTV]);
          const float kr[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            up[r][0] = fmaf(kr[r], wr.x, up[r][0]);
            up[r][1] = fmaf(kr[r], wr.y, up[r][1]);
            up[r][2] = fmaf(kr[r], wr.z, up[r][2]);
            up[r][3] = fmaf(kr[r], wr.w, up[r][3]);
          }
        }
        if (si == ns - 1) {
          // these 4 x 4 entries are this thread's alone, and every warp has
          // passed the y products' reads of h (the barriers above)
          const int db = jj / ns * kDBlk;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int d = db + 4 * tg + r;
            if (d >= dk) continue;
            float* hr = &hs[d * kTV + 4 * cg];
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              hr[cc] = fmaf(etot, hr[cc], up[r][cc]);
          }
        }
      }
      __syncthreads();             // every warp is done with job j's stage
    }
  }
  rt::cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < dk * kTV; e += kThreads) {
    const int d = e / kTV, col = c0 + e % kTV;
    if (col < dv) h_out[(bh * dk + d) * dv + col] = hs[e];
  }
}

}  // namespace

// q, k: (B, S, H, dk), v: (B, S, H, dv), all f32 with element strides
// (sb, ss, sh, 1) each (a head stride may be 0). a, i: (B, S, H) f32
// contiguous. h0: (B, H, dk, dv) f32 contiguous, or null for a zero
// initial state. scores: (B, H, S / chunk, chunk, chunk) f32 scratch,
// written by the first launch and read by the second. y: (B, S, H, dv) f32
// contiguous; h_out: (B, H, dk, dv) f32, the final state. S % chunk == 0,
// chunk <= 256, dk <= 1024, any dv. Two launches on ``stream``. Returns a
// cudaError_t.
extern "C" int repro_ssd_scan_wide(
    const float* q, const float* k, const float* v, const float* a,
    const float* i, const float* h0, int B, int S, int H, int dk, int dv,
    int chunk, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, float* scores, float* y, float* h_out, void* stream) {
  const int Q = chunk;
  if (B < 1 || S < 1 || H < 1 || Q < 1 || Q > kMaxQ || S % Q != 0 ||
      dk < 1 || dk > kMaxDk || dv < 1)
    return cudaErrorInvalidValue;
  const int nc = S / Q;
  const int nt = (Q + kTile - 1) / kTile;
  const int tiles = nt * (nt + 1) / 2;
  const int ntv = (dv + kTV - 1) / kTV;
  const int64_t g1 = (int64_t)B * H * nc * tiles;
  const int64_t g2 = (int64_t)B * H * ntv;
  if (g1 > INT_MAX || g2 > INT_MAX) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  static uint32_t raised = 0;    // devices where launch 2's limit is up
  cudaError_t err = rt::raise_smem_once(
      ssd_wide_state, (int)(state_smem_floats(kMaxDk) * sizeof(float)),
      raised);
  if (err != cudaSuccess) return err;
  ssd_wide_scores<<<(unsigned)g1, kThreads, 0, st>>>(
      q, k, a, i, S, H, dk, Q, tiles, qsb, qss, qsh, ksb, kss, ksh, scores);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 16-byte copies of q, k and the scores' rows where every row starts on
  // a 16-byte boundary
  const int vec = rt::aligned16(q) && rt::aligned16(k) &&
                  rt::aligned16(scores) && Q % 4 == 0 && qsb % 4 == 0 &&
                  qss % 4 == 0 && qsh % 4 == 0 && ksb % 4 == 0 &&
                  kss % 4 == 0 && ksh % 4 == 0;
  ssd_wide_state<<<(unsigned)g2, kThreads,
                   state_smem_floats(dk) * sizeof(float), st>>>(
      q, k, v, a, i, h0, scores, S, H, dk, dv, Q, ntv, qsb, qss, qsh, ksb,
      kss, ksh, vsb, vss, vsh, vec, y, h_out);
  return cudaGetLastError();
}
