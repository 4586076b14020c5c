// A candidate of tools/k4_wide_designs.py, not built into the kernel
// library: design (b), the sequential walk with wide column tiles, for K4's
// wide path (csrc/ssd_scan_wide.cu holds the function, the accuracy
// argument and the chunk-parallel split, design (a), whose launch 0, score
// blocks, staging and mma.sync products this file reuses).
//
// A cluster of kC = 8 blocks owns a (b, h) and 128 of its dv state columns:
// block r keeps state rows 128 r .. 128 r + 127 of them in its accumulators
// for the whole call (dk <= 1024), so 9 column tiles at the serve shape
// cover a (b, h), not the first design's 65, and the states never leave the
// SM. Per chunk each block
//   - writes its rows of the state before the chunk, in two bf16 parts,
//     into its shared memory;
//   - for each 128-row tile of the chunk's positions, multiplies q's 128
//     columns that meet its rows into them: a partial q . h over its rows;
//     puts the partial in shared memory; after a cluster barrier sums rows
//     16 r .. 16 r + 15 of the 8 partials in rank order through
//     distributed shared memory, scales them by exp(cum_t) and writes y;
//     a second cluster barrier frees the partials;
//   - then h = exp(tot) h + k^T (w v) over its rows and columns, as design
//     (a)'s state blocks do.
// Launches: (a)'s launch 0 (the parts of q, k, v, w v and the cumsums),
// (a)'s launch 1 with score blocks only (the gated scores), the walk, and
// y += P v by (b, h, chunk, 128 x 128) tiles: four a call.
#define repro_ssd_scan_wide repro_ssd_scan_wide_split
#define repro_ssd_scan_wide_scratch repro_ssd_scan_wide_scratch_split
#include "ssd_scan_wide.cu"
#undef repro_ssd_scan_wide
#undef repro_ssd_scan_wide_scratch

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kC = 8;                        // blocks a cluster
constexpr int kHs = 4 * kNP * kColPlane;     // the state's parts, 4 slabs
constexpr int kYRow = kT + 4;                // floats a row of a partial
constexpr int kWalkStages = 3, kWalkStage = (kNI + kNP) * kColPlane;
constexpr int kWalkSmem = 2 * (kHs + kWalkStages * kWalkStage);
static_assert(kNI * kRowPlane <= kWalkStage, "a q slab fits a stage");
static_assert(kT * kYRow * 4 <= 2 * kWalkStages * kWalkStage,
              "a partial fits the ring");
static_assert(kC * kT >= kMaxDk, "the cluster holds every state row");

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __cluster_dims__(kC, 1, 1) __launch_bounds__(kThreads, 1)
    ssd_wide_walk(const Call c, float* __restrict__ y,
                  float* __restrict__ h_out) {
  extern __shared__ __align__(16) bf16 smem[];
  bf16* hs = smem;
  bf16* ring = smem + kHs;
  float* part = reinterpret_cast<float*>(ring);     // between the rings' uses
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int dkp = c.dkp(), dvp = c.dvp(), nc = c.nc(), J = c.J(), Q = c.Q,
            dk = c.dk, dv = c.dv;
  const int nct = rt::cdiv(dvp, kT), ntt = rt::cdiv(Q, kT);
  const int cid = blockIdx.x / kC;
  const int d0 = kT * r, e0 = kT * (cid % nct);
  const int64_t bh = cid / nct;
  const int h = (int)(bh % c.H);
  const int64_t b = bh / c.H;
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
  const int nk = c.pf().parts(bh * nc, 0, nc * J, 1);
  const int nq = c.pf().parts(bh * nc, 0, nc * J, 0);
  const int64_t pk = (int64_t)c.S * dkp, pv = (int64_t)c.S * dvp;
  const int Gq = max(0, min(kT, dk - d0) + kK - 1) / kK;   // q slabs here
  for (int n = 0; n < nc; ++n) {
    const int64_t row0 = (int64_t)n * Q;
    const float* cum = c.cum + bh * c.S + row0;
    if (n > 0 || c.h0) {
      // the state's parts into hs: slab d / 32, row d % 32, as launch 2 of
      // design (a) stages them
      __syncthreads();                 // the last chunk's reads of hs are done
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int d = acc_row(m, e), col = acc_col(nn, e);
            uint32_t pr[kNP];
            rt::split_bf16<kNP>(acc[m][nn][e], acc[m][nn][e + 1], pr);
#pragma unroll
            for (int p = 0; p < kNP; ++p)
              *reinterpret_cast<uint32_t*>(
                  hs + ((d >> 5) * kNP + p) * kColPlane + (d & 31) * kCS +
                  col) = pr[p];
          }
      for (int tt = 0; tt < ntt; ++tt) {
        const int t0 = kT * tt;
        const bf16* qb = c.q_plane(bh) + (row0 + t0) * dkp + d0;
        const uint32_t qc = c.pf().count4(bh * nc + n, t0 / kK, 0);
        float ya[4][4][4] = {};
        auto stage = [&](int g, int st) {
          stage_parts<false>(ring + st * kWalkStage, qb + kK * g, pk, dkp,
                             Q - t0, dkp - d0 - kK * g, nq, qc);
        };
        auto mma = [&](int g, int st) {
          mma_slab<false, true, kNI, kNP>(ya, ring + st * kWalkStage,
                                          hs + g * kNP * kColPlane, nq, kNP);
        };
        pipeline<kWalkStages>(Gq, stage, mma);
        __syncthreads();               // the ring is free for the partial
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int nn = 0; nn < 4; ++nn)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              part[acc_row(m, e) * kYRow + acc_col(nn, e)] = ya[m][nn][e];
        cluster_sync();                // every block's partial is out
        for (int x = threadIdx.x; x < 16 * kT; x += kThreads) {
          const int row = 16 * r + x / kT, col = x % kT, t = t0 + row;
          float sum = 0.f;
#pragma unroll
          for (int rk = 0; rk < kC; ++rk)
            sum += cluster.map_shared_rank(part, rk)[row * kYRow + col];
          if (t < Q && e0 + col < dv)
            y[((b * c.S + row0 + t) * c.H + h) * dv + e0 + col] =
                sum * expf(cum[t]);
        }
        cluster_sync();                // the others have read this partial
      }
    }
    // h = exp(tot) h + k^T (w v) over the chunk, as design (a)'s state
    // blocks
    const float dec = expf(cum[Q - 1]);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][nn][e] *= dec;
    const bf16* kb = c.k_plane(bh) + d0 + row0 * dkp;
    const bf16* wvb = c.wv_plane(bh) + e0 + row0 * dvp;
    auto stage = [&](int j, int st) {
      bf16* s = ring + st * kWalkStage;
      stage_parts<true>(s, kb + (int64_t)kK * j * dkp, pk, dkp, Q - kK * j,
                        dkp - d0, nk, c.pf().count(bh * nc + n, j, 1));
      stage_parts<true>(s + kNI * kColPlane, wvb + (int64_t)kK * j * dvp, pv,
                        dvp, Q - kK * j, dvp - e0, kNP, ~0u);
    };
    auto mma = [&](int, int st) {
      const bf16* s = ring + st * kWalkStage;
      mma_slab<true, true, kNI, kNP>(acc, s, s + kNI * kColPlane, nk, kNP);
    };
    __syncthreads();                   // the ring's last use is done
    pipeline<kWalkStages>(J, stage, mma);
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

// y += P v (y = P v at the first chunk without an initial state): the
// 128 x 128 tile (rows t0 .., columns e0 ..) of one (b, h, chunk).
__global__ void __launch_bounds__(kThreads, 1)
    ssd_wide_pv(const Call c, float* __restrict__ y) {
  extern __shared__ __align__(16) bf16 smem[];
  const int nc = c.nc(), Q = c.Q, Qp = c.Qp(), dv = c.dv, dvp = c.dvp();
  const int ntt = rt::cdiv(Q, kT), nct = rt::cdiv(dv, kT);
  const int bid = blockIdx.x;
  const int t0 = kT * (bid / nct % ntt), e0 = kT * (bid % nct);
  const int64_t bhn = bid / (nct * ntt);
  const int n = (int)(bhn % nc);
  const int64_t bh = bhn / nc;
  const int h = (int)(bh % c.H);
  const int64_t b = bh / c.H;
  const int64_t row0 = (int64_t)n * Q;
  const bf16* pb = c.p_plane(bhn, 0) + (int64_t)t0 * Qp;
  const bf16* vb = c.v_plane(bh) + row0 * dvp + e0;
  const int64_t pv = (int64_t)c.S * dvp;
  const int nv = c.pf().parts(bhn, 0, c.J(), 2);
  float acc[4][4][4] = {};
  auto stage = [&](int g, int st) {
    bf16* s = smem + st * kYStage;
    const int s0 = kK * g;
    stage_parts<false>(s, pb + s0, (int64_t)Q * Qp, Qp, Q - t0, Qp - s0,
                       kNP, ~0u);
    stage_parts<true>(s + kNP * kRowPlane, vb + (int64_t)s0 * dvp, pv, dvp,
                      Q - s0, dvp - e0, nv, c.pf().count(bhn, g, 2));
  };
  auto mma = [&](int, int st) {
    const bf16* s = smem + st * kYStage;
    mma_slab<false, true, kNP, kNI>(acc, s, s + kNP * kRowPlane, kNP, nv);
  };
  pipeline<kYStages>(rt::cdiv(min(t0 + kT, Q), kK), stage, mma);
  const bool add = n > 0 || c.h0;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + acc_row(m, e), col = e0 + acc_col(nn, e);
        if (t < Q && col < dv) {
          float* out = y + ((b * c.S + row0 + t) * c.H + h) * dv + col;
          *out = add ? *out + acc[m][nn][e] : acc[m][nn][e];
        }
      }
}

}  // namespace

extern "C" int repro_ssd_scan_wide_scratch(int B, int S, int H, int dk,
                                           int dv, int chunk,
                                           long long* bytes) {
  return repro_ssd_scan_wide_scratch_split(B, S, H, dk, dv, chunk, bytes);
}

// As repro_ssd_scan_wide of csrc/ssd_scan_wide.cu; four launches.
extern "C" int repro_ssd_scan_wide(
    const float* q, const float* k, const float* v, const float* a,
    const float* i, const float* h0, int B, int S, int H, int dk, int dv,
    int chunk, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, void* scratch, long long scratch_bytes, float* y,
    float* h_out, void* stream) {
  const int Q = chunk;
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
  const auto st = static_cast<cudaStream_t>(stream);
  static uint32_t raised[4] = {};
  cudaError_t err =
      rt::raise_smem_once(ssd_wide_chunks<false>, kSmem1, raised[0]);
  if (err == cudaSuccess)
    err = rt::raise_smem_once(ssd_wide_walk, kWalkSmem, raised[1]);
  if (err == cudaSuccess)
    err = rt::raise_smem_once(ssd_wide_pv, kSmem2, raised[2]);
  if (err != cudaSuccess) return err;
  ssd_wide_split<<<dim3((unsigned)(bhn * c.J()), 3), kThreads, 0, st>>>(
      c, a, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, vec_qk, vec_v);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_wide_chunks<false><<<(unsigned)(bhn * (ntt * (ntt + 1) / 2)),
                           kThreads, kSmem1, st>>>(c, 0, h_out, nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_wide_walk<<<(unsigned)((long long)B * H * rt::cdiv(c.dvp(), kT) * kC),
                  kThreads, kWalkSmem, st>>>(c, y, h_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_wide_pv<<<(unsigned)(bhn * ntt * rt::cdiv(dv, kT)), kThreads, kSmem2,
                st>>>(c, y);
  return cudaGetLastError();
}
