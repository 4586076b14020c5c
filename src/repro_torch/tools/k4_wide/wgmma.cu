// A candidate of tools/k4_wide_designs.py, not built into the kernel
// library: csrc/ssd_scan_wide.cu's design (the same three launches, the
// same split and order of parts) with its products as wgmma, each slab's
// group left in flight across the next barrier. At the serve shape on an
// H100 SXM (700 W) it took ~1.49 ms against the mma.sync design's ~1.17.
// Its staging reads every slab's planes up to the block's largest count of
// parts, so it holds only for inputs whose slabs all take the same count
// (the tool's: all f32 values, or all bf16 values); csrc/ssd_scan_wide.cu
// zero-fills the planes that launch 0 did not write for a slab.
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
// 1025. So every product runs on the tensor cores (wgmma m64n128k16, bf16
// in, f32 accumulators, both operands from shared memory).
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
//   fixed-order scan (chunk_cumsum), so every later use of the gates agrees
//   to the bit. Splitting each operand once here, and not in every block
//   that multiplies it, is what keeps the products' loops lean: a first
//   version that split f32 operands inside the product loops spent more
//   issue slots on the split than on the mma (tools/k4_wide_designs.py).
//   Launch 1, two kinds of block, each 8 warps over a 128 x 128 output tile
//   (a warp 64 x 32). State blocks own a tile of one (b, h)'s dk x dv state
//   and walk the chunks in order: at each chunk they write the state before
//   it, in its two parts, to the scratch buffer (every (b, h, chunk)'s, 270
//   MB at the serve shape), then h = exp(tot) h + k^T (w v) in their
//   accumulators. Score blocks (after the state blocks in the grid) compute
//   one 128 x 128 tile of P on or below the diagonal of a (b, h, chunk),
//   q k^T over dk, gate it and write its two parts (zeros above the
//   diagonal).
//   Launch 2: one block per (b, h, chunk, 128 rows, 128 columns of y):
//   q . h_n over dk (none at the first chunk without an initial state, whose
//   state is zero), scaled by exp(cum_t), then P v over the chunk's
//   positions up to the tile's last row.
// In launches 1 and 2 every operand is bf16 part planes that cp.async brings
// into a ring of up to eight stages of shared memory (as many as fit the
// planes in use), slabs of 32 along the reduction, laid out as wgmma's 8 x
// 8 core matrices without a swizzle. So no
// block re-reads a whole chunk's q and k (the first design, at f5f169e:
// 1,040 blocks of 16 columns each read every chunk's q, k and P), the
// states' round trip through HBM is the price of the parallelism, and every
// sum has one order.
// No atomics: two calls give the same bits.
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
constexpr int cmax(int x, int y) { return x > y ? x : y; }
// A slab's plane in shared memory (stage_parts): byte strides of its 8 x 8
// core matrices along M or N (kSboN) in a [128][32] plane, along K (kLboW)
// in a [32][128] plane, each padded by kPadK, kPadW bytes
constexpr int kPadK = 0, kPadW = 0;
constexpr int kSboN = 4 * 128 + kPadK, kLboW = 16 * 128 + kPadW;
constexpr int kPlane = cmax(16 * kSboN, 4 * kLboW) / 2;   // bf16 elements

// Shared memory of launches 1 and 2: a ring of slabs, each stage holding
// the planes of a slab's operands in use and no more, as many stages as
// fit, up to kMaxStages. At the serve (one part of q, k and v) a stage is
// three planes, 24 KB, and the ring holds 8, six slabs in flight: the
// copies come from L2 and HBM, and a slab's products take less time than
// their latency.
constexpr int kRingPlanes = 24;
constexpr int kMaxStages = 8;
constexpr int kSmem = kRingPlanes * kPlane * 2;
constexpr int kSmem1 = kSmem, kSmem2 = kSmem;   // the names the probe reads

__device__ __forceinline__ int ring_stages(int planes) {
  static_assert(kRingPlanes / 6 >= 3, "three stages of the widest slab");
  return min(kMaxStages, kRingPlanes / planes);
}

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
__host__ __device__ __forceinline__ int64_t round_up(int64_t x, int64_t m) {
  return (x + m - 1) / m * m;
}

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
  // parts in use of q (x 0), k (1) or v (2) over the slabs [j0, j1) of a
  // (b, h, chunk), the slabs of chunk n being the J() from n J(); j1 may
  // pass the chunk's end and reach into the chunks after it. Every thread
  // calls it, once a block: it is a block reduction.
  __device__ int parts(int64_t bhn, int j0, int j1, int x) const {
    int n = 1;
    for (int j = j0 + threadIdx.x; j < j1; j += kThreads)
      n = max(n, __ldg(flags + (bhn * J() + j) * 3 + x));
    return 1 + (__syncthreads_or(n > 1) ? 1 : 0) +
           (__syncthreads_or(n > 2) ? 1 : 0);
  }
};

// The chunk's inclusive cumsum of the log-decays a[s * stride], s < Q, into
// cum[0 .. Q): warp 0 alone, lane l summing its strip of ceil(Q / 32)
// positions in order after the shuffle scan of the strip totals. The
// caller synchronizes.
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

// Four floats of a row at p, the first n (clamped to 0 .. 4) read and the
// rest 0; one 16-byte load where vec.
__device__ __forceinline__ void load4(const float* __restrict__ p, int n,
                                      bool vec, float (&x)[4]) {
  if (vec && n >= 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = e < n ? __ldg(p + e) : 0.f;
}

// Launch 0's work on one operand: rows r < rows (<= kK) of width W at src
// (rows rs floats apart) into bf16 part planes at dst (rows of Wp >= W,
// zero past W; planes dplane apart), only the parts in use over these rows,
// whose count it returns. With scale, also the kNP parts of scale[r] times
// the row into sdst (planes sdplane apart). Every thread calls it: the
// count is a block reduction. Rows go four at a time, their loads in
// flight together; the second pass reads them again, from L2.
__device__ int split_rows(const float* __restrict__ src, int64_t rs, int W,
                          int Wp, bool vec, int rows, bf16* __restrict__ dst,
                          int64_t dplane, const float* scale,
                          bf16* __restrict__ sdst, int64_t sdplane) {
  constexpr int U = 4;
  int nz = 0;
  for (int c = 4 * threadIdx.x; c < W; c += 4 * kThreads)
    for (int r0 = 0; r0 < rows; r0 += U) {
      float x[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load4(src + (r0 + u) * rs + c, r0 + u < rows ? W - c : 0, vec, x[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          uint32_t part[kNI];
          rt::split_bf16<kNI>(x[u][e], x[u][e + 1], part);
          nz |= (part[1] ? 2 : 0) | (part[2] ? 4 : 0);
        }
    }
  int used = 1;
  if (__syncthreads_or(nz)) {
    used += __syncthreads_or(nz & 2) ? 1 : 0;
    used += __syncthreads_or(nz & 4) ? 1 : 0;
  }
  for (int c = 4 * threadIdx.x; c < Wp; c += 4 * kThreads)
    for (int r0 = 0; r0 < rows; r0 += U) {
      float x[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load4(src + (r0 + u) * rs + c, r0 + u < rows ? W - c : 0, vec, x[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u;
        if (r >= rows) break;
        uint32_t lo[kNI], hi[kNI];
        rt::split_bf16<kNI>(x[u][0], x[u][1], lo);
        rt::split_bf16<kNI>(x[u][2], x[u][3], hi);
#pragma unroll
        for (int p = 0; p < kNI; ++p)
          if (p < used)
            *reinterpret_cast<uint2*>(dst + p * dplane + r * Wp + c) =
                make_uint2(lo[p], hi[p]);
        if (scale) {
          const float f = scale[r];
          uint32_t slo[kNP], shi[kNP];
          rt::split_bf16<kNP>(f * x[u][0], f * x[u][1], slo);
          rt::split_bf16<kNP>(f * x[u][2], f * x[u][3], shi);
#pragma unroll
          for (int p = 0; p < kNP; ++p)
            *reinterpret_cast<uint2*>(sdst + p * sdplane + r * Wp + c) =
                make_uint2(slo[p], shi[p]);
        }
      }
    }
  return used;
}

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
    used = split_rows(src, x ? kss : qss, c.dk, dkp, vec_qk, rows,
                      (x ? c.k_plane(bh) : c.q_plane(bh)) + row0 * dkp,
                      (int64_t)c.S * dkp, nullptr, nullptr, 0);
    if (x == 0 && j == 0 && threadIdx.x < 32) {
      chunk_cumsum(a + g0, c.H, Q, cum);
      __syncwarp();
      for (int s = threadIdx.x; s < Q; s += 32)
        c.cum[bh * c.S + (int64_t)n * Q + s] = cum[s];
    }
  } else {
    if (threadIdx.x < 32) {
      chunk_cumsum(a + g0, c.H, Q, cum);
      __syncwarp();
      const int s = kK * j + threadIdx.x;
      w[threadIdx.x] = s < Q ? expf(cum[Q - 1] - cum[s]) *
                                   c.gi[g0 + (int64_t)s * c.H]
                             : 0.f;
    }
    __syncthreads();
    const int64_t pv = (int64_t)c.S * dvp;
    used = split_rows(c.v + b * vsb + h * vsh + row0 * vss, vss, c.dv, dvp,
                      vec_v, rows, c.v_plane(bh) + row0 * dvp, pv, w,
                      c.wv_plane(bh) + row0 * dvp, pv);
  }
  if (threadIdx.x == 0) c.flags[(bhn * J + j) * 3 + x] = used;
}

// The first np bf16 part planes of a slab from global memory (plane p at
// src + p * splane, rows rs elements apart; row r read where r < nrows,
// the 8-wide piece at column c where c < ncols) into shared memory by
// cp.async, zero where not read, in the layouts wgmma reads without a
// swizzle: 8 x 8 core matrices of 128 contiguous bytes, one 16-byte piece a
// row. kWide: a [32][128] slab (rows along the reduction, MN-major): core
// matrix (r / 8, c / 8) at byte (r / 8) kLboW + 128 (c / 8); else a
// [128][32] slab (rows along M or N, K-major): at (r / 8) kSboN + 128 (c /
// 8).
template <bool kWide>
__device__ __forceinline__ void stage_parts(bf16* dst,
                                            const bf16* __restrict__ src,
                                            int64_t splane, int64_t rs,
                                            int nrows, int ncols, int np) {
  constexpr int per_row = (kWide ? kT : kK) / 8;
  constexpr int pieces = (kWide ? kK : kT) * per_row;     // 512 a plane
  for (int p = 0; p < np; ++p)
#pragma unroll
    for (int it = 0; it < pieces / kThreads; ++it) {
      const int e = threadIdx.x + it * kThreads;
      const int r = e / per_row, c = e % per_row;
      const bool ok = r < nrows && 8 * c < ncols;
      rt::cp_async16_zfill(
          dst + p * kPlane +
              ((r >> 3) * (kWide ? kLboW : kSboN) + 128 * c + 16 * (r & 7)) /
                  2,
          ok ? src + p * splane + r * rs + 8 * c : src, ok ? 16 : 0);
    }
}

// A shared-memory matrix descriptor of wgmma, no swizzle: start address,
// the byte strides between core matrices along K (lbo) and along M or N
// (sbo).
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo,
                                              int sbo) {
  return (uint64_t)((rt::smem_u32(p) >> 4) & 0x3FFF) |
         (uint64_t)(lbo >> 4) << 16 | (uint64_t)(sbo >> 4) << 32;
}

// d += A B for a 64 x 128 tile of the warpgroup (wgmma m64n128k16, bf16 in,
// f32 accumulators), A and B by descriptor, A MN-major where TA, B where TB
template <int TA, int TB>
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// acc += A B over one slab on the tensor cores, issued as one wgmma group
// and left in flight (wgmma_wait). A (128 x 32) in NA part
// planes, [32][128] (kAK: M-major) or [128][32]; B (32 x 128) in NB
// planes, [32][128] (kBK: N-major) or [128][32] (stage_parts' layouts);
// only the first na and nb parts are in use, and of those the products
// i + j < max(NA, NB) run, in one fixed order. Warpgroup g (warps 4 g ..
// 4 g + 3) owns rows 64 g .. + 64 of the tile, all 128 columns: acc as
// wgmma lays out a 64 x 128 f32 tile (acc_row, acc_col).
template <bool kAK, bool kBK, int NA, int NB>
__device__ __forceinline__ void mma_slab(float (&acc)[64], const bf16* A,
                                         const bf16* B, int na, int nb) {
  constexpr int kTerms = NA > NB ? NA : NB;
  // byte strides between core matrices along K (lbo) and M or N (sbo),
  // and the step of a k16 instruction: 8 rows of 16 pieces, or 4 pieces
  constexpr int kSboW = 128, kStepW = 2 * kLboW;
  constexpr int kLboN = 128, kStepN = 256;
  const int wg = threadIdx.x >> 7;
  const char* a0 =
      reinterpret_cast<const char*>(A) + wg * (kAK ? 8 * 128 : 8 * kSboN);
  const char* b0 = reinterpret_cast<const char*>(B);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < kK / 16; ++ks)
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      if (i >= na) break;
      const uint64_t da = smem_desc(
          a0 + 2 * i * kPlane + ks * (kAK ? kStepW : kStepN),
          kAK ? kLboW : kLboN, kAK ? kSboW : kSboN);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        if (i + j < kTerms && j < nb)
          wgmma128<kAK, kBK>(
              acc, da,
              smem_desc(b0 + 2 * j * kPlane + ks * (kBK ? kStepW : kStepN),
                        kBK ? kLboW : kLboN, kBK ? kSboW : kSboN));
    }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of the warpgroup's wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Where the thread's accumulator acc[x] sits in the 128 x 128 tile.
__device__ __forceinline__ int acc_row(int x) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return 16 * warp + (lane >> 2) + 8 * ((x >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int x) {
  return 8 * (x >> 2) + 2 * (threadIdx.x & 3) + (x & 1);
}

// Wait until at most n (0 .. kMaxStages - 2) of the thread's cp.async
// groups are pending.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: rt::cp_async_wait<0>(); break;
    case 1: rt::cp_async_wait<1>(); break;
    case 2: rt::cp_async_wait<2>(); break;
    case 3: rt::cp_async_wait<3>(); break;
    case 4: rt::cp_async_wait<4>(); break;
    case 5: rt::cp_async_wait<5>(); break;
    default: rt::cp_async_wait<6>(); break;
  }
  static_assert(kMaxStages - 2 == 6, "the cases above");
}

// G slabs through a ring of NS (3 .. kMaxStages) stages: stage(g, st)
// issues slab g's copies into stage st, mma(g, st) issues its products
// once it has landed. The products of slab g stay in flight while the
// block passes the next barrier and issues the next copies: a stage is
// refilled two slabs after its products were issued, when every
// warpgroup has waited for them. The accumulators are final after it
// returns.
template <class Stage, class Mma>
__device__ __forceinline__ void pipeline(int G, int NS, Stage stage,
                                         Mma mma) {
  for (int g = 0; g < NS - 2; ++g) {
    if (g < G) stage(g, g);
    rt::cp_async_commit();
  }
  for (int g = 0; g < G; ++g) {
    cp_async_wait_upto(NS - 3);         // slab g has landed
    // for wgmma's reads (the async proxy), then for every thread; and
    // every warpgroup is done with slab g - 2's stage
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int next = g + NS - 2;
    if (next < G) stage(next, next % NS);
    rt::cp_async_commit();
    mma(g, g % NS);
    wgmma_wait<1>();                    // slab g - 1's products are done
  }
  wgmma_wait<0>();
  rt::cp_async_wait<0>();
}

// Launch 1, a state block: the tile (rows d0 .., columns e0 ..) of one
// (b, h)'s state, walking the chunks; the f32 final state at the end.
__device__ __forceinline__ void state_block(const Call& c, int bid,
                                            bf16* smem,
                                            float* __restrict__ h_out) {
  const int dkp = c.dkp(), dvp = c.dvp(), nc = c.nc(), J = c.J(), Q = c.Q,
            dk = c.dk, dv = c.dv;
  const int nrt = rt::cdiv(dk, kT), nct = rt::cdiv(dvp, kT);
  const int d0 = kT * (bid / nct % nrt), e0 = kT * (bid % nct);
  const int64_t bh = bid / (nct * nrt);
  float acc[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) {
    const int d = d0 + acc_row(x), col = e0 + acc_col(x);
    acc[x] = c.h0 && d < dk && col < dv ? c.h0[(bh * dk + d) * dv + col]
                                        : 0.f;
  }
  const bf16* kb = c.k_plane(bh) + d0;
  const bf16* wvb = c.wv_plane(bh) + e0;
  const int nk = c.parts(bh * nc, 0, nc * J, 1);
  const int64_t pk = (int64_t)c.S * dkp, pv = (int64_t)c.S * dvp;
  const int sp = (nk + kNP) * kPlane;   // a stage: k's parts, then w v's
  auto stage = [&](int g, int st) {
    const int n = g / J, j = g % J;
    const int64_t row = (int64_t)n * Q + kK * j;
    bf16* s = smem + st * sp;
    stage_parts<true>(s, kb + row * dkp, pk, dkp, Q - kK * j, dkp - d0, nk);
    stage_parts<true>(s + nk * kPlane, wvb + row * dvp, pv, dvp,
                      Q - kK * j, dvp - e0, kNP);
  };
  auto mma = [&](int g, int st) {
    const int n = g / J, j = g % J;
    if (j == 0) {
      wgmma_wait<0>();                 // the state after chunk n - 1
      if (n > 0 || c.h0) {             // launch 2 reads no zero state
#pragma unroll
        for (int x = 0; x < 64; x += 2) {
          const int d = d0 + acc_row(x), col = e0 + acc_col(x);
          if (d >= dk || col >= dvp) continue;
          uint32_t part[kNP];
          rt::split_bf16<kNP>(acc[x], acc[x + 1], part);
#pragma unroll
          for (int p = 0; p < kNP; ++p)
            *reinterpret_cast<uint32_t*>(c.hb_plane(bh, n, p) +
                                         (int64_t)d * dvp + col) = part[p];
        }
      }
      const float dec = expf(c.cum[bh * c.S + (int64_t)n * Q + Q - 1]);
#pragma unroll
      for (int x = 0; x < 64; ++x) acc[x] *= dec;
    }
    const bf16* s = smem + st * sp;
    mma_slab<true, true, kNI, kNP>(acc, s, s + nk * kPlane, nk, kNP);
  };
  pipeline(nc * J, ring_stages(nk + kNP), stage, mma);
#pragma unroll
  for (int x = 0; x < 64; ++x) {
    const int d = d0 + acc_row(x), col = e0 + acc_col(x);
    if (d < dk && col < dv) h_out[(bh * dk + d) * dv + col] = acc[x];
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
  const int nq = c.parts(bhn, t0 / kK, min((t0 + kT) / kK, J), 0);
  const int nk = c.parts(bhn, s0 / kK, min((s0 + kT) / kK, J), 1);
  float acc[64] = {};
  const int sp = (nq + nk) * kPlane;    // a stage: q's parts, then k's
  auto stage = [&](int g, int st) {
    bf16* s = smem + st * sp;
    stage_parts<false>(s, qb + kK * g, pk, dkp, Q - t0, dkp - kK * g, nq);
    stage_parts<false>(s + nq * kPlane, kb + kK * g, pk, dkp, Q - s0,
                       dkp - kK * g, nk);
  };
  auto mma = [&](int, int st) {
    const bf16* s = smem + st * sp;
    mma_slab<false, false, kNI, kNI>(acc, s, s + nq * kPlane, nq, nk);
  };
  pipeline(rt::cdiv(c.dk, kK), ring_stages(nq + nk), stage, mma);
  // gate, select 0 above the diagonal, split
  const float* cum = c.cum + bh * c.S + row0;
  const float* is = c.gi + (b * c.S + row0) * c.H + h;
#pragma unroll
  for (int x = 0; x < 64; x += 2) {
    const int t = t0 + acc_row(x), s = s0 + acc_col(x);
    if (t >= Q || s >= Qp) continue;
    const float p0 =
        s <= t ? acc[x] * expf(cum[t] - cum[s]) * is[(int64_t)s * c.H] : 0.f;
    const float p1 = s + 1 <= t ? acc[x + 1] * expf(cum[t] - cum[s + 1]) *
                                      is[(int64_t)(s + 1) * c.H]
                                : 0.f;
    uint32_t part[kNP];
    rt::split_bf16<kNP>(p0, p1, part);
#pragma unroll
    for (int p = 0; p < kNP; ++p)
      *reinterpret_cast<uint32_t*>(c.p_plane(bhn, p) + (int64_t)t * Qp + s) =
          part[p];
  }
}

// Launch 1: blocks [0, nstate) are state blocks, the rest score blocks.
__global__ void __launch_bounds__(kThreads, 1)
    ssd_wide_chunks(const Call c, int nstate, float* __restrict__ h_out) {
  extern __shared__ __align__(16) bf16 smem[];
  if ((int)blockIdx.x < nstate)
    state_block(c, blockIdx.x, smem, h_out);
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
  const int nq = c.parts(bhn, t0 / kK, min((t0 + kT) / kK, J), 0);
  const int nv = c.parts(bhn, 0, J, 2);
  float acc[64] = {};
  // a stage: q's parts and h_n's, or P's and v's
  const int sp = (max(nq, nv) + kNP) * kPlane;
  auto stage = [&](int g, int st) {
    bf16* s = smem + st * sp;
    if (g < G1) {
      stage_parts<false>(s, qb + kK * g, pk, dkp, Q - t0, dkp - kK * g, nq);
      stage_parts<true>(s + nq * kPlane, hb + (int64_t)kK * g * dvp,
                        (int64_t)dk * dvp, dvp, dk - kK * g, dvp - e0, kNP);
    } else {
      const int j = g - G1, s0 = kK * j;
      stage_parts<false>(s, pb + s0, (int64_t)Q * Qp, Qp, Q - t0, Qp - s0,
                         kNP);
      stage_parts<true>(s + kNP * kPlane, vb + (int64_t)s0 * dvp, pv, dvp,
                        Q - s0, dvp - e0, nv);
    }
  };
  auto mma = [&](int g, int st) {
    const bf16* s = smem + st * sp;
    if (g < G1) {
      mma_slab<false, true, kNI, kNP>(acc, s, s + nq * kPlane, nq, kNP);
      return;
    }
    if (g == G1 && G1 > 0) {
      wgmma_wait<0>();                 // q . h_n is complete
      const float* cum = c.cum + bh * c.S + row0 + t0;
      const float f0 = t0 + acc_row(0) < Q ? expf(cum[acc_row(0)]) : 0.f;
      const float f1 = t0 + acc_row(2) < Q ? expf(cum[acc_row(2)]) : 0.f;
#pragma unroll
      for (int x = 0; x < 64; ++x) acc[x] *= x & 2 ? f1 : f0;
    }
    mma_slab<false, true, kNP, kNI>(acc, s, s + kNP * kPlane, kNP, nv);
  };
  pipeline(G1 + rt::cdiv(t_end, kK), ring_stages(max(nq, nv) + kNP), stage,
           mma);
#pragma unroll
  for (int x = 0; x < 64; ++x) {
    const int t = t0 + acc_row(x), col = e0 + acc_col(x);
    if (t < Q && col < dv)
      y[((b * c.S + row0 + t) * c.H + h) * dv + col] = acc[x];
  }
}

// The launches of a call, the first `launches` of them (a probe of the
// design tool times them one by one; a call makes all three). Arguments as
// repro_ssd_scan_wide's below.
int launch_wide(const float* q, const float* k, const float* v,
                const float* a, const float* i, const float* h0, int B,
                int S, int H, int dk, int dv, int Q, long long qsb,
                long long qss, long long qsh, long long ksb, long long kss,
                long long ksh, long long vsb, long long vss, long long vsh,
                void* scratch, long long scratch_bytes, float* y,
                float* h_out, cudaStream_t st, int launches) {
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
  static uint32_t raised1 = 0, raised2 = 0;   // devices where the limit is up
  cudaError_t err = rt::raise_smem_once(ssd_wide_chunks, kSmem, raised1);
  if (err == cudaSuccess)
    err = rt::raise_smem_once(ssd_wide_y, kSmem2, raised2);
  if (err != cudaSuccess || launches < 1) return err;
  ssd_wide_split<<<dim3((unsigned)g0, 3), kThreads, 0, st>>>(
      c, a, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, vec_qk, vec_v);
  err = cudaGetLastError();
  if (err != cudaSuccess || launches < 2) return err;
  ssd_wide_chunks<<<(unsigned)g1, kThreads, kSmem, st>>>(
      c, (int)nstate, h_out);
  err = cudaGetLastError();
  if (err != cudaSuccess || launches < 3) return err;
  ssd_wide_y<<<(unsigned)g2, kThreads, kSmem, st>>>(c, y);
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
// final state. S % chunk == 0, chunk <= 256, dk <= 1024, any dv. Three
// launches on ``stream``. Returns a cudaError_t.
extern "C" int repro_ssd_scan_wide(
    const float* q, const float* k, const float* v, const float* a,
    const float* i, const float* h0, int B, int S, int H, int dk, int dv,
    int chunk, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, void* scratch, long long scratch_bytes, float* y,
    float* h_out, void* stream) {
  return launch_wide(q, k, v, a, i, h0, B, S, H, dk, dv, chunk, qsb, qss,
                     qsh, ksb, kss, ksh, vsb, vss, vsh, scratch,
                     scratch_bytes, y, h_out,
                     static_cast<cudaStream_t>(stream), 3);
}
