// Shared pieces of the port's kernels:
//
//   * f32 widening of bf16 values and 16-byte f32 stores;
//   * the arrival step of a one-launch reduction (K1, K2, K5): the blocks of
//     a group publish partial sums, and the last to arrive combines them;
//   * mbarriers and the tensor-map encoder of the bulk copy engine (K1,
//     K4);
//   * cp.async copies (K4, K5);
//   * the tensor-core pieces of K4 (and its backward) and K5: ldmatrix,
//     mma.sync m16n8k16 on bf16 and the split of f32 values into bf16
//     parts whose products keep f32's accuracy; K4's decay exp;
//   * the chunk's fixed-order cumsum of the gates (K4's wide path and its
//     backward);
//   * the bf16 part planes of K4's wide path and its backward (rt::wide):
//     the split of f32 rows into parts and the count of parts in use, the
//     cp.async ring of slabs, the ldmatrix fragment loads and mma.sync
//     products of a 128 x 128 tile, and the store of a tile as parts.
//
// No float atomics anywhere. The scores these kernels feed are committed
// on-chain as <f8 inside Merkle-hashed records, so every sum has one fixed
// order and two runs on the same inputs are bit-identical.
//
// Everything here is a template or an inline function, so each .cu that
// includes it gets its own copy and the objects link into one library
// without clashes.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int N>
__device__ __forceinline__ void store_f32(float* __restrict__ p,
                                          const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c)
      reinterpret_cast<float4*>(p)[c] =
          make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

inline bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__host__ __device__ __forceinline__ int cdiv(int64_t a, int64_t b) {
  return (int)((a + b - 1) / b);
}

// The arrival step of a reduction inside one launch: `n` blocks share the
// int `counter`, each publishes its partial sums to global memory and then
// calls this (every thread of the block). It returns true, in every thread,
// in the one block that arrives last; that block then sees every block's
// partials (read them through L2: __ldcg or cp.async.cg), and the counter
// is back at 0 for the next launch. The counter must be 0 when the launch
// starts, and only one launch at a time may use it. An integer atomic: the
// partials are combined in an order the caller fixes, whatever the order of
// arrival.
__device__ __forceinline__ bool last_to_arrive(int* counter, int n) {
  __shared__ int last;
  __threadfence();                       // this block's partials are out
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == n - 1;
    if (last) *counter = 0;              // every block has arrived
  }
  __syncthreads();
  if (last) __threadfence();             // every block's partials are in
  return last;
}

// -- mbarriers and the bulk copy engine (K1, K4) -----------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// The one arrival of a phase of `bar`, which then completes once `bytes`
// more have been copied into shared memory.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry
// point query (no link to libcuda); null where it is missing
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                   cudaEnableDefault, &found) == cudaSuccess &&
                   found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// -- K4's wide path and its backward ----------------------------------------

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

// -- cp.async and the tensor-core pieces (K4, K5) ----------------------------

// 16 bytes from global to shared memory, asynchronously (L1 bypassed), both
// 16-byte aligned: only the first `bytes` (0..16) are read and the rest are
// set to zero (gmem must be a valid address). Completes with the thread's
// commit group.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of the calling thread's commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Raise `kernel`'s dynamic shared memory limit to `bytes` on the current
// device, once per device: `raised` is the caller's own bit mask (one per
// kernel), so the attribute call stays off the launch path after the first.
template <typename K>
cudaError_t raise_smem_once(K kernel, int bytes, uint32_t& raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 32 || (raised >> dev & 1u)) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) raised |= 1u << dev;
  return err;
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// (x, y) as NP bf16 pairs whose sum is (x, y) to about 8 * NP bits: part
// i rounds what parts 0 .. i - 1 left.
template <int NP>
__device__ __forceinline__ void split_bf16(float x, float y,
                                           uint32_t (&part)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 f = __bfloat1622float2(h);
    part[i] = *reinterpret_cast<uint32_t*>(&h);
    x -= f.x;
    y -= f.y;
  }
}

// the two bf16 values of a 32-bit register, in f32
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// exp(x) for x <= 0 (K4's decay at or below the diagonal) as one
// ex2.approx.ftz of x log2(e): the product's rounding moves the result by
// |x| 2^-24 of itself, ex2.approx by ~2^-22, and results below 2^-126
// flush to 0
__device__ __forceinline__ float exp_of(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// c += a b for one m16n8k16 tile: a the 16 x 16 bf16 A fragment, (b0, b1)
// the 16 x 8 bf16 B fragment, c the f32 accumulators (PTX ISA layouts).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += (sum_i a[i]) (sum_j b[j]) over the part products i + j < max(NA, NB),
// in one fixed order; b[j] is the pair (b0[j], b1[j]) of a B fragment.
template <int NA, int NB>
__device__ __forceinline__ void mma_parts(float (&c)[4],
                                          const uint32_t (&a)[NA][4],
                                          const uint32_t (&b0)[NB],
                                          const uint32_t (&b1)[NB]) {
  constexpr int kTerms = NA > NB ? NA : NB;
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (i + j < kTerms) mma(c, a[i], b0[j], b1[j]);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// -- K4's wide path and its backward: bf16 part planes on the tensor cores --
//
// Both wide kernels (ssd_scan_wide.cu, ssd_scan_wide_bwd.cu) split their f32
// operands into bf16 part planes once, in a launch of their own, then
// multiply 128 x 128 output tiles (8 warps, each 64 x 32 of the tile) on
// mma.sync from a cp.async ring of slabs of 32 along the reduction, read by
// ldmatrix: rows padded to an odd count of 16-byte pieces, so the eight row
// reads of an ldmatrix hit distinct banks.
namespace wide {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kT = 128;               // a block's output tile is kT x kT
constexpr int kK = 32;                // the reduction's slab
constexpr int kRS = kK + 8;           // row stride (bf16) of a [128][32] plane
constexpr int kCS = kT + 8;           // row stride of a [32][128] plane
constexpr int kRowPlane = kT * kRS;   // bf16 elements of a plane
constexpr int kColPlane = kK * kCS;

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
__host__ __device__ __forceinline__ int64_t round_up(int64_t x, int64_t m) {
  return (x + m - 1) / m * m;
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

// The split launch's work on one operand: rows r < rows (<= kK) of width W
// at src (rows rs floats apart) into up to NI bf16 part planes at dst (rows
// of Wp >= W, zero past W; planes dplane apart), only the parts in use over
// these rows, whose count it returns (all NI where fixed: no count is
// taken). With scale, also the NP parts of scale[r] times the row into sdst
// (planes sdplane apart). Every thread calls it: the count is a block
// reduction. The second pass reads the rows again, from L2.
template <int NI, int NP>
__device__ int split_rows(const float* __restrict__ src, int64_t rs, int W,
                          int Wp, bool vec, int rows, bf16* __restrict__ dst,
                          int64_t dplane, const float* scale,
                          bf16* __restrict__ sdst, int64_t sdplane,
                          bool fixed = false) {
  constexpr int U = 4, kMain = 4 * kThreads;
  int nz = 0, used = fixed ? NI : 1;
  auto note = [&](const float (&x)[4]) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      uint32_t part[NI];
      split_bf16<NI>(x[e], x[e + 1], part);
#pragma unroll
      for (int p = 1; p < NI; ++p) nz |= part[p] ? 1 << p : 0;
    }
  };
  auto put = [&](int r, int c, const float (&x)[4]) {
    uint32_t lo[NI], hi[NI];
    split_bf16<NI>(x[0], x[1], lo);
    split_bf16<NI>(x[2], x[3], hi);
#pragma unroll
    for (int p = 0; p < NI; ++p)
      if (p < used)
        *reinterpret_cast<uint2*>(dst + p * dplane + r * Wp + c) =
            make_uint2(lo[p], hi[p]);
    if (scale) {
      const float f = scale[r];
      uint32_t slo[NP], shi[NP];
      split_bf16<NP>(f * x[0], f * x[1], slo);
      split_bf16<NP>(f * x[2], f * x[3], shi);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        *reinterpret_cast<uint2*>(sdst + p * sdplane + r * Wp + c) =
            make_uint2(slo[p], shi[p]);
    }
  };
  // The first kMain columns: thread t's four at 4 t, rows four at a time;
  // the columns past them (dv = 1025's last) a row and four columns a
  // thread, so that no thread walks the rows alone.
  const int c = 4 * threadIdx.x;
  if (!fixed) {
    if (c < W)
      for (int r0 = 0; r0 < rows; r0 += U) {
        float x[U][4];
#pragma unroll
        for (int u = 0; u < U; ++u)
          load4(src + (r0 + u) * rs + c, r0 + u < rows ? W - c : 0, vec,
                x[u]);
#pragma unroll
        for (int u = 0; u < U; ++u) note(x[u]);
      }
    const int R = max(0, W - kMain + 3) / 4;
    for (int e = threadIdx.x; e < rows * R; e += kThreads) {
      const int r = e / R, cr = kMain + 4 * (e % R);
      float x[4];
      load4(src + r * rs + cr, W - cr, vec, x);
      note(x);
    }
    if (__syncthreads_or(nz)) {
#pragma unroll
      for (int p = 1; p < NI; ++p)
        used += __syncthreads_or(nz >> p & 1) ? 1 : 0;
    }
  }
  if (c < Wp)
    for (int r0 = 0; r0 < rows; r0 += U) {
      float x[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load4(src + (r0 + u) * rs + c, r0 + u < rows ? W - c : 0, vec, x[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r0 + u < rows) put(r0 + u, c, x[u]);
    }
  const int Rp = max(0, Wp - kMain) / 4;
  for (int e = threadIdx.x; e < rows * Rp; e += kThreads) {
    const int r = e / Rp, cr = kMain + 4 * (e % Rp);
    float x[4];
    load4(src + r * rs + cr, W - cr, vec, x);
    put(r, cr, x);
  }
  return used;
}

// The parts in use of each split operand x (< nops) over each slab of 32
// positions j of a (b, h, chunk) bhn, as the split launch writes them:
// p[(bhn J + j) nops + x]. The slabs of chunk n are the J from n J, so j
// may pass a chunk's end into the chunks after it.
struct PartFlags {
  const int* p;
  int J, nops;
  __device__ int count(int64_t bhn, int j, int x) const {
    return __ldg(p + (bhn * J + j) * nops + x);
  }
  // slabs j0 .. j0 + 3 of one chunk, a byte each (0 past its last slab):
  // the four 32-row groups of a 128-row slab
  __device__ uint32_t count4(int64_t bhn, int j0, int x) const {
    uint32_t out = 0;
    for (int u = 0; u < 4; ++u)
      if (j0 + u < J) out |= (uint32_t)count(bhn, j0 + u, x) << (8 * u);
    return out;
  }
  // the most over slabs [j0, j1): every thread calls it, once a block (a
  // block reduction)
  __device__ int parts(int64_t bhn, int j0, int j1, int x) const {
    int n = 1;
    for (int j = j0 + threadIdx.x; j < j1; j += kThreads)
      n = max(n, count(bhn, j, x));
    return 1 + (__syncthreads_or(n > 1) ? 1 : 0) +
           (__syncthreads_or(n > 2) ? 1 : 0);
  }
};

// The first np bf16 part planes of a [32][128] (kWide) or [128][32] slab
// from global memory (plane p at src + p * splane, rows rs elements apart;
// row r read where r < nrows, the 8-wide piece at column c where c < ncols)
// into shared memory by cp.async, zero where not read. The split launch
// writes a plane of an operand only for the 32-position slabs whose values
// need it: byte g of cnt is the count of planes written for rows 32 g .. 32
// g + 31 (byte 0 for a [32][128] slab), and the planes past it are
// zero-filled here, not read. An operand whose planes are all written
// passes ~0u.
template <bool kWide>
__device__ __forceinline__ void stage_parts(bf16* dst,
                                            const bf16* __restrict__ src,
                                            int64_t splane, int64_t rs,
                                            int nrows, int ncols, int np,
                                            uint32_t cnt) {
  constexpr int per_row = (kWide ? kT : kK) / 8;
  constexpr int pieces = (kWide ? kK : kT) * per_row;     // 512 a plane
  constexpr int stride = kWide ? kCS : kRS;
  constexpr int dplane = kWide ? kColPlane : kRowPlane;
  for (int p = 0; p < np; ++p)
#pragma unroll
    for (int it = 0; it < pieces / kThreads; ++it) {
      const int e = threadIdx.x + it * kThreads;
      const int r = e / per_row, c = 8 * (e % per_row);
      const int written = cnt >> (kWide ? 0 : 8 * (r >> 5)) & 255;
      const bool ok = r < nrows && c < ncols && p < written;
      cp_async16_zfill(dst + p * dplane + r * stride + c,
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
          ldmatrix_x4_trans(
              r, B + p * BP + (ks + l7 + 8 * l8) * kCS + n0 + 8 * l16);
        else
          ldmatrix_x4(r, B + p * BP + (n0 + l7 + 8 * l16) * kRS + ks +
                             8 * l8);
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
          ldmatrix_x4_trans(
              af, A + i * AP + (ks + l7 + 8 * l16) * kCS + m0 + 8 * l8);
        else
          ldmatrix_x4(af, A + i * AP + (m0 + (lane & 15)) * kRS + ks +
                              8 * l16);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          if (i + j < kTerms && j < nb)
#pragma unroll
            for (int n = 0; n < 4; ++n)
              mma(acc[m][n], af, b[j][n][0], b[j][n][1]);
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

// G slabs through a ring of NS stages: stage(g, st) issues slab g's
// copies into stage st, mma(g, st) multiplies it once it has landed.
template <int NS, class Stage, class Mma>
__device__ __forceinline__ void pipeline(int G, Stage stage, Mma mma) {
#pragma unroll
  for (int g = 0; g < NS - 1; ++g) {
    if (g < G) stage(g, g);
    cp_async_commit();
  }
  for (int g = 0; g < G; ++g) {
    cp_async_wait<NS - 2>();            // slab g has landed
    __syncthreads();                    // for every thread, and the stage
                                        // refilled below is done with
    const int next = g + NS - 1;
    if (next < G) stage(next, next % NS);
    cp_async_commit();
    mma(g, g % NS);
  }
  cp_async_wait<0>();
}

// A 128 x 128 accumulator tile as NP bf16 part planes (plane p at dst + p
// dplane), its row r and column c at (r0 + r) ld + c0 + c, 16 bytes a
// store: the four threads of a quad trade their column pairs, so that
// thread q holds columns 8 q .. 8 q + 7 of the warp's 32. Rows past nrows
// and columns past ld (a multiple of 8, as c0) are not written.
template <int NP>
__device__ __forceinline__ void store_parts(const float (&acc)[4][4][4],
                                            bf16* __restrict__ dst,
                                            int64_t dplane, int r0, int c0,
                                            int nrows, int ld) {
  const int q = threadIdx.x & 3, lane = threadIdx.x & 31;
  const int col = c0 + 32 * (threadIdx.x >> 5 & 3) + 8 * q;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      uint32_t pr[4][NP];
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
        split_bf16<NP>(acc[m][nn][e], acc[m][nn][e + 1], pr[nn]);
      const int d = r0 + acc_row(m, e);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        uint32_t got[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int give = (q + k) & 3, from = (q - k) & 3;
          const uint32_t v = __shfl_sync(
              0xffffffffu,
              give == 0 ? pr[0][p] : give == 1 ? pr[1][p]
                                   : give == 2 ? pr[2][p] : pr[3][p],
              (lane & ~3) | from);
#pragma unroll
          for (int x = 0; x < 4; ++x) got[x] = x == from ? v : got[x];
        }
        if (d < nrows && col < ld)
          *reinterpret_cast<uint4*>(dst + p * dplane + (int64_t)d * ld +
                                    col) =
              make_uint4(got[0], got[1], got[2], got[3]);
      }
    }
}

}  // namespace wide

}  // namespace rt
