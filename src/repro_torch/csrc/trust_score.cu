// K1: per-worker trust statistics of the packed (W, D) update matrix.
//
// Replaces the Pallas kernel src/repro/kernels/trust_score.py:_kernel
// (wrapped by trust_score_stats). Computes, against the consensus
// c = mean_w u_w:
//     dot[w] = <u_w, c>     sq_u[w] = |u_w|^2     sq_c = |c|^2
//
// Bound on the H100: bytes. The work is ~5 flops per element against 4
// (f32) or 2 (bf16) bytes read, far below the card's flops-per-byte ridge.
//
// Design: one launch, one read of the matrix from HBM. The TPU kernel holds
// a whole (W, BD) column block in VMEM and recomputes c per block. Here a
// thread block cluster of C blocks holds a strip of columns (SB bytes a
// row) of all W rows: block r of the cluster takes rows [r R, (r + 1) R),
// L = SB / 16 threads a row (16 bytes each) and 256 / L row slots, so a
// thread holds its 16-byte piece of K <= 20 (bf16: 16) rows in registers.
// The bulk copy engine (TMA) brings the block's rows of the next strips, in
// 2-D boxes of rows of SB bytes (so thread t's pieces sit at 16 t + k 4096
// bytes), into a ring of S stages, counted on each stage's mbarrier. Per
// strip:
//   1. every thread moves its pieces from the stage into registers, and
//      one thread asks for the strip S ahead into that stage;
//   2. column pass: each thread sums its pieces' columns over its rows; the
//      slots' sums are added in a fixed tree (shuffles within a warp, then
//      the warps in order) into the block's (Ds,) partial, which the block
//      stores into every block of the cluster (st.async into distributed
//      shared memory, counted on the receiver's mbarrier);
//   3. once the C partials are in, every block adds them in rank order, so
//      every block holds the same c strip, bit for bit; c_d^2 joins column
//      d's running sum;
//   4. row pass: each thread adds <piece, c> and |piece|^2 of its rows,
//      still in registers, into its rows' sums.
// No cluster barrier a strip: a barrier's release waits for the thread's
// memory operations in flight. The receive buffers and their mbarriers are
// double-buffered, and a block sends strip i + 2's partial only after every
// block of the cluster sent strip i + 1's, so no buffer is overwritten
// early. The G clusters (one block an SM) walk the strips g, g + G, ...; at
// the end the L threads of a row add their sums in a fixed tree, as do the
// columns' sums of c_d^2 (within warps, then the warps in order); each
// cluster publishes its rows' dot and sq sums and its |c|^2 sum, and counts
// its arrival on its rank's int counter; the last of the G blocks of a rank
// adds the G sums of its rows in cluster order (rank 0 also those of
// |c|^2). The host's plan (kernels/trust_score.py plan) fixes C, SB, R and
// G from (W, D, dtype) alone, so the summation order, and the chain's
// bytes, do not depend on the card. Where the engine cannot take u (D *
// element size not a multiple of 16, or u not 16-byte aligned) every
// thread loads its pieces itself, one value at a time, a strip at a time,
// and sums them in the same order. No float atomics.
//
// Designs that lost on the H100 (PERF.md §6): the strip reduced in shared
// memory, re-read from L2 after the exchange, or prefetched into
// registers, and the cluster synchronised by a barrier a strip.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;      // threads per block
constexpr int kMaxStrip = 256;     // bytes of a row of a strip
constexpr int kStripCols = kMaxStrip / 2;  // values of a strip row, at most
constexpr int kMaxStages = 8;
// rows of a strip a thread holds (at most rows_a_thread * kThreads / L rows
// a block): 20 f32 pieces or 16 bf16 ones, as many as fit the registers
// (bf16 pieces widen to twice the values)
template <typename T>
__host__ __device__ constexpr int rows_a_thread() {
  return sizeof(T) == 4 ? 20 : 16;
}
// dynamic shared memory for the stages, beside the static ~22 KB below
constexpr int kStageBytes = 200 * 1024;

// The 16 bytes of u at column `col` of row `row`, loaded one value at a
// time (zero past D, and for rows the block does not hold).
template <typename T>
__device__ __forceinline__ uint4 load_piece(const T* __restrict__ u,
                                            int64_t row, int64_t col, int D,
                                            bool live) {
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if (!live) return raw;
  const T* p = u + row * D + col;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i)
    if (col + i < D) e[i] = p[i];
  return raw;
}

template <typename T>
__device__ __forceinline__ void widen(const uint4& raw,
                                      float (&v)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) v[i] = rt::to_f32(e[i]);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          rt::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(rt::smem_u32(bar))
      : "memory");
}

// The address of shared variable `p` in cluster block `rank`.
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(rt::smem_u32(p)), "r"(rank));
  return r;
}

// v into cluster shared address `addr`, counted on the mbarrier at cluster
// shared address `bar` (4 bytes of its transaction count).
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// Wait for the phase of `bar` with this parity, seeing the cluster's
// stores that completed it.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(rt::smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Every block: cluster g = blockIdx.x / kC, rank r; rows [r R, r R + Rv).
// tma: the rows come through `map` in boxes of Rb rows, S stages of
// Ra SB bytes (Ra: R rounded up to whole boxes); else each thread loads its
// own. part: dot
// sums (G, W), sq sums (G, W), |c|^2 sums (G,); count: kC ints, 0 when the
// launch starts and again when it ends.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads, 1)
trust_stats(const __grid_constant__ CUtensorMap map, const T* __restrict__ u,
            int tma, int W, int D, int SB, int R, int Rb, int S,
            int* __restrict__ count, float* __restrict__ part,
            float* __restrict__ dot, float* __restrict__ sq_u,
            float* __restrict__ sq_c) {
  constexpr int N = 16 / sizeof(T);          // values a piece
  constexpr int kRows = rows_a_thread<T>();
  extern __shared__ __align__(128) uint8_t stages[];  // [S][R][SB]
  __shared__ float wsum[kThreads / 32][kStripCols];  // the warps' sums
  __shared__ float recv[2][kC][kStripCols];  // the cluster's partials
  __shared__ float c_s[kStripCols];
  __shared__ __align__(8) uint64_t rbar[2];  // recv complete
  __shared__ __align__(8) uint64_t sbar[kMaxStages];  // stage full
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int G = gridDim.x / kC, g = blockIdx.x / kC;
  const int rank = kC > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int Ds = SB / (int)sizeof(T);        // columns of a strip
  const int strips = rt::cdiv(D, Ds);
  const int ns = g < strips ? rt::cdiv(strips - g, G) : 0;
  const int r0 = rank * R;
  const int Rv = max(0, min(R, W - r0));     // this block's rows
  const int L = SB / 16;                     // threads a row
  const int slots = kThreads / L;
  const int slot = t / L, piece = t % L;
  const int Kv = slot < Rv ? rt::cdiv(Rv - slot, slots) : 0;  // live rows
  const int nbox = rt::cdiv(Rv, Rb);         // boxes with live rows
  const int64_t stage_bytes = (int64_t)rt::cdiv(R, Rb) * Rb * SB;

  if (t == 0) {
    for (int s = 0; s < S; ++s) rt::mbar_init(sbar + s);
    // each receive phase is armed for the cluster's partials before any
    // peer can send them: strips 0 and 1 here, strip i + 2 once strip i
    // is in (a peer sends it only after every block sent strip i + 1)
    rt::mbar_init(rbar);
    rt::mbar_init(rbar + 1);
    rt::mbar_expect(rbar, kC * Ds * 4);
    rt::mbar_expect(rbar + 1, kC * Ds * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // no block stores into a peer's buffers before the peer's mbarriers exist
  if constexpr (kC > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  // thread 0: the block's rows of the i-th strip into stage i % S
  auto fetch = [&](int i) {
    if (i >= ns) return;
    uint64_t* bar = sbar + i % S;
    uint8_t* st = stages + (i % S) * stage_bytes;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    rt::mbar_expect(bar, nbox * Rb * SB);
    for (int b = 0; b < nbox; ++b)
      tma_load_2d(st + (int64_t)b * Rb * SB, &map, (g + i * G) * Ds,
                  r0 + b * Rb, bar);
  };
  if (tma && t == 0)
    for (int i = 0; i < S; ++i) fetch(i);

  float dsum[kRows], ssum[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) dsum[k] = ssum[k] = 0.f;
  float sqc = 0.f;   // thread t < Ds: c_t^2 over the strips
  for (int i = 0; i < ns; ++i) {
    const int b = i & 1;
    // 1. this thread's pieces of strip i into registers
    uint4 cur[kRows];
    if (tma) {
      rt::mbar_wait(sbar + i % S, (i / S) & 1);
      const uint4* st =
          reinterpret_cast<const uint4*>(stages + (i % S) * stage_bytes) + t;
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        cur[k] = k < Kv ? st[k * kThreads] : make_uint4(0u, 0u, 0u, 0u);
    } else {
      const int64_t col = (int64_t)(g + i * G) * Ds + piece * N;
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        cur[k] = load_piece<T>(u, r0 + slot + k * slots, col, D, k < Kv);
    }
    // 2. column pass: this thread's rows in order, then the slots of the
    // warp (lanes L apart) in a fixed tree, then the warps in order
    float acc[N];
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] = 0.f;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      float v[N];
      widen<T>(cur[k], v);
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] += v[e];
    }
    for (int o = 16; o >= L; o >>= 1)
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] += __shfl_xor_sync(~0u, acc[e], o);
    if (lane < L)
#pragma unroll
      for (int e = 0; e < N; ++e) wsum[warp][lane * N + e] = acc[e];
    __syncthreads();                           // the stage is read, too
    if (tma && t == 0) fetch(i + S);
    if (t < Ds) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) s += wsum[w][t];
      if constexpr (kC > 1) {
#pragma unroll
        for (int q = 0; q < kC; ++q)
          st_async(remote(&recv[b][rank][t], q), s, remote(rbar + b, q));
      } else {
        recv[b][0][t] = s;
      }
    }
    // 3. the c strip: the cluster's partials in rank order
    if constexpr (kC > 1) {
      if (t < Ds) mbar_wait_cluster(rbar + b, (i >> 1) & 1);
      if (t == 0) rt::mbar_expect(rbar + b, kC * Ds * 4);  // strip i + 2
    } else {
      __syncthreads();
    }
    if (t < Ds) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kC; ++q) s += recv[b][q][t];
      c_s[t] = s / (float)W;
      sqc += c_s[t] * c_s[t];
    }
    __syncthreads();
    // 4. row pass on the registers
    float c[N];
#pragma unroll
    for (int e = 0; e < N; ++e) c[e] = c_s[piece * N + e];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      float v[N];
      widen<T>(cur[k], v);
      float a[2] = {0.f, 0.f}, q[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < N; ++e) {
        a[e & 1] += v[e] * c[e];
        q[e & 1] += v[e] * v[e];
      }
      dsum[k] += a[0] + a[1];
      ssum[k] += q[0] + q[1];
    }
    // wsum and c_s are written again only behind the next strip's first
    // block barrier, which every thread reaches after these reads
  }
  // no block leaves while a peer may still store into it
  if constexpr (kC > 1) cg::this_cluster().sync();

  // each row's L threads add their sums in a fixed tree, then publish
  const int64_t GW = (int64_t)G * W;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    float a = dsum[k], q = ssum[k];
    for (int o = L / 2; o > 0; o >>= 1) {
      a += __shfl_xor_sync(~0u, a, o);
      q += __shfl_xor_sync(~0u, q, o);
    }
    const int r = slot + k * slots;
    if (piece == 0 && r < Rv) {
      part[(int64_t)g * W + r0 + r] = a;
      part[GW + (int64_t)g * W + r0 + r] = q;
    }
  }
  // |c|^2: the Ds threads' sums in a fixed tree (warps, then in order)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sqc += __shfl_xor_sync(~0u, sqc, o);
  __syncthreads();
  if (lane == 0) wsum[0][warp] = sqc;
  __syncthreads();
  if (rank == 0 && t == 0) {
    float x = 0.f;
    for (int w = 0; w < rt::cdiv(Ds, 32); ++w) x += wsum[0][w];
    part[2 * GW + g] = x;
  }
  if (!rt::last_to_arrive(count + rank, G)) return;
  // the last block of the rank: J threads a row (J lanes of one warp), each
  // adding clusters j, j + J, ... in order, then the J sums in a fixed tree
  int J = 32;
  while (J > 1 && Rv * J > kThreads) J >>= 1;
  const int j = t % J;
  for (int rb = 0; rb < Rv; rb += kThreads / J) {
    const int r = rb + t / J;
    float a = 0.f, q = 0.f;
    if (r < Rv) {
      const float* pd = part + r0 + r;
#pragma unroll 8
      for (int h = j; h < G; h += J) {
        a += __ldcg(pd + (int64_t)h * W);
        q += __ldcg(pd + GW + (int64_t)h * W);
      }
    }
    for (int o = J / 2; o > 0; o >>= 1) {
      a += __shfl_xor_sync(~0u, a, o);
      q += __shfl_xor_sync(~0u, q, o);
    }
    if (j == 0 && r < Rv) {
      dot[r0 + r] = a;
      sq_u[r0 + r] = q;
    }
  }
  if (rank == 0 && warp == 0) {
    float x = 0.f;
    for (int h = lane; h < G; h += 32) x += __ldcg(part + 2 * GW + h);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
    if (lane == 0) *sq_c = x;
  }
}

// A tensor map over u (W, D) whose boxes are Rb rows of SB bytes; false
// where the bulk copy engine cannot take u.
bool encode_rows(CUtensorMap* map, const void* u, int isz, int W, int D,
                 int SB, int Rb) {
  const auto encode = rt::tensor_map_encoder();
  if (!encode || !rt::aligned16(u) || ((int64_t)D * isz) % 16) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)W};
  const cuuint64_t strides[1] = {(cuuint64_t)D * isz};
  const cuuint32_t box[2] = {(cuuint32_t)(SB / isz), (cuuint32_t)Rb};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map,
                isz == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                2, const_cast<void*>(u), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int kC>
cudaError_t launch_c(const void* u, int W, int D, int SB, int R, int G,
                     int* count, float* part, float* dot, float* sq_u,
                     float* sq_c, cudaStream_t stream) {
  auto kernel = trust_stats<T, kC>;
  static uint32_t raised = 0;       // devices where the limit is up
  cudaError_t err = rt::raise_smem_once(kernel, kStageBytes, raised);
  if (err != cudaSuccess) return err;
  // boxes of at most 256 rows and a multiple of 128 bytes (the engine
  // writes to 128-byte aligned shared memory), a stage rounded up to whole
  // boxes (rows past R there belong to the next block or lie past W: not
  // summed)
  const int m = SB < 128 ? 128 / SB : 1;
  const int nb = rt::cdiv(R, 256), Rb = rt::cdiv(rt::cdiv(R, nb), m) * m;
  const int Ra = nb * Rb;
  CUtensorMap map{};
  const int tma = encode_rows(&map, u, sizeof(T), W, D, SB, Rb) ? 1 : 0;
  const int S = tma ? min(kMaxStages, kStageBytes / (Ra * SB)) : 1;
  if (S < 2 && tma) return cudaErrorInvalidValue;
  const int smem = tma ? S * Ra * SB : 0;
  const T* ut = static_cast<const T*>(u);
  if constexpr (kC == 1) {
    kernel<<<G, kThreads, smem, stream>>>(map, ut, tma, W, D, SB, R, Rb, S,
                                          count, part, dot, sq_u, sq_c);
    return cudaGetLastError();
  } else {
    if constexpr (kC > 8) {         // above the portable cluster size
      static uint32_t allowed = 0;  // devices where the attribute is set
      int dev = 0;
      err = cudaGetDevice(&dev);
      if (err != cudaSuccess) return err;
      if (dev < 32 && !(allowed >> dev & 1u)) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
        allowed |= 1u << dev;
      }
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(G * kC);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kC;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, map, ut, tma, W, D, SB, R, Rb, S,
                             count, part, dot, sq_u, sq_c);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch(const void* u, int W, int D, int C, int SB, int R, int G,
                   int* count, float* part, float* dot, float* sq_u,
                   float* sq_c, cudaStream_t stream) {
  if (W < 1 || D < 1 || G < 1 || (int64_t)G * C > 0x7fffffff ||
      (SB != 16 && SB != 32 && SB != 64 && SB != 128 && SB != 256) ||
      R < 1 || (int64_t)R * SB > (int64_t)rows_a_thread<T>() * kThreads * 16 ||
      (int64_t)C * R < W || !count || !part)
    return cudaErrorInvalidValue;
#define REPRO_K1_ARGS u, W, D, SB, R, G, count, part, dot, sq_u, sq_c, stream
  switch (C) {
    case 1: return launch_c<T, 1>(REPRO_K1_ARGS);
    case 2: return launch_c<T, 2>(REPRO_K1_ARGS);
    case 4: return launch_c<T, 4>(REPRO_K1_ARGS);
    case 8: return launch_c<T, 8>(REPRO_K1_ARGS);
    case 16: return launch_c<T, 16>(REPRO_K1_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_K1_ARGS
}

}  // namespace

// u: (W, D) f32 (bf16 == 0) or bf16 (bf16 == 1), contiguous. The plan
// (kernels/trust_score.py plan): clusters of `cluster` blocks (1, 2, 4, 8
// or 16), strips of `strip` bytes a row (16 to 256, a power of two), `rows`
// rows a block (rows * strip at most 80 KB, bf16 64 KB; cluster * rows >=
// W),
// `clusters` clusters. count: `cluster` ints, all 0 (and 0 again when the
// kernel ends); part: 2 * clusters * W + clusters f32 scratch; only one
// launch at a time may use them. dot, sq_u: (W,) f32; sq_c: (1,) f32.
// Returns a cudaError_t.
extern "C" int repro_trust_score(const void* u, int bf16, int W, int D,
                                 int cluster, int strip, int rows,
                                 int clusters, int* count, float* part,
                                 float* dot, float* sq_u, float* sq_c,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(u, W, D, cluster, strip, rows, clusters,
                                 count, part, dot, sq_u, sq_c, st);
  return launch<float>(u, W, D, cluster, strip, rows, clusters, count, part,
                       dot, sq_u, sq_c, st);
}
