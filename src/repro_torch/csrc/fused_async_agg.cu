// K3: async aggregate and pending-buffer flush in one pass.
//
// Replaces the Pallas kernel src/repro/kernels/fused_round.py:105
// _async_kernel (wrapped by fused_async_agg_kernel):
//     total       = pending + u                   (f32)
//     new_pending = total * keep[:, None]
//     agg         = sum_w weights[w] * total[w]
//
// Bound on the H100: bytes. Per element it reads u (4 or 2 bytes) and
// pending (4 bytes), writes new_pending (4 bytes), and does ~4 flops. At
// the paper CNN's W = 16, D = 21840 that is 4.2 MB, 1.3 us at 3.35 TB/s:
// the launch and one trip to memory are the cost. At W = 4096 or the LLM
// round's flat pack (W = 8, D = 134,515,008 bf16: 10.8 GB) it is the
// stream itself.
//
// Design: one launch, in the host's plan (kernels/fused_round.py plan). A
// thread owns one 16-byte piece of u's rows (4 f32 or 8 bf16 columns; one
// column where D or the alignment does not allow that), a block of
// `threads` threads a column tile: 171 tiles of 32 threads at D = 21840
// f32, more than the 132 SMs. Each thread loads a batch of 16 rows of u
// and pending into registers before its first add (768 bytes in flight a
// thread in bf16), then, row by row in order, writes t * keep[r] to
// new_pending and adds weights[r] * t into its sums. With one row split
// the sums go from registers to agg: no partial sums in HBM and no
// scratch. Where the tiles alone leave the card short of blocks (large
// W), the rows are cut into splits of `rows` rows; each split writes its
// f32 sums to a scratch buffer and counts its arrival on its tile's int
// counter (rt::last_to_arrive), and the split that arrives last adds the
// splits' sums in split order. Fixed summation order, no float atomics:
// two launches give the same bits. Offsets are formed in 64 bits: at the
// flat pack W * D f32 of pending is past 2^31 bytes. Each stream is
// touched once, but the evict-first hint (ld/st .cs) on any of them, L2
// prefetches, and bulk copies of row strips through shared memory were
// slower on the H100 or within 1 % (python -m repro_torch.tools.k3_designs;
// PERF.md §6).
//
// The TPU kernel pads pending to its (256, 512) tile grid; here pending
// stays unpadded (W, D) f32, so no pad or slice copies surround the launch.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;   // widest block the plan picks

// rows of u and pending a thread holds in registers before its first add
constexpr int kBatchRows = 16;

// Block (x, s) owns columns [x * blockDim.x * N, (x + 1) * blockDim.x * N),
// N per thread, and rows [s * rows, min(W, (s + 1) * rows)). N is
// 16 / sizeof(T) (D % N == 0 and aligned rows) or 1; a thread's u piece is
// one RawU, its pending and new_pending pieces NP RawPs.
template <typename T, int N>
__global__ void __launch_bounds__(kMaxThreads)
fused_async_agg_tiles(const T* __restrict__ u,
                      const float* __restrict__ pending,
                      const float* __restrict__ weights,
                      const float* __restrict__ keep, int W, int D, int rows,
                      int* __restrict__ count, float* __restrict__ part,
                      float* __restrict__ agg,
                      float* __restrict__ new_pending) {
  using RawU = typename std::conditional<N == 1, T, uint4>::type;
  using RawP = typename std::conditional<N == 1, float, float4>::type;
  constexpr int NP = N == 1 ? 1 : N / 4;
  const int S = gridDim.y, s = blockIdx.y;
  const int r0 = s * rows, r1 = min(W, r0 + rows);
  const int64_t d0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * N;
  const bool live = d0 < D;
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  if (live) {
    const RawU* uc = reinterpret_cast<const RawU*>(u + d0);
    const RawP* pc = reinterpret_cast<const RawP*>(pending + d0);
    RawP* oc = reinterpret_cast<RawP*>(new_pending + d0);
    // one row, in RawU and in RawP units
    const int64_t ustep = D / (int64_t)(sizeof(RawU) / sizeof(T));
    const int64_t pstep = D / (int64_t)(sizeof(RawP) / sizeof(float));
    for (int r = r0; r < r1; r += kBatchRows) {
      RawU xu[kBatchRows];
      RawP xp[kBatchRows][NP];
      float w[kBatchRows], k[kBatchRows];
#pragma unroll
      for (int i = 0; i < kBatchRows; ++i) {
        if (r + i < r1) {
          const int64_t row = r + i;
          xu[i] = __ldg(uc + row * ustep);
#pragma unroll
          for (int j = 0; j < NP; ++j)
            xp[i][j] = __ldg(pc + row * pstep + j);
          w[i] = __ldg(weights + row);
          k[i] = __ldg(keep + row);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatchRows; ++i) {
        if (r + i < r1) {
          float t[N];
          if constexpr (N == 1) {
            t[0] = rt::to_f32(xu[i]);
          } else {
            const T* e = reinterpret_cast<const T*>(&xu[i]);
#pragma unroll
            for (int n = 0; n < N; ++n) t[n] = rt::to_f32(e[n]);
          }
          const float* p = reinterpret_cast<const float*>(xp[i]);
#pragma unroll
          for (int n = 0; n < N; ++n) t[n] += p[n];
          RawP q[NP];
          float* qf = reinterpret_cast<float*>(q);
#pragma unroll
          for (int n = 0; n < N; ++n) qf[n] = t[n] * k[i];
          const int64_t row = r + i;
#pragma unroll
          for (int j = 0; j < NP; ++j) oc[row * pstep + j] = q[j];
#pragma unroll
          for (int n = 0; n < N; ++n) acc[n] += w[i] * t[n];
        }
      }
    }
  }
  if (S == 1) {
    if (live) rt::store_f32<N>(agg + d0, acc);
    return;
  }
  // publish this split's sums; the last split of the tile adds them all
  if (live) rt::store_f32<N>(part + (int64_t)s * D + d0, acc);
  if (!rt::last_to_arrive(count + blockIdx.x, S) || !live) return;
  float sum[N];
#pragma unroll
  for (int i = 0; i < N; ++i) sum[i] = 0.f;
  for (int ss = 0; ss < S; ++ss) {
    const float* ps = part + (int64_t)ss * D + d0;
#pragma unroll
    for (int i = 0; i < N; ++i) sum[i] += __ldcg(ps + i);
  }
  rt::store_f32<N>(agg + d0, sum);
}

template <typename T, int N>
cudaError_t launch_n(const T* u, const float* pending, const float* weights,
                     const float* keep, int W, int D, int threads,
                     int splits, int* count, float* part, float* agg,
                     float* new_pending, cudaStream_t stream) {
  const int rows = rt::cdiv(W, splits);
  const dim3 grid(rt::cdiv(rt::cdiv(D, N), threads), splits);
  fused_async_agg_tiles<T, N><<<grid, threads, 0, stream>>>(
      u, pending, weights, keep, W, D, rows, count, part, agg, new_pending);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* u, const float* pending, const float* weights,
                   const float* keep, int W, int D, int vec, int threads,
                   int splits, int* count, float* part, float* agg,
                   float* new_pending, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  if (W < 1 || D < 1 || splits < 1 || splits > W ||
      rt::cdiv(W, rt::cdiv(W, splits)) != splits ||    // none empty
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      (vec != 1 && vec != N) || (splits > 1 && (!count || !part)))
    return cudaErrorInvalidValue;
  const T* ut = static_cast<const T*>(u);
  if (vec == N) {
    if (D % N != 0 || !rt::aligned16(u) || !rt::aligned16(pending) ||
        !rt::aligned16(new_pending) || !rt::aligned16(agg) ||
        !rt::aligned16(part))
      return cudaErrorInvalidValue;
    return launch_n<T, N>(ut, pending, weights, keep, W, D, threads, splits,
                          count, part, agg, new_pending, stream);
  }
  return launch_n<T, 1>(ut, pending, weights, keep, W, D, threads, splits,
                        count, part, agg, new_pending, stream);
}

}  // namespace

// u: (W, D) f32 (bf16 == 0) or bf16 (bf16 == 1); pending: (W, D) f32;
// weights, keep: (W,) f32; agg: (D,) f32; new_pending: (W, D) f32, distinct
// from pending; all contiguous. The plan (kernels/fused_round.py plan):
// `vec` columns a thread (16 / element size, or 1), blocks of `threads`
// threads (a multiple of 32, at most 256), `splits` row splits of
// cdiv(W, splits) rows, none empty. With splits > 1: count, one int per
// column tile, all 0 (and 0 again when the kernel ends), and part,
// (splits, D) f32 scratch; only one launch at a time may use them. Returns
// a cudaError_t.
extern "C" int repro_fused_async_agg(const void* u, int bf16,
                                     const float* pending,
                                     const float* weights, const float* keep,
                                     int W, int D, int vec, int threads,
                                     int splits, int* count, float* part,
                                     float* agg, float* new_pending,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(u, pending, weights, keep, W, D, vec,
                                 threads, splits, count, part, agg,
                                 new_pending, st);
  return launch<float>(u, pending, weights, keep, W, D, vec, threads, splits,
                       count, part, agg, new_pending, st);
}
