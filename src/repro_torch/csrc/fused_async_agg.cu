// K3: async aggregate and pending-buffer flush in one pass.
//
// Replaces the Pallas kernel src/repro/kernels/fused_round.py:_async_kernel
// (wrapped by fused_async_agg_kernel):
//     total       = pending + u                   (f32)
//     new_pending = total * keep[:, None]
//     agg         = sum_w weights[w] * total[w]
//
// Bound on the H100: bytes. Per element it reads u (4 or 2 bytes) and
// pending (4), writes new_pending (4), and does ~4 flops.
//
// Design: a W-split column reduction in two launches. Block (x, s) owns a
// column tile and a W-split of at most 128 rows, keeps weights and keep in
// shared memory, and for each of its rows in order writes that row's slice
// of the new pending buffer and accumulates the aggregate into its split's
// partial sums; a second launch sums the partials in split order. The TPU
// kernel pads pending to its (256, 512) tile grid; here pending stays
// unpadded (W, D) f32, so no pad or slice copies surround the launch.
// Fixed summation order, no atomics.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // threads per block
constexpr int kMaxRows = 256;   // rows per W-split (weights/keep in smem)

// N consecutive elements at p, widened to f32. When N elements fill whole
// 16-byte words the load is vectorised (p must then be 16-byte aligned).
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p,
                                         float (&out)[N]) {
  if constexpr ((N * sizeof(T)) % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < N / kPer; ++c) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer; ++i) out[c * kPer + i] = rt::to_f32(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = rt::to_f32(p[i]);
  }
}

// Block (x, s) owns columns [x*kThreads*N, (x+1)*kThreads*N), N per
// thread, and rows [s*rows, min(W, (s+1)*rows)). For each of its rows r, in
// order, it forms t = u[r] + pending[r], writes new_pending[r] = t * keep[r]
// and accumulates weight[r] * t into partial[s, :]. In the vectorised path
// D % N == 0, so a thread's N columns never straddle the end of a row.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
split_colsum(const T* __restrict__ u, const float* __restrict__ pending,
             const float* __restrict__ weights,
             const float* __restrict__ keep, int W, int D, int rows,
             float* __restrict__ partial, float* __restrict__ new_pending) {
  __shared__ float w_s[kMaxRows];
  __shared__ float k_s[kMaxRows];
  const int r0 = blockIdx.y * rows;
  const int r1 = min(W, r0 + rows);
  for (int i = threadIdx.x; i < r1 - r0; i += kThreads) {
    w_s[i] = weights[r0 + i];
    k_s[i] = keep[r0 + i];
  }
  __syncthreads();
  const int64_t d0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * N;
  if (d0 >= D) return;
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const int64_t off = (int64_t)r * D + d0;
    float t[N], p[N], q[N];
    load_f32<T, N>(u + off, t);
    load_f32<float, N>(pending + off, p);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      t[i] += p[i];
      q[i] = t[i] * k_s[r - r0];
    }
    rt::store_f32<N>(new_pending + off, q);
    const float w = w_s[r - r0];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += w * t[i];
  }
  rt::store_f32<N>(partial + (int64_t)blockIdx.y * D + d0, acc);
}

// out[d] = sum over s < S of partial[s, d], in split order.
__global__ void __launch_bounds__(kThreads)
finish_colsum(const float* __restrict__ partial, int S, int D,
              float* __restrict__ out) {
  const int64_t d = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += partial[(int64_t)s * D + d];
  out[d] = acc;
}

// Both launches on `stream`; partial is (ceil(W/rows), D) f32 scratch.
// Returns the first launch error, or cudaSuccess.
template <typename T>
cudaError_t launch(const T* u, const float* pending, const float* weights,
                   const float* keep, int W, int D, int rows, float* partial,
                   float* agg, float* new_pending, cudaStream_t stream) {
  if (W < 1 || D < 1 || rows < 1 || rows > kMaxRows)
    return cudaErrorInvalidValue;
  const int S = rt::cdiv(W, rows);
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = D % kVec == 0 && rt::aligned16(u) &&
                   rt::aligned16(partial) && rt::aligned16(pending) &&
                   rt::aligned16(new_pending);
  if (vec) {
    const dim3 grid(rt::cdiv(D, (int64_t)kThreads * kVec), S);
    split_colsum<T, kVec><<<grid, kThreads, 0, stream>>>(
        u, pending, weights, keep, W, D, rows, partial, new_pending);
  } else {
    const dim3 grid(rt::cdiv(D, kThreads), S);
    split_colsum<T, 1><<<grid, kThreads, 0, stream>>>(
        u, pending, weights, keep, W, D, rows, partial, new_pending);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finish_colsum<<<rt::cdiv(D, kThreads), kThreads, 0, stream>>>(partial, S,
                                                                D, agg);
  return cudaGetLastError();
}

}  // namespace

// u: (W, D) f32 (bf16 == 0) or bf16 (bf16 == 1); pending: (W, D) f32;
// weights, keep: (W,) f32; partial: (ceil(W/rows), D) f32 scratch;
// agg: (D,) f32; new_pending: (W, D) f32, distinct from pending.
// Returns a cudaError_t.
extern "C" int repro_fused_async_agg(const void* u, int bf16,
                                     const float* pending,
                                     const float* weights, const float* keep,
                                     int W, int D, int rows, float* partial,
                                     float* agg, float* new_pending,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch(static_cast<const __nv_bfloat16*>(u), pending, weights,
                  keep, W, D, rows, partial, agg, new_pending, st);
  return launch(static_cast<const float*>(u), pending, weights, keep, W, D,
                rows, partial, agg, new_pending, st);
}
