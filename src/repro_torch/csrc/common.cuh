// Shared pieces of the trust-round kernels (trust_score.cu, trust_agg.cu,
// fused_async_agg.cu):
//
//   * f32 loads of f32 or bf16 rows, 16 bytes per instruction when the
//     row length and the pointers allow it (the host picks the path);
//   * a block sum in one fixed order (warp shuffles, then warp 0);
//   * the W-split column reduction: block (x, s) sums rows
//     [s*rows, (s+1)*rows) of its column tile into partial[s, :], and a
//     second launch sums the partials in split order (K1 and K3);
//   * the arrival step of a one-launch reduction (K2, K5): the blocks of a
//     group publish partial sums, and the last to arrive combines them;
//   * the tensor-core pieces of K4 and K5: cp.async copies, ldmatrix,
//     mma.sync m16n8k16 on bf16 and the split of f32 values into bf16
//     parts whose products keep f32's accuracy.
//
// No float atomics anywhere. The scores these kernels feed are committed
// on-chain as <f8 inside Merkle-hashed records, so every sum has one fixed
// order and two runs on the same inputs are bit-identical.
//
// Everything here is a template or an inline device function, so each .cu
// that includes it gets its own copy and the objects link into one library
// without clashes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int kThreads = 256;   // threads per block, every kernel
constexpr int kMaxRows = 256;   // rows per W-split (weights/keep in smem)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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
      for (int i = 0; i < kPer; ++i) out[c * kPer + i] = to_f32(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
  }
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

// Sum of v over the block (blockDim.x == kThreads) in a fixed order; the
// result is valid in thread 0. Every thread of the block must call it.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  __syncthreads();                       // scratch may hold a previous sum
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? scratch[threadIdx.x] : 0.f;
  if (warp == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// Block (x, s) owns columns [x*kThreads*N, (x+1)*kThreads*N), N per
// thread, and rows [s*rows, min(W, (s+1)*rows)). For each of its rows r, in
// order, it forms t = u[r] (+ pending[r] when kPending), writes
// new_pending[r] = t * keep[r] (when kPending), and accumulates
// weight[r] * t (t alone unless kWeighted) into partial[s, :].
// In the vectorised path D % N == 0, so a thread's N columns never straddle
// the end of a row.
template <typename T, int N, bool kWeighted, bool kPending>
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
    if constexpr (kWeighted) w_s[i] = weights[r0 + i];
    if constexpr (kPending) k_s[i] = keep[r0 + i];
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
    float t[N];
    load_f32<T, N>(u + off, t);
    if constexpr (kPending) {
      float p[N], q[N];
      load_f32<float, N>(pending + off, p);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        t[i] += p[i];
        q[i] = t[i] * k_s[r - r0];
      }
      store_f32<N>(new_pending + off, q);
    }
    if constexpr (kWeighted) {
      const float w = w_s[r - r0];
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += w * t[i];
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += t[i];
    }
  }
  store_f32<N>(partial + (int64_t)blockIdx.y * D + d0, acc);
}

// out[d] = (sum over s < S of partial[s, d], in split order) / divisor.
template <int kUnused = 0>
__global__ void __launch_bounds__(kThreads)
finish_colsum(const float* __restrict__ partial, int S, int D, float divisor,
              float* __restrict__ out) {
  const int64_t d = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += partial[(int64_t)s * D + d];
  out[d] = acc / divisor;
}

inline bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

inline int cdiv(int64_t a, int64_t b) { return (int)((a + b - 1) / b); }

// Both launches of the W-split column sum on `stream`: out = sum of the
// (weighted) rows / divisor, partial is (ceil(W/rows), D) f32 scratch.
// Returns the first launch error, or cudaSuccess.
template <typename T, bool kWeighted, bool kPending>
cudaError_t launch_colsum(const T* u, const float* pending,
                          const float* weights, const float* keep, int W,
                          int D, int rows, float* partial, float* new_pending,
                          float divisor, float* out, cudaStream_t stream) {
  if (W < 1 || D < 1 || rows < 1 || rows > kMaxRows)
    return cudaErrorInvalidValue;
  const int S = cdiv(W, rows);
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = D % kVec == 0 && aligned16(u) && aligned16(partial) &&
                   aligned16(pending) && aligned16(new_pending);
  if (vec) {
    const dim3 grid(cdiv(D, (int64_t)kThreads * kVec), S);
    split_colsum<T, kVec, kWeighted, kPending><<<grid, kThreads, 0, stream>>>(
        u, pending, weights, keep, W, D, rows, partial, new_pending);
  } else {
    const dim3 grid(cdiv(D, kThreads), S);
    split_colsum<T, 1, kWeighted, kPending><<<grid, kThreads, 0, stream>>>(
        u, pending, weights, keep, W, D, rows, partial, new_pending);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finish_colsum<0><<<cdiv(D, kThreads), kThreads, 0, stream>>>(partial, S, D,
                                                               divisor, out);
  return cudaGetLastError();
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

// -- tensor-core pieces (K4, K5) ---------------------------------------------

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

}  // namespace rt
