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
//     backward).
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

}  // namespace rt
