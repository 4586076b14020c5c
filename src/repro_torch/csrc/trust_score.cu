// K1: per-worker trust statistics of the packed (W, D) update matrix.
//
// Replaces the Pallas kernel src/repro/kernels/trust_score.py:_kernel
// (wrapped by trust_score_stats). Computes, against the consensus
// c = mean_w u_w:
//     dot[w] = <u_w, c>     sq_u[w] = |u_w|^2     sq_c = |c|^2
//
// Bound on the H100: bytes. The work is ~4 flops per element against 4
// (f32) or 2 (bf16) bytes read, far below the card's flops-per-byte ridge.
//
// Design (A of the two considered): the TPU kernel holds a whole (W, BD)
// column block in VMEM and recomputes c per block in one sweep. A block
// here has 227 KB of shared memory, and W runs to 10240 (40 MB of one f32
// column block at BD = 1024), so the sweep is split in two:
//   1. column pass  c = (sum over W-splits of per-split column sums) / W,
//      through the shared W-split reduction (common.cuh): 2 launches;
//   2. row pass     one block per worker row: <u_w, c> and |u_w|^2 with c
//      re-read from L2 (87 KB at D = 21840), plus one extra block for |c|^2.
// It streams the update matrix from HBM twice, against the TPU kernel's
// single read. That gap (2x the K1 bytes) is the first target of a later
// optimisation, e.g. design B: narrow D tiles whose second read hits L2.
// All sums run in a fixed order; no atomics.
#include "common.cuh"

namespace {

template <typename T, int N>
__global__ void __launch_bounds__(rt::kThreads)
row_stats(const T* __restrict__ u, const float* __restrict__ c, int W, int D,
          float* __restrict__ dot, float* __restrict__ sq_u,
          float* __restrict__ sq_c) {
  __shared__ float scratch[rt::kThreads / 32];
  const int row = blockIdx.x;
  float a = 0.f, b = 0.f;
  if (row < W) {
    const T* ur = u + (int64_t)row * D;
    for (int64_t d0 = (int64_t)threadIdx.x * N; d0 < D;
         d0 += (int64_t)rt::kThreads * N) {
      float v[N], cv[N];
      rt::load_f32<T, N>(ur + d0, v);
      rt::load_f32<float, N>(c + d0, cv);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        a += v[i] * cv[i];
        b += v[i] * v[i];
      }
    }
  } else {                                  // the extra block: |c|^2
    for (int64_t d0 = (int64_t)threadIdx.x * N; d0 < D;
         d0 += (int64_t)rt::kThreads * N) {
      float cv[N];
      rt::load_f32<float, N>(c + d0, cv);
#pragma unroll
      for (int i = 0; i < N; ++i) a += cv[i] * cv[i];
    }
  }
  a = rt::block_sum(a, scratch);
  b = rt::block_sum(b, scratch);
  if (threadIdx.x == 0) {
    if (row < W) {
      dot[row] = a;
      sq_u[row] = b;
    } else {
      *sq_c = a;
    }
  }
}

template <typename T>
cudaError_t run(const T* u, int W, int D, int rows, float* partial, float* c,
                float* dot, float* sq_u, float* sq_c, cudaStream_t stream) {
  cudaError_t err = rt::launch_colsum<T, false, false>(
      u, nullptr, nullptr, nullptr, W, D, rows, partial, nullptr, (float)W, c,
      stream);
  if (err != cudaSuccess) return err;
  constexpr int kVec = 16 / sizeof(T);
  if (D % kVec == 0 && rt::aligned16(u) && rt::aligned16(c)) {
    row_stats<T, kVec><<<W + 1, rt::kThreads, 0, stream>>>(u, c, W, D, dot,
                                                            sq_u, sq_c);
  } else {
    row_stats<T, 1><<<W + 1, rt::kThreads, 0, stream>>>(u, c, W, D, dot, sq_u,
                                                         sq_c);
  }
  return cudaGetLastError();
}

}  // namespace

// u: (W, D) f32 (bf16 == 0) or bf16 (bf16 == 1), contiguous.
// partial: (ceil(W/rows), D) f32 scratch; c: (D,) f32 scratch (the
// consensus); dot, sq_u: (W,) f32; sq_c: (1,) f32. Returns a cudaError_t.
extern "C" int repro_trust_score(const void* u, int bf16, int W, int D,
                                 int rows, float* partial, float* c,
                                 float* dot, float* sq_u, float* sq_c,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run(static_cast<const __nv_bfloat16*>(u), W, D, rows, partial, c,
               dot, sq_u, sq_c, st);
  return run(static_cast<const float*>(u), W, D, rows, partial, c, dot, sq_u,
             sq_c, st);
}
