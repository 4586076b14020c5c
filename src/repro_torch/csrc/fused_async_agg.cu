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
// Design: the tiling of K2 (trust_agg.cu): a block owns a column tile and
// a W-split of at most 128 rows, keeps weights and keep in shared memory,
// and for each of its rows in order writes that row's slice of the new
// pending buffer and accumulates the aggregate; a second launch sums the
// per-split partials in split order. The TPU kernel pads pending to its
// (256, 512) tile grid; here pending stays unpadded (W, D) f32, so no pad
// or slice copies surround the launch. Fixed summation order, no atomics.
#include "common.cuh"

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
    return rt::launch_colsum<__nv_bfloat16, true, true>(
        static_cast<const __nv_bfloat16*>(u), pending, weights, keep, W, D,
        rows, partial, new_pending, 1.f, agg, st);
  return rt::launch_colsum<float, true, true>(
      static_cast<const float*>(u), pending, weights, keep, W, D, rows,
      partial, new_pending, 1.f, agg, st);
}
