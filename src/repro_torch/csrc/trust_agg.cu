// K2: trust-weighted aggregate of the packed (W, D) update matrix.
//
// Replaces the Pallas kernel src/repro/kernels/trust_agg.py:_kernel
// (wrapped by trust_agg):   out[d] = sum_w weights[w] * u[w, d].
//
// Bound on the H100: bytes. A GEMV-shaped (1 x W)(W x D) product: 2 flops
// per element against 4 (f32) or 2 (bf16) bytes read.
//
// Design: each block owns a tile of kThreads * 16 bytes of columns (1024
// f32 or 2048 bf16 columns, one 16-byte load per thread per row) and one
// W-split of at most 128 rows, keeps its weights in shared memory, and
// walks its rows in order; a second launch sums the per-split partials in
// split order (common.cuh). The W-split is what fills the card: D = 21840
// alone gives only 22 column tiles, while W = 4096 in 128-row splits gives
// 22 x 32 = 704 blocks. The update matrix is read once; the partials add
// 2 * ceil(W/128) * D * 4 bytes. Fixed summation order, no atomics.
#include "common.cuh"

// u: (W, D) f32 (bf16 == 0) or bf16 (bf16 == 1); weights: (W,) f32;
// partial: (ceil(W/rows), D) f32 scratch; out: (D,) f32.
// Returns a cudaError_t.
extern "C" int repro_trust_agg(const void* u, int bf16, const float* weights,
                               int W, int D, int rows, float* partial,
                               float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return rt::launch_colsum<__nv_bfloat16, true, false>(
        static_cast<const __nv_bfloat16*>(u), nullptr, weights, nullptr, W, D,
        rows, partial, nullptr, 1.f, out, st);
  return rt::launch_colsum<float, true, false>(
      static_cast<const float*>(u), nullptr, weights, nullptr, W, D, rows,
      partial, nullptr, 1.f, out, st);
}
