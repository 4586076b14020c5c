// K2: trust-weighted aggregate of the packed (W, D) update matrix.
//
// Replaces the Pallas kernel src/repro/kernels/trust_agg.py:_kernel
// (wrapped by trust_agg):   out[d] = sum_w weights[w] * u[w, d].
//
// Bound on the H100: bytes. A GEMV-shaped (1 x W)(W x D) product: 2 flops
// per element against 4 (f32) or 2 (bf16) bytes read. At the sync round's
// W = 16, D = 21840 the matrix is 1.4 MB, 0.4 us at 3.35 TB/s: the launch
// and one trip to memory are the cost, so the kernel is one launch whose
// grid fills the card and whose loads are all in flight at once.
//
// Design: one launch, in the host's plan. A thread owns one 16-byte piece
// of a row (4 f32 or 8 bf16 columns; one column where D does not allow
// that), a block of kThreads (32) threads a column tile: 171 tiles at
// D = 21840 f32, more than the 132 SMs. Each thread loads 512 bytes of rows
// (16 f32 or 32 bf16 rows) and their weights into registers before the
// first multiply-add (all 16 rows at W = 16), then adds them in row order
// from 0; at large W that keeps ~85 KB in flight per SM. Where the tiles
// alone leave the card short of blocks (large W), the rows are cut into
// splits of cdiv(W, splits) rows; each split writes its sums to a scratch
// buffer and counts its arrival on its tile's int counter
// (rt::last_to_arrive), and the split that arrives last adds the splits'
// sums in split order and writes out. With one split this is the order of
// the earlier two-launch design at W <= 128 (rows 0..W-1 from 0.f). Fixed
// order, no float atomics, so two launches give the same bits.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 32;   // threads per block: a 512-byte column tile
// Blocks per SM that __launch_bounds__ asks ptxas to allow for. With the
// block width alone as the bound, ptxas gives the f32 kernel more
// registers, and it runs slower on the H100.
constexpr int kMinBlocks = 8;

// The 16/sizeof(T) elements of a 16-byte word, widened to f32.
template <typename T>
__device__ __forceinline__ void unpack_f32(const uint4& raw,
                                           float (&out)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) out[i] = rt::to_f32(e[i]);
}

// N columns per thread: 16 / sizeof(T) (16-byte pieces: D % N == 0 and
// aligned rows) or 1. Block (x, s) owns columns [x * kThreads * N,
// (x + 1) * kThreads * N) and rows [s * rows, min(W, (s + 1) * rows)).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
trust_agg_tiles(const T* __restrict__ u, const float* __restrict__ weights,
                int W, int D, int rows, int* __restrict__ count,
                float* __restrict__ part, float* __restrict__ out) {
  using Raw = typename std::conditional<N == 1, T, uint4>::type;
  constexpr int kBatch = 64 / sizeof(T);   // 16 f32 or 32 bf16 rows
  const int S = gridDim.y, s = blockIdx.y;
  const int r0 = s * rows, r1 = min(W, r0 + rows);
  const int64_t d0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * N;
  const bool live = d0 < D;
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  if (live) {
    const Raw* col = reinterpret_cast<const Raw*>(u + d0);
    const int64_t step = D / (int64_t)(sizeof(Raw) / sizeof(T));  // a row
    for (int r = r0; r < r1; r += kBatch) {
      Raw x[kBatch];
      float w[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (r + i < r1) {
          x[i] = __ldg(col + (int64_t)(r + i) * step);
          w[i] = __ldg(weights + r + i);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (r + i < r1) {
          float f[N];
          if constexpr (N == 1) {
            f[0] = rt::to_f32(x[i]);
          } else {
            unpack_f32<T>(x[i], f);
          }
#pragma unroll
          for (int n = 0; n < N; ++n) acc[n] += w[i] * f[n];
        }
      }
    }
  }
  if (S == 1) {
    if (live) rt::store_f32<N>(out + d0, acc);
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
  rt::store_f32<N>(out + d0, sum);
}

template <typename T, int N>
cudaError_t launch_n(const T* u, const float* weights, int W, int D,
                     int splits, int* count, float* part, float* out,
                     cudaStream_t stream) {
  const int rows = rt::cdiv(W, splits);
  const dim3 grid(rt::cdiv(rt::cdiv(D, N), kThreads), splits);
  trust_agg_tiles<T, N><<<grid, kThreads, 0, stream>>>(u, weights, W, D,
                                                         rows, count, part,
                                                         out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* u, const float* weights, int W, int D,
                   int vec, int splits, int* count, float* part, float* out,
                   cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  if (W < 1 || D < 1 || splits < 1 || splits > W ||
      rt::cdiv(W, rt::cdiv(W, splits)) != splits ||    // none empty
      (vec != 1 && vec != N) || (splits > 1 && (!count || !part)))
    return cudaErrorInvalidValue;
  const T* ut = static_cast<const T*>(u);
  if (vec == N) {
    if (D % N != 0 || !rt::aligned16(u) || !rt::aligned16(out) ||
        !rt::aligned16(part))
      return cudaErrorInvalidValue;
    return launch_n<T, N>(ut, weights, W, D, splits, count, part, out,
                          stream);
  }
  return launch_n<T, 1>(ut, weights, W, D, splits, count, part, out, stream);
}

}  // namespace

// u: (W, D) f32 (bf16 == 0) or bf16 (bf16 == 1), contiguous; weights: (W,)
// f32; out: (D,) f32. The plan (kernels/trust_agg.py plan): `vec` columns
// per thread (16 / element size, or 1), `splits` row splits of
// cdiv(W, splits) rows, none empty. With
// splits > 1: count, one int per column tile, all 0 (and 0 again when the
// kernel ends), and part, (splits, D) f32 scratch; only one launch at a
// time may use them. Returns a cudaError_t.
extern "C" int repro_trust_agg(const void* u, int bf16, const float* weights,
                               int W, int D, int vec, int splits,
                               int* count, float* part, float* out,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(u, weights, W, D, vec, splits, count, part,
                                 out, st);
  return launch<float>(u, weights, W, D, vec, splits, count, part, out, st);
}
