// K4: the SSD / decay-attention chunk scan of Mamba2's prefill.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py:_kernel (wrapped
// by ssd_scan): for each (b, h) the recurrence
//   y_t = q_t . h_t,   h_t = exp(a_t) h_{t-1} + i_t k_t (x) v_t
// by chunks of Q positions. With cum the chunk's inclusive cumsum of a:
//   y_t  = sum_{s<=t} (q_t . k_s) exp(cum_t - cum_s) i_s v_s      (intra)
//        + exp(cum_t) q_t . h                                     (inter)
//   h'   = exp(cum_{Q-1}) h + sum_s exp(cum_{Q-1} - cum_s) i_s k_s (x) v_s
// y in the inputs' dtype, the final state (and the optional initial state)
// (B, H, dk, dv) in f32.
//
// Bound on the H100: operations. At zamba2-7b's prefill (B 4, S 4096,
// H 112, dk = dv = 64, Q 128) the function needs 60 GFLOP against 0.49 GB
// of HBM bytes: 122 flops per byte, above the f32 ridge of the ordinary
// cores (67 TFLOP/s over 3.35 TB/s = 20) though below the tensor cores'.
// This design keeps the arithmetic in f32 on the ordinary cores; wgmma on
// the Q x Q products is the redesign.
//
// Design: one block of 256 threads per (b, h) walks the chunks in order,
// as the TPU grid's sequential chunk axis did, with the dk x dv state in
// shared memory across chunks. Per chunk it stages k transposed (d-major)
// and v, takes the cumsum of a in one warp (lane-local runs, then a
// shuffle scan: a fixed order), then walks row tiles of RT rows: the
// tile's gated scores against the causal columns s < t0 + RT only, stored
// transposed, then y = scores @ v + exp(cum_t) q_t . h written out. Last
// the state update. Every product is a register-tiled loop in the manner
// of an SGEMM: each operand sits in shared memory with its contracted
// index outermost, so a thread reads its 2-4 consecutive rows or columns
// with one vector load, and a warp's loads touch only a few distinct
// 16-byte words (broadcast), which keeps shared memory from bounding the
// FMAs. Row strides are padded by 4 floats, which keeps the transposing
// stores at 4-way bank conflicts. The row tile keeps shared memory at
// 110 KB for zamba2's shape (two blocks per SM) where holding the whole
// Q x Q gated matrix would take 176 KB (one).
//
// Above the diagonal cum_t - cum_s is positive (up to ~+100 at zamba2's
// gates) and exp overflows: the kernel selects 0 there and never multiplies
// by a mask (inf * 0 is NaN). q and k are read through their strides: in
// Mamba2 one row of B/C serves every head (head stride 0), so nothing is
// copied per head. Every sum has one fixed order and there are no atomics:
// two launches on the same inputs give the same bits.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kSsdThreads = 256;
constexpr int kMaxQ = 128;
constexpr int kMaxD = 128;
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared memory of one block, in floats:
// the state h [dk][vp], k transposed [dk][qp], v [Q][vp], the tile's q
// transposed [dk][RT + 4], its gated scores transposed [Q][RT + 4], and
// four (Q,) vectors. vp pads dv to the output columns of a warp (VD / 8),
// qp pads Q to 16 plus 4.
inline int64_t smem_floats(int Q, int dk, int dv, int VD, int RT) {
  const int64_t vp = round_up(dv, VD / 8), qp = round_up(Q, 16) + 4;
  return dk * vp + dk * qp + Q * vp + (int64_t)(dk + Q) * (RT + 4) + 4 * Q;
}

// N consecutive floats of shared memory in 16-byte loads (8-byte for
// N == 2); p must be aligned to them.
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const float4 x = reinterpret_cast<const float4*>(p)[c];
      o[4 * c] = x.x, o[4 * c + 1] = x.y, o[4 * c + 2] = x.z,
               o[4 * c + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x, o[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}

// KD, VD: the largest dk, dv the instantiation takes (64 or 128); RT: rows
// per tile (32 or 16).
template <typename T, int KD, int VD, int RT>
__global__ void __launch_bounds__(kSsdThreads)
ssd_chunk_scan(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ a,
               const float* __restrict__ gi, const float* __restrict__ h0,
               int S, int H, int dk, int dv, int Q, int64_t qsb,
               int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
               int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
               T* __restrict__ y, float* __restrict__ h_out) {
  constexpr int RR = RT / 8;          // tile rows per thread
  constexpr int RP = RT + 4;          // row stride of the tile arrays
  constexpr int CW = VD / 8;          // output columns per warp
  constexpr int NV = CW / 4;          // output columns per thread
  constexpr int SR = KD / 16;         // state rows per thread
  constexpr int SC = VD / 16;         // state columns per thread
  extern __shared__ __align__(16) float smem[];
  const int vp = round_up(dv, CW), qp = round_up(Q, 16) + 4;
  float* h_s = smem;                  // [dk][vp]
  float* kT_s = h_s + dk * vp;        // [dk][qp]   k transposed
  float* v_s = kT_s + dk * qp;        // [Q][vp]
  float* qT_s = v_s + Q * vp;         // [dk][RP]   the tile's q, transposed
  float* pT_s = qT_s + dk * RP;       // [Q][RP]    its gated scores, transposed
  float* cum_s = pT_s + Q * RP;       // [Q] cumsum of a over the chunk
  float* ecum_s = cum_s + Q;          // [Q] exp(cum)
  float* i_s = ecum_s + Q;            // [Q]
  float* w_s = i_s + Q;               // [Q] exp(total - cum) * i

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;
  const int64_t gb = (int64_t)b * S * H + h;       // gates: (B, S, H)
  const int64_t ys = (int64_t)H * dv;              // y: (B, S, H, dv)
  T* yb = y + gb * dv;

  // the state, and zeros in every padding column (never written again)
  for (int x = t; x < dk * vp; x += kSsdThreads) {
    const int d = x / vp, e = x - d * vp;
    h_s[x] = (h0 && e < dv) ? h0[((int64_t)bh * dk + d) * dv + e] : 0.f;
  }
  for (int x = t; x < dk * (qp - Q); x += kSsdThreads) {
    const int d = x / (qp - Q);
    kT_s[d * qp + Q + (x - d * (qp - Q))] = 0.f;
  }
  for (int x = t; x < Q * (vp - dv); x += kSsdThreads) {
    const int s = x / (vp - dv);
    v_s[s * vp + dv + (x - s * (vp - dv))] = 0.f;
  }

  // per-thread coordinates of the three products
  const int rg = lane >> 2, cg = lane & 3;
  const int c0 = 16 * warp + 4 * cg;        // score columns c0 .. c0 + 3
  const int e0 = CW * warp + NV * cg;       // output columns e0 .. + NV - 1
  const int d0 = (KD / 8) * warp + SR * (lane >> 4);   // state rows
  const int f0 = SC * (lane & 15);                     // state columns

  for (int s0 = 0; s0 < S; s0 += Q) {
    __syncthreads();              // the previous chunk is done with smem
    for (int x = t; x < Q * dk; x += kSsdThreads) {
      const int s = x / dk, d = x - s * dk;
      kT_s[d * qp + s] = rt::to_f32(kb[(int64_t)(s0 + s) * kss + d]);
    }
    for (int x = t; x < Q * dv; x += kSsdThreads) {
      const int s = x / dv, e = x - s * dv;
      v_s[s * vp + e] = rt::to_f32(vb[(int64_t)(s0 + s) * vss + e]);
    }
    if (t < Q) i_s[t] = gi[gb + (int64_t)(s0 + t) * H];
    if (warp == 0) {
      // cumsum: lane l sums its run of E consecutive gates, a shuffle scan
      // adds the runs before it
      const int E = (Q + 31) / 32;
      const int lo = min(lane * E, Q), hi = min(lo + E, Q);
      float run = 0.f;
      for (int s = lo; s < hi; ++s) {
        run += a[gb + (int64_t)(s0 + s) * H];
        cum_s[s] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += n;
      }
      const float before = incl - run;
      for (int s = lo; s < hi; ++s) cum_s[s] += before;
    }
    __syncthreads();
    const float total = cum_s[Q - 1];
    if (t < Q) {
      ecum_s[t] = expf(cum_s[t]);
      w_s[t] = expf(total - cum_s[t]) * i_s[t];
    }

    for (int t0 = 0; t0 < Q; t0 += RT) {
      const int rows = min(RT, Q - t0);
      const int ns = min(t0 + RT, Q);     // causal: columns s < t0 + RT
      for (int x = t; x < RT * dk; x += kSsdThreads) {
        const int r = x / dk, d = x - r * dk;
        qT_s[d * RP + r] =
            r < rows ? rt::to_f32(qb[(int64_t)(s0 + t0 + r) * qss + d]) : 0.f;
      }
      __syncthreads();

      // gated scores p[t][s] = (q_t . k_s) L[t][s] i_s, stored as pT[s][t]:
      // warp w takes columns 16w .. 16w + 15, a thread RR rows x 4 columns
      if (16 * warp < ns) {
        float acc[RR][4];
#pragma unroll
        for (int r = 0; r < RR; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < dk; ++d) {
          float qv[RR], kv[4];
          lds<RR>(qT_s + d * RP + RR * rg, qv);
          lds<4>(kT_s + d * qp + c0, kv);
#pragma unroll
          for (int r = 0; r < RR; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[r][j] += qv[r] * kv[j];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = c0 + j;
          if (s >= ns) continue;
#pragma unroll
          for (int r = 0; r < RR; ++r) {
            const int row = RR * rg + r, tt = t0 + row;
            pT_s[s * RP + row] =
                (row < rows && s <= tt)
                    ? acc[r][j] * expf(cum_s[tt] - cum_s[s]) * i_s[s]
                    : 0.f;
          }
        }
      }
      __syncthreads();

      // y = p @ v (intra) + exp(cum_t) q_t . h (inter): warp w takes
      // columns CW w .. CW w + CW - 1, a thread RR rows x NV columns
      if (CW * warp < dv) {
        float yi[RR][NV], yo[RR][NV];
#pragma unroll
        for (int r = 0; r < RR; ++r)
#pragma unroll
          for (int j = 0; j < NV; ++j) yi[r][j] = yo[r][j] = 0.f;
#pragma unroll 4
        for (int s = 0; s < ns; ++s) {
          float pv[RR], vv[NV];
          lds<RR>(pT_s + s * RP + RR * rg, pv);
          lds<NV>(v_s + s * vp + e0, vv);
#pragma unroll
          for (int r = 0; r < RR; ++r)
#pragma unroll
            for (int j = 0; j < NV; ++j) yi[r][j] += pv[r] * vv[j];
        }
#pragma unroll 4
        for (int d = 0; d < dk; ++d) {
          float qv[RR], hv[NV];
          lds<RR>(qT_s + d * RP + RR * rg, qv);
          lds<NV>(h_s + d * vp + e0, hv);
#pragma unroll
          for (int r = 0; r < RR; ++r)
#pragma unroll
            for (int j = 0; j < NV; ++j) yo[r][j] += qv[r] * hv[j];
        }
#pragma unroll
        for (int r = 0; r < RR; ++r) {
          const int row = RR * rg + r;
          if (row >= rows) continue;
          const float ec = ecum_s[t0 + row];
          T* yr = yb + (int64_t)(s0 + t0 + row) * ys;
#pragma unroll
          for (int j = 0; j < NV; ++j)
            if (e0 + j < dv) store_out(yr + e0 + j, yi[r][j] + yo[r][j] * ec);
        }
      }
      __syncthreads();            // qT_s and pT_s are refilled next tile
    }

    // state update: h[d][e] = exp(total) h[d][e] + sum_s k_s[d] (w_s v_s[e]);
    // warp w takes rows KD/8 w .. KD/8 w + KD/8 - 1, a thread SR x SC
    if ((KD / 8) * warp < dk) {
      float acc[SR][SC];
#pragma unroll
      for (int r = 0; r < SR; ++r)
#pragma unroll
        for (int j = 0; j < SC; ++j) acc[r][j] = 0.f;
      const bool cols = f0 < dv;
#pragma unroll 2
      for (int s = 0; s < Q; ++s) {
        float vv[SC], kv[SR];
        if (cols) {
          lds<SC>(v_s + s * vp + f0, vv);
        } else {
#pragma unroll
          for (int j = 0; j < SC; ++j) vv[j] = 0.f;
        }
        const float w = w_s[s];
#pragma unroll
        for (int j = 0; j < SC; ++j) vv[j] *= w;
#pragma unroll
        for (int r = 0; r < SR; ++r)
          kv[r] = d0 + r < dk ? kT_s[(d0 + r) * qp + s] : 0.f;
#pragma unroll
        for (int r = 0; r < SR; ++r)
#pragma unroll
          for (int j = 0; j < SC; ++j) acc[r][j] += kv[r] * vv[j];
      }
      const float dec = expf(total);
#pragma unroll
      for (int r = 0; r < SR; ++r) {
        const int d = d0 + r;
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int e = f0 + j;
          if (d < dk && e < dv)
            h_s[d * vp + e] = h_s[d * vp + e] * dec + acc[r][j];
        }
      }
    }
  }
  __syncthreads();
  for (int x = t; x < dk * dv; x += kSsdThreads) {
    const int d = x / dv, e = x - d * dv;
    h_out[(int64_t)bh * dk * dv + x] = h_s[d * vp + e];
  }
}

template <typename T, int KD, int VD, int RT>
cudaError_t launch_tile(const T* q, const T* k, const T* v, const float* a,
                        const float* gi, const float* h0, int B, int S,
                        int H, int dk, int dv, int Q, int64_t qsb,
                        int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
                        int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
                        T* y, float* h_out, cudaStream_t stream) {
  const int64_t smem = sizeof(float) * smem_floats(Q, dk, dv, VD, RT);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_scan<T, KD, VD, RT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  ssd_chunk_scan<T, KD, VD, RT><<<B * H, kSsdThreads, smem, stream>>>(
      q, k, v, a, gi, h0, S, H, dk, dv, Q, qsb, qss, qsh, ksb, kss, ksh, vsb,
      vss, vsh, y, h_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* a, const float* gi, const float* h0, int B,
                   int S, int H, int dk, int dv, int Q, int64_t qsb,
                   int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
                   int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
                   void* y, float* h_out, cudaStream_t stream) {
  if (B < 1 || S < 1 || H < 1 || Q < 1 || Q > kMaxQ || S % Q != 0 ||
      dk < 1 || dk > kMaxD || dv < 1 || dv > kMaxD ||
      (int64_t)B * H > 0x7fffffff)
    return cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* yt = static_cast<T*>(y);
  if (dk <= 64 && dv <= 64)
    return launch_tile<T, 64, 64, 32>(qt, kt, vt, a, gi, h0, B, S, H, dk, dv,
                                      Q, qsb, qss, qsh, ksb, kss, ksh, vsb,
                                      vss, vsh, yt, h_out, stream);
  return launch_tile<T, 128, 128, 16>(qt, kt, vt, a, gi, h0, B, S, H, dk, dv,
                                      Q, qsb, qss, qsh, ksb, kss, ksh, vsb,
                                      vss, vsh, yt, h_out, stream);
}

}  // namespace

// q, k: (B, S, H, dk), v: (B, S, H, dv), with element strides (sb, ss, sh,
// 1) each (a head stride may be 0); dtype f32 (bf16 == 0) or bf16
// (bf16 == 1) for all three and for y (B, S, H, dv) contiguous. a, i:
// (B, S, H) f32 contiguous. h0: (B, H, dk, dv) f32 contiguous, or null for
// a zero initial state; h_out: (B, H, dk, dv) f32, the final state.
// S % chunk == 0, chunk <= 128, dk, dv <= 128. Returns a cudaError_t.
extern "C" int repro_ssd_scan(const void* q, const void* k, const void* v,
                              const float* a, const float* i,
                              const float* h0, int bf16, int B, int S, int H,
                              int dk, int dv, int chunk, long long qsb,
                              long long qss, long long qsh, long long ksb,
                              long long kss, long long ksh, long long vsb,
                              long long vss, long long vsh, void* y,
                              float* h_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, a, i, h0, B, S, H, dk, dv, chunk,
                                 qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
                                 y, h_out, st);
  return launch<float>(q, k, v, a, i, h0, B, S, H, dk, dv, chunk, qsb, qss,
                       qsh, ksb, kss, ksh, vsb, vss, vsh, y, h_out, st);
}
