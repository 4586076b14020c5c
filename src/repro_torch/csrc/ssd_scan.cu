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
// (B, H, dk, dv) in f32. Under grad the caller also asks for the state
// before each chunk, (B, S / Q, H, dk, dv) f32, which the backward
// (ssd_scan_bwd.cu) reads instead of recomputing it.
//
// Bound on the H100: bytes. At zamba2-7b's prefill (B 4, S 4096, H 112,
// dk = dv = 64, Q 128) the function needs 60.4 GFLOP against 0.50 GB of
// HBM bytes in bf16 (0.97 GB in f32): 122 flops per byte, below the bf16
// tensor cores' ridge (989 TFLOP/s over 3.35 TB/s = 295) but six times the
// f32 ordinary cores' (20). So the four products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulators, operands by ldmatrix):
// the scores q k^T, P v, q . h and the state update k^T (w v).
//
// Accuracy. bf16 q, k and v are exact operands. The operands that are f32
// by nature, the gated scores P, the carried state h and w v (w_s =
// exp(total - cum_s) i_s), are split into NP bf16 parts, part j rounding
// what parts 0 .. j - 1 left (rt::split_bf16), and the products of parts
// are summed in f32: two parts keep ~16 bits, a relative error of ~2^-17,
// inside the card check (1e-4 of max|plain f32|; ssd_scan.ATOL_REL). f32
// inputs split q, k and v into three parts as well, and every operand
// pair takes the six products of parts i + j < 3 (~24 bits). The state
// itself stays f32, in the mma accumulators of the warps that update it;
// only its operand copy for q . h is split.
//
// The decay is not folded into q and k: exp(cum_t - cum_s) cannot be
// factored as exp(cum_t) exp(-cum_s), because at zamba2's gates |cum|
// reaches ~900 within a chunk and exp(-cum_s) overflows f32. It stays an
// elementwise factor on each 16 x 16 block of scores, computed from the
// difference; above the diagonal the difference is positive and the exp
// overflows, so there the block is selected to 0, never multiplied by a
// mask (inf * 0 is NaN).
//
// Design: one block of 8 warps per (b, h) walks the chunks in order (the TPU
// grid's sequential chunk axis; 16 warps, two to a row tile, for bf16 at dk
// or dv > 64, where 8 would run short of registers). Shared memory holds the
// chunk's q, k and v rows in their own dtype (bf16; f32 as three bf16
// planes), the state's parts and the chunk's gates (cumsum, exp(cum), i and
// w, from one warp's shuffle scan). In the serve's case, bf16 at dk = dv =
// 64, there are two stages: right after the chunk's first barrier one thread
// asks the bulk copy engine (TMA, tensor maps built by the host) for chunk n
// + 1's q, k and v as three boxes of Q rows, counted on the stage's mbarrier,
// and the block computes chunk n meanwhile. Per-thread 16-byte copies issued
// by every warp stalled those warps for about a third of a chunk, and a
// single copy warp could not keep up. The boxes land in the engine's 128-byte
// swizzle (piece c of row r at c ^ (r % 8)), so ldmatrix's eight row reads
// hit distinct banks. Every thread then splits w v into shared memory; behind
// the second barrier warp w takes the 16-row tile w (w < 4) or 11 - w (w >=
// 4), so that the two warps on one scheduler share the causal work evenly: q
// . h from the state's parts, scaled by exp(cum_t), then, two at a time, the
// 16-column blocks of the causal scores, each gated and split in registers
// and multiplied into v at once, so P never leaves registers; then y. Warp 0,
// whose tile is the lightest, then takes the next chunk's gates. Every warp
// updates its 16 state columns x 32 state rows in its accumulators and writes
// their parts, double-buffered, for the next chunk: two block barriers a
// chunk. Its 177 KB of shared memory fit one block an SM; a one-stage block at
// two an SM hides its copies behind the other block instead, and was faster
// only at some block counts (slower at batch 1). Where two stages would not fit
// (f32, and bf16 at dk or dv > 64) the block keeps one stage with rows padded
// to an odd number of 16-byte pieces (the same bank spread), copied by every
// thread, one copy of the state's parts, and splits w v per warp, with two
// barriers more a chunk; operands the engine cannot take (rows of other than 64
// values, unaligned strides) are copied by every thread too. f32 at dk or dv >
// 64, whose three-part planes do not fit at all, keeps the first, ordinary-core
// design (below). q and k are read through their strides: in Mamba2 one row of
// B/C serves every head (head stride 0, a tensor map without the head axis), so
// nothing is copied per head. Every sum has one fixed order and there are no
// atomics: two launches on the same inputs give the same bits.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <math.h>

#include "common.cuh"

namespace {

using rt::exp_of;
using rt::mbar_expect;
using rt::mbar_init;
using rt::mbar_wait;
using rt::smem_u32;
using rt::tensor_map_encoder;
using rt::unpack_bf16x2;

// -- the ordinary-core design (f32 at dk or dv > 64) -------------------------
//
// The first design: one block of 256 threads per (b, h), the state in f32
// shared memory, every product a register-tiled loop of f32 FMAs on the
// ordinary cores over operands laid out for vector loads.

constexpr int kSsdThreads = 256;
constexpr int kMaxQ = 128;
constexpr int kMaxD = 128;
constexpr int kMaxSmem = 232448;

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
               T* __restrict__ y, float* __restrict__ h_out,
               float* __restrict__ states) {
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
    if (states) {                 // the state before this chunk, for the
      float* st = states +        // backward
                  ((int64_t)(b * (S / Q) + s0 / Q) * H + h) * dk * dv;
      for (int x = t; x < dk * dv; x += kSsdThreads) {
        const int d = x / dv, e = x - d * dv;
        st[x] = h_s[d * vp + e];
      }
    }
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
            if (e0 + j < dv)
              rt::store_out(yr + e0 + j, yi[r][j] + yo[r][j] * ec);
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
                        T* y, float* h_out, float* states,
                        cudaStream_t stream) {
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
      vss, vsh, y, h_out, states);
  return cudaGetLastError();
}


// -- the tensor-core design ---------------------------------------------------


// Shapes and shared memory of one instantiation. KD, VD: the largest dk, dv
// it takes (64 or 128), zero-padded up to them. NQ: bf16 parts of q, k, v
// (1 for bf16, 3 for f32); NP: parts of the operands that are f32 by nature
// (the gated scores P, the carried state h, w.v): 2 for bf16, 3 for f32.
// Two stages of q, k, v rows and two copies of the state's parts, or with
// kLean, where those would not fit, one of each and two barriers more a
// chunk; without kLean the w.v parts also sit in shared memory, formed once
// a chunk, where kLean has each warp form those of its state columns. A
// padded row (the state's parts, w.v, and q, k, v with kLean) is KSTR or
// VSTR 16-byte pieces, an odd count, so ldmatrix's eight row reads hit
// distinct banks. kW: warps a block (8; 16 where registers are short).
template <typename T, int KD, int VD, bool kLean, int kW>
struct Tc {
  static constexpr int NQ = sizeof(T) == 2 ? 1 : 3;
  static constexpr int NP = sizeof(T) == 2 ? 2 : 3;
  static constexpr int KSTR = KD / 8 + 1;
  static constexpr int VSTR = VD / 8 + 1;
  static constexpr int kStages = kLean ? 1 : 2;
  static constexpr int kHBufs = kLean ? 1 : 2;
  static constexpr int kPairs = VD / 16;          // 16-column state slices
  static constexpr int kMtw = (KD / 16) / (kW / kPairs);
  // Two stages keep q, k, v rows of exactly 128 bytes (bf16, KD = VD =
  // 64) in the bulk copy engine's 128-byte swizzle: piece c of row r sits
  // at piece c ^ (r % 8), so ldmatrix's eight row reads hit distinct
  // banks.
  static constexpr bool kSwz = !kLean;
  static_assert(!kSwz || (KD == 64 && VD == 64 && sizeof(T) == 2),
                "two stages take bf16 rows of 64 values");
  static_assert(KD == VD, "one padded row stride for q, k and v");
  static constexpr int SK = kSwz ? KD / 8 : KSTR;  // pieces a q, k row
  static constexpr int SV = kSwz ? VD / 8 : VSTR;  // pieces a v row
  static constexpr __host__ __device__ int64_t stage_pieces(int QP) {
    return (int64_t)NQ * QP * (2 * SK + SV);
  }
  static constexpr __host__ __device__ int64_t h_pieces() {
    return (int64_t)NP * KD * VSTR;
  }
  static constexpr __host__ __device__ int64_t wv_pieces(int QP) {
    return kLean ? 0 : (int64_t)NP * QP * VSTR;
  }
  // gates, per buffer: cum, exp(cum), i, w = exp(total - cum) i, each [QP],
  // then total and exp(total)
  static constexpr __host__ __device__ int gate_floats(int QP) {
    return 4 * QP + 4;
  }
  // then the stages' two mbarriers, and with the swizzle 1 KB to align
  // the stages to it
  static constexpr int64_t bytes(int QP) {
    return 16 * (kStages * stage_pieces(QP) + kHBufs * h_pieces() +
                 wv_pieces(QP)) +
           2 * 4 * gate_floats(QP) + 16 + (kSwz ? 1024 : 0);
  }
};

// One box of the tensor map `map` at coordinates c (3 or 4 of them, the
// fastest first) into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load(void* smem, const CUtensorMap* map,
                                         int rank, int c0, int c1, int c2,
                                         int c3, uint64_t* bar) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if (rank == 3)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
            smem_u32(smem)),
        "l"(m), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
            smem_u32(smem)),
        "l"(m), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Rows s0 .. s0 + QP - 1 of one operand (row stride ss, d values a row)
// into shared rows of `stride` 16-byte pieces from dst: each thread copies
// one piece column, every kThreads / P-th row (P = pieces of a row); zero
// past row Q and past value d. bf16 by cp.async where the operand allows
// 16-byte copies (vec), f32 split into NQ bf16 planes `plane` pieces apart.
// With kSwz, rows of 8 pieces in the 128-byte swizzle (Tc).
template <typename T, int NQ, int P, int kThreads, bool kSwz>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           int64_t ss, int d, int Q, int QP,
                                           int s0, uint4* dst, int stride,
                                           int plane, bool vec) {
  constexpr int RS = kThreads / P;
  const int c = threadIdx.x % P, r0 = threadIdx.x / P;
  const int ne = max(0, min(8, d - 8 * c));
  const T* p = src + (int64_t)(s0 + r0) * ss + 8 * c;
  const int64_t step = RS * ss;
#pragma unroll 2
  for (int row = r0; row < QP; row += RS, p += step) {
    const int n = row < Q ? ne : 0;
    uint4* o = kSwz ? dst + row * 8 + (c ^ (row & 7)) : dst + row * stride + c;
    if constexpr (NQ == 1) {
      if (vec) {
        rt::cp_async16_zfill(o, n ? p : src, 2 * n);
      } else {
        __align__(16) T e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = j < n ? p[j] : T(0.f);
        *o = *reinterpret_cast<const uint4*>(e);
      }
    } else {
      float e[8];
      if (vec && n == 8) {
        const float4 u0 = __ldg(reinterpret_cast<const float4*>(p));
        const float4 u1 = __ldg(reinterpret_cast<const float4*>(p) + 1);
        e[0] = u0.x, e[1] = u0.y, e[2] = u0.z, e[3] = u0.w;
        e[4] = u1.x, e[5] = u1.y, e[6] = u1.z, e[7] = u1.w;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = j < n ? rt::to_f32(p[j]) : 0.f;
      }
      uint32_t part[4][NQ];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rt::split_bf16<NQ>(e[2 * j], e[2 * j + 1], part[j]);
#pragma unroll
      for (int pp = 0; pp < NQ; ++pp)
        o[pp * plane] =
            make_uint4(part[0][pp], part[1][pp], part[2][pp], part[3][pp]);
    }
  }
}

// kMinBlocks: blocks an SM that ptxas leaves registers for (1 in the
// dispatch; repro_torch.tools.k4_designs times 2 against it).
template <typename T, int KD, int VD, bool kLean, int kW,
          int kMinBlocks = 1>
__global__ void __launch_bounds__(32 * kW, kMinBlocks)
ssd_chunk_scan_mma(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ a,
                   const float* __restrict__ gi, const float* __restrict__ h0,
                   int S, int H, int dk, int dv, int Q, int64_t qsb,
                   int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
                   int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
                   int vec, int tma, const __grid_constant__ CUtensorMap tmq,
                   const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv,
                   T* __restrict__ y, float* __restrict__ h_out,
                   float* __restrict__ states) {
  using Sh = Tc<T, KD, VD, kLean, kW>;
  constexpr int kThreads = 32 * kW;
  constexpr int NQ = Sh::NQ, NP = Sh::NP;
  constexpr int KSTR = Sh::KSTR, VSTR = Sh::VSTR, SK = Sh::SK, SV = Sh::SV;
  constexpr int kMtw = Sh::kMtw;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int QP = (Q + 15) & ~15;
  const int nc = S / Q;
  // the stages at a 1 KB boundary for the swizzle
  uint4* stages = reinterpret_cast<uint4*>(
      tc_smem + (Sh::kSwz ? (1024 - (smem_u32(tc_smem) & 1023)) & 1023 : 0));
  const int64_t sp = Sh::stage_pieces(QP);
  uint4* hparts = stages + Sh::kStages * sp;
  uint4* wvparts = hparts + Sh::kHBufs * Sh::h_pieces();
  float* gates = reinterpret_cast<float*>(wvparts + Sh::wv_pieces(QP));
  const int GF = Sh::gate_floats(QP);
  uint64_t* mbar = reinterpret_cast<uint64_t*>(gates + 2 * GF);
  // plane p of q, k, v in stage st; part p of the state in buffer hb and
  // of w.v
  auto qpl = [&](int st, int p) { return stages + st * sp + p * QP * SK; };
  auto kpl = [&](int st, int p) {
    return stages + st * sp + (NQ + p) * QP * SK;
  };
  auto vpl = [&](int st, int p) {
    return stages + st * sp + 2 * NQ * QP * SK + p * QP * SV;
  };
  // piece c of row r of a q, k or v plane (swizzled or padded)
  auto at = [&](uint4* plane, int r, int c) {
    return Sh::kSwz ? plane + r * 8 + (c ^ (r & 7)) : plane + r * KSTR + c;
  };
  auto hpl = [&](int hb, int p) {
    return hparts + hb * Sh::h_pieces() + p * KD * VSTR;
  };
  auto wvpl = [&](int p) { return wvparts + p * QP * VSTR; };

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int g = lane >> 2, qd = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;
  const int64_t gb = (int64_t)b * S * H + h;       // gates: (B, S, H)
  const int64_t ys = (int64_t)H * dv;              // y: (B, S, H, dv)
  T* yb = y + gb * dv;
  const bool even = dv % 2 == 0;                   // pairs of y aligned

  // Chunk n's q, k, v rows into stage st: with the bulk copy engine
  // where the host built tensor maps (tma), one thread asking for three
  // boxes of Q rows counted on the stage's mbarrier; else by every thread.
  const bool use_tma = Sh::kSwz && (tma & 1);
  auto stage = [&](int n, int st) {
    if (use_tma) {
      if (t == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect(mbar + st, 3 * Q * 128);
        const int s0 = n * Q;
        tma_load(qpl(st, 0), &tmq, tma & 2 ? 4 : 3, 0, tma & 2 ? h : s0,
                 tma & 2 ? s0 : b, b, mbar + st);
        tma_load(kpl(st, 0), &tmk, tma & 4 ? 4 : 3, 0, tma & 4 ? h : s0,
                 tma & 4 ? s0 : b, b, mbar + st);
        tma_load(vpl(st, 0), &tmv, 4, 0, h, s0, b, mbar + st);
      }
      return;
    }
    stage_rows<T, NQ, KD / 8, kThreads, Sh::kSwz>(
        qb, qss, dk, Q, QP, n * Q, qpl(st, 0), KSTR, QP * SK, vec & 1);
    stage_rows<T, NQ, KD / 8, kThreads, Sh::kSwz>(
        kb, kss, dk, Q, QP, n * Q, kpl(st, 0), KSTR, QP * SK, vec & 2);
    stage_rows<T, NQ, VD / 8, kThreads, Sh::kSwz>(
        vb, vss, dv, Q, QP, n * Q, vpl(st, 0), VSTR, QP * SV, vec & 4);
  };

  // the gates of a chunk, lane-local runs of E = ceil(Q / 32) (warp 0)
  const int E = (Q + 31) / 32;
  const int glo = min(lane * E, Q), ghi = min(glo + E, Q);
  float ga[4], gv[4];
  auto gate_load = [&](int n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = glo + j;
      const int64_t o = gb + (int64_t)(n * Q + s) * H;
      ga[j] = s < ghi ? a[o] : 0.f;
      gv[j] = s < ghi ? gi[o] : 0.f;
    }
  };
  // cumsum: each lane sums its run, a shuffle scan adds the runs before it
  auto gate_scan = [&](float* gs) {
    float* cum = gs;
    float* ec = gs + QP;
    float* iv = gs + 2 * QP;
    float* ww = gs + 3 * QP;
    float run = 0.f, c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (glo + j < ghi) run += ga[j];
      c[j] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float nb = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += nb;
    }
    const float before = incl - run;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (glo + j < ghi) cum[glo + j] = c[j] + before;
    __syncwarp();
    const float total = cum[Q - 1];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = glo + j;
      if (s < ghi) {
        ec[s] = expf(cum[s]);
        iv[s] = gv[j];
        ww[s] = expf(total - cum[s]) * gv[j];
      }
    }
    if (Q + lane < QP) {       // padding slots: no weight, no decay
      cum[Q + lane] = 0.f, ec[Q + lane] = 0.f, iv[Q + lane] = 0.f,
                 ww[Q + lane] = 0.f;
    }
    if (lane == 0) gs[4 * QP] = total, gs[4 * QP + 1] = expf(total);
  };

  // the state: warp w holds columns 16 (w % kPairs) .. + 15 and kMtw
  // 16-row tiles from mt0, as mma accumulators, in f32 across chunks
  const int pair = w % Sh::kPairs, mt0 = (w / Sh::kPairs) * kMtw;
  float hs[kMtw][2][4];
#pragma unroll
  for (int m = 0; m < kMtw; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 16 * (mt0 + m) + g + 8 * (e >> 1);
        const int col = 16 * pair + 8 * n + 2 * qd + (e & 1);
        hs[m][n][e] = (h0 && d < dk && col < dv)
                          ? h0[((int64_t)bh * dk + d) * dv + col]
                          : 0.f;
      }
  // its NP bf16 parts, [d][e] rows, for the B operand of q . h
  auto write_hparts = [&](int hb) {
#pragma unroll
    for (int m = 0; m < kMtw; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int d = 16 * (mt0 + m) + g + 8 * hf;
          const int col = 16 * pair + 8 * n + 2 * qd;
          uint32_t part[NP];
          rt::split_bf16<NP>(hs[m][n][2 * hf], hs[m][n][2 * hf + 1], part);
#pragma unroll
          for (int p = 0; p < NP; ++p)
            reinterpret_cast<uint32_t*>(hpl(hb, p) + d * VSTR)[col / 2] =
                part[p];
        }
  };

  // the state before chunk n, for the backward (states may be null)
  auto write_states = [&](int n) {
    float* st = states + ((int64_t)(b * nc + n) * H + h) * dk * dv;
#pragma unroll
    for (int m = 0; m < kMtw; ++m)
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 16 * (mt0 + m) + g + 8 * (e >> 1);
          const int col = 16 * pair + 8 * nn + 2 * qd + (e & 1);
          if (d < dk && col < dv) st[(int64_t)d * dv + col] = hs[m][nn][e];
        }
  };

  if (use_tma) {
    // the boxes write rows < Q only: rows Q .. QP - 1 stay zero
    for (int64_t x = t; x < Sh::kStages * sp; x += kThreads)
      stages[x] = make_uint4(0u, 0u, 0u, 0u);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (t == 0) {
      mbar_init(mbar);
      mbar_init(mbar + 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  write_hparts(0);
  if (states) write_states(0);
  stage(0, 0);
  rt::cp_async_commit();
  if (w == 0) {
    gate_load(0);
    gate_scan(gates);
  }

  // row tile of the y phase: warps w and w + 4 share a scheduler, so they
  // take tiles w and 7 - w, whose causal work sums to the same; with 16
  // warps, warps w and w + 8 take the two halves of its columns
  const int wr = w & 7, rt_ = wr < 4 ? wr : 11 - wr;
  const int t0 = 16 * rt_;
  constexpr int YN = VD / 8 / (kW / 8);      // 8-wide column tiles a warp
  const int n0 = (w >> 3) * YN;

  for (int n = 0; n < nc; ++n) {
    const int st = kLean ? 0 : n & 1;
    const int hb = kLean ? 0 : n & 1;
    const float* gs = gates + (n & 1) * GF;
    rt::cp_async_wait<0>();
    if (use_tma) mbar_wait(mbar + st, (n >> 1) & 1);
    __syncthreads();          // chunk n's rows, gates and state parts are in
    if constexpr (!kLean) {
      if (n + 1 < nc) stage(n + 1, st ^ 1);
      rt::cp_async_commit();
      // w.v in NP bf16 parts, [s][e] rows, the B operand of the update
      const float* ww = gs + 3 * QP;
      for (int x = t; x < QP * (VD / 8); x += kThreads) {  // 16-byte pieces
        const int s = x / (VD / 8), c = x - s * (VD / 8);
        float f[8];
#pragma unroll
        for (int p = 0; p < NQ; ++p) {
          const uint4 u = *at(vpl(st, p), s, c);
          const uint32_t uw[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 e = unpack_bf16x2(uw[j]);
            f[2 * j] = p ? f[2 * j] + e.x : e.x;
            f[2 * j + 1] = p ? f[2 * j + 1] + e.y : e.y;
          }
        }
        const float wsc = ww[s];
        uint32_t part[4][NP];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          rt::split_bf16<NP>(f[2 * j] * wsc, f[2 * j + 1] * wsc, part[j]);
#pragma unroll
        for (int p = 0; p < NP; ++p)
          wvpl(p)[s * VSTR + c] =
              make_uint4(part[0][p], part[1][p], part[2][p], part[3][p]);
      }
      __syncthreads();        // the w.v parts are in
    }
    if (w == 0 && n + 1 < nc) gate_load(n + 1);

    if (t0 < Q) {
      const float* cum = gs;
      const float* ec = gs + QP;
      const float* iv = gs + 2 * QP;
      float acc[YN][4];
#pragma unroll
      for (int j = 0; j < YN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      // inter: exp(cum_t) q_t . h, h the state before this chunk
#pragma unroll
      for (int ks = 0; ks < KD / 16; ++ks) {
        uint32_t af[NQ][4];
#pragma unroll
        for (int p = 0; p < NQ; ++p)
          rt::ldmatrix_x4(af[p], at(qpl(st, p), t0 + 8 * (mi & 1) + r8,
                                    2 * ks + (mi >> 1)));
#pragma unroll
        for (int n2 = 0; n2 < YN / 2; ++n2) {
          uint32_t r[NP][4], b00[NP], b01[NP], b10[NP], b11[NP];
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            rt::ldmatrix_x4_trans(r[p], hpl(hb, p) +
                                            (16 * ks + 8 * (mi & 1) + r8) *
                                                VSTR +
                                            n0 + 2 * n2 + (mi >> 1));
            b00[p] = r[p][0], b01[p] = r[p][1], b10[p] = r[p][2],
            b11[p] = r[p][3];
          }
          rt::mma_parts<NQ, NP>(acc[2 * n2], af, b00, b01);
          rt::mma_parts<NQ, NP>(acc[2 * n2 + 1], af, b10, b11);
        }
      }
      const int ta = t0 + g, tb = ta + 8;
      const float eca = ec[ta], ecb = ec[tb];
#pragma unroll
      for (int j = 0; j < YN; ++j) {
        acc[j][0] *= eca, acc[j][1] *= eca;
        acc[j][2] *= ecb, acc[j][3] *= ecb;
      }
      // intra: the causal 16-column blocks of the gated scores, each
      // multiplied into v as soon as it is formed
      const float ca = cum[ta], cb_ = cum[tb];
      const bool ragged = t0 + 16 > Q;       // rows past Q in this tile
      // the raw scores q_t . k_s of column block cb
      auto scores = [&](int cb, float (&sc)[2][4]) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KD / 16; ++ks) {
          uint32_t af[NQ][4], r[NQ][4], b00[NQ], b01[NQ], b10[NQ], b11[NQ];
#pragma unroll
          for (int p = 0; p < NQ; ++p) {
            rt::ldmatrix_x4(af[p], at(qpl(st, p), t0 + 8 * (mi & 1) + r8,
                                      2 * ks + (mi >> 1)));
            rt::ldmatrix_x4(r[p], at(kpl(st, p), 16 * cb + 8 * (mi >> 1) + r8,
                                     2 * ks + (mi & 1)));
            b00[p] = r[p][0], b01[p] = r[p][1], b10[p] = r[p][2],
            b11[p] = r[p][3];
          }
          rt::mma_parts<NQ, NQ>(sc[0], af, b00, b01);
          rt::mma_parts<NQ, NQ>(sc[1], af, b10, b11);
        }
      };
      // acc += P v for column block cb, P its gated scores
      auto gated_pv = [&](int cb, const float (&sc)[2][4]) {
        // p[t][s] = (q_t . k_s) exp(cum_t - cum_s) i_s for s <= t < Q;
        // on the diagonal block and past Q selected to 0 (above the
        // diagonal exp overflows), never multiplied by a mask
        float pr[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int s = 16 * cb + 8 * nt + 2 * qd;
          const float2 cs = *reinterpret_cast<const float2*>(cum + s);
          const float2 is = *reinterpret_cast<const float2*>(iv + s);
          pr[nt][0] = sc[nt][0] * exp_of(ca - cs.x) * is.x;
          pr[nt][1] = sc[nt][1] * exp_of(ca - cs.y) * is.y;
          pr[nt][2] = sc[nt][2] * exp_of(cb_ - cs.x) * is.x;
          pr[nt][3] = sc[nt][3] * exp_of(cb_ - cs.y) * is.y;
          if (cb == rt_ || ragged) {
            pr[nt][0] = (s <= ta && ta < Q) ? pr[nt][0] : 0.f;
            pr[nt][1] = (s + 1 <= ta && ta < Q) ? pr[nt][1] : 0.f;
            pr[nt][2] = (s <= tb && tb < Q) ? pr[nt][2] : 0.f;
            pr[nt][3] = (s + 1 <= tb && tb < Q) ? pr[nt][3] : 0.f;
          }
        }
        // P as the A fragment of P v (its 16 columns are the k), NP parts
        uint32_t pa[NP][4];
        {
          uint32_t hx[4][NP];
          rt::split_bf16<NP>(pr[0][0], pr[0][1], hx[0]);
          rt::split_bf16<NP>(pr[0][2], pr[0][3], hx[1]);
          rt::split_bf16<NP>(pr[1][0], pr[1][1], hx[2]);
          rt::split_bf16<NP>(pr[1][2], pr[1][3], hx[3]);
#pragma unroll
          for (int p = 0; p < NP; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e) pa[p][e] = hx[e][p];
        }
#pragma unroll
        for (int n2 = 0; n2 < YN / 2; ++n2) {
          uint32_t r[NQ][4], b00[NQ], b01[NQ], b10[NQ], b11[NQ];
#pragma unroll
          for (int p = 0; p < NQ; ++p) {
            rt::ldmatrix_x4_trans(
                r[p], at(vpl(st, p), 16 * cb + 8 * (mi & 1) + r8,
                         n0 + 2 * n2 + (mi >> 1)));
            b00[p] = r[p][0], b01[p] = r[p][1], b10[p] = r[p][2],
            b11[p] = r[p][3];
          }
          rt::mma_parts<NP, NQ>(acc[2 * n2], pa, b00, b01);
          rt::mma_parts<NP, NQ>(acc[2 * n2 + 1], pa, b10, b11);
        }
      };
      // two column blocks at a time: their products are independent
      int cb = 0;
      for (; cb < rt_; cb += 2) {
        float s0[2][4], s1[2][4];
        scores(cb, s0);
        scores(cb + 1, s1);
        gated_pv(cb, s0);
        gated_pv(cb + 1, s1);
      }
      if (cb == rt_) {
        float s0[2][4];
        scores(cb, s0);
        gated_pv(cb, s0);
      }
      // y rows ta, tb: two columns a lane per 8-wide tile
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int tt = hf ? tb : ta;
        if (tt >= Q) continue;
        T* yr = yb + (int64_t)(n * Q + tt) * ys;
#pragma unroll
        for (int j = 0; j < YN; ++j) {
          const int col = 8 * (n0 + j) + 2 * qd;
          if (col + 1 < dv && even) {
            store_pair(yr + col, acc[j][2 * hf], acc[j][2 * hf + 1]);
          } else {
            if (col < dv) rt::store_out(yr + col, acc[j][2 * hf]);
            if (col + 1 < dv)
              rt::store_out(yr + col + 1, acc[j][2 * hf + 1]);
          }
        }
      }
    }

    // warp 0, whose row tile is the lightest, takes chunk n + 1's gates
    // while the others finish their tiles
    if (w == 0 && n + 1 < nc) gate_scan(gates + ((n + 1) & 1) * GF);
    if constexpr (kLean) __syncthreads();   // the state's parts are read

    // state: h = exp(total) h + sum_s k_s (x) (w_s v_s), the k^T operand by
    // ldmatrix.trans of the k rows
    {
      const float* ww = gs + 3 * QP;
      const float dec = gs[4 * QP + 1];
#pragma unroll
      for (int m = 0; m < kMtw; ++m)
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) hs[m][nn][e] *= dec;
      for (int ks = 0; ks < QP / 16; ++ks) {
        uint32_t b00[NP], b01[NP], b10[NP], b11[NP];
        if constexpr (!kLean) {
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            uint32_t r[4];
            rt::ldmatrix_x4_trans(r, wvpl(p) +
                                         (16 * ks + 8 * (mi & 1) + r8) *
                                             VSTR +
                                         2 * pair + (mi >> 1));
            b00[p] = r[0], b01[p] = r[1], b10[p] = r[2], b11[p] = r[3];
          }
        } else {
          // w v split here, for this warp's two column tiles
          const float2 wa = *reinterpret_cast<const float2*>(ww + 16 * ks +
                                                             2 * qd);
          const float2 wb = *reinterpret_cast<const float2*>(
              ww + 16 * ks + 8 + 2 * qd);
          uint32_t r[NQ][4];
#pragma unroll
          for (int p = 0; p < NQ; ++p)
            rt::ldmatrix_x4_trans(
                r[p], at(vpl(st, p), 16 * ks + 8 * (mi & 1) + r8,
                         2 * pair + (mi >> 1)));
          uint32_t bp[4][NP];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float2 x = unpack_bf16x2(r[0][j]);
#pragma unroll
            for (int p = 1; p < NQ; ++p) {
              const float2 u = unpack_bf16x2(r[p][j]);
              x.x += u.x, x.y += u.y;
            }
            const float2 wj = (j & 1) ? wb : wa;
            rt::split_bf16<NP>(x.x * wj.x, x.y * wj.y, bp[j]);
          }
#pragma unroll
          for (int p = 0; p < NP; ++p)
            b00[p] = bp[0][p], b01[p] = bp[1][p], b10[p] = bp[2][p],
            b11[p] = bp[3][p];
        }
#pragma unroll
        for (int m = 0; m < kMtw; ++m) {
          uint32_t af[NQ][4];
#pragma unroll
          for (int p = 0; p < NQ; ++p)
            rt::ldmatrix_x4_trans(
                af[p], at(kpl(st, p), 16 * ks + 8 * (mi >> 1) + r8,
                          2 * (mt0 + m) + (mi & 1)));
          rt::mma_parts<NQ, NP>(hs[m][0], af, b00, b01);
          rt::mma_parts<NQ, NP>(hs[m][1], af, b10, b11);
        }
      }
    }
    if (n + 1 < nc) write_hparts(kLean ? 0 : hb ^ 1);
    if (states && n + 1 < nc) write_states(n + 1);
    if constexpr (kLean) {
      __syncthreads();        // every warp is done with the stage's rows
      if (n + 1 < nc) stage(n + 1, 0);
      rt::cp_async_commit();
    }
  }
  rt::cp_async_wait<0>();
#pragma unroll
  for (int m = 0; m < kMtw; ++m)
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 16 * (mt0 + m) + g + 8 * (e >> 1);
        const int col = 16 * pair + 8 * nn + 2 * qd + (e & 1);
        if (d < dk && col < dv)
          h_out[((int64_t)bh * dk + d) * dv + col] = hs[m][nn][e];
      }
}

// A tensor map over a bf16 operand (B, S, H, 64) with element strides
// (sb, ss, sh, 1) whose boxes are Q rows of one (b, h) in the 128-byte
// swizzle; without the H axis (rank 3) where sh == 0. False where the
// bulk copy engine cannot take it.
bool encode_rows(CUtensorMap* map, const void* p, int B, int S, int H,
                 int64_t sb, int64_t ss, int64_t sh, int Q, bool* rank4) {
  const auto encode = tensor_map_encoder();
  if (!encode || !rt::aligned16(p) || sb <= 0 || ss <= 0 || sh < 0 ||
      sb % 8 || ss % 8 || sh % 8)
    return false;
  *rank4 = sh != 0;
  const cuuint32_t rank = *rank4 ? 4 : 3;
  const cuuint64_t dims4[4] = {64, (cuuint64_t)H, (cuuint64_t)S,
                               (cuuint64_t)B};
  const cuuint64_t dims3[3] = {64, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides4[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                  (cuuint64_t)sb * 2};
  const cuuint64_t strides3[2] = {(cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box4[4] = {64, 1, (cuuint32_t)Q, 1};
  const cuuint32_t box3[3] = {64, (cuuint32_t)Q, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(p), *rank4 ? dims4 : dims3,
                *rank4 ? strides4 : strides3, *rank4 ? box4 : box3, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int KD, int VD, bool kLean, int kW,
          int kMinBlocks = 1>
cudaError_t launch_mma(const T* q, const T* k, const T* v, const float* a,
                       const float* gi, const float* h0, int B, int S, int H,
                       int dk, int dv, int Q, int64_t qsb, int64_t qss,
                       int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                       int64_t vsb, int64_t vss, int64_t vsh, T* y,
                       float* h_out, float* states, cudaStream_t stream) {
  using Sh = Tc<T, KD, VD, kLean, kW>;
  static_assert(Sh::kMtw >= 1, "state tiles");
  constexpr int64_t kMaxBytes = Sh::bytes(kMaxQ);
  static_assert(kMaxBytes <= kMaxSmem, "shared memory");
  static uint32_t raised = 0;     // devices where this kernel's limit is up
  cudaError_t err = rt::raise_smem_once(
      ssd_chunk_scan_mma<T, KD, VD, kLean, kW, kMinBlocks>, (int)kMaxBytes,
      raised);
  if (err != cudaSuccess) return err;
  // which operands may be staged with 16-byte copies
  constexpr int kVec = 16 / sizeof(T);
  auto fits = [&](const T* p, int64_t sb, int64_t ss, int64_t sh) {
    return rt::aligned16(p) && sb % kVec == 0 && ss % kVec == 0 &&
           sh % kVec == 0;
  };
  const int vec = (fits(q, qsb, qss, qsh) ? 1 : 0) |
                  (fits(k, ksb, kss, ksh) ? 2 : 0) |
                  (fits(v, vsb, vss, vsh) ? 4 : 0);
  // with two stages, tensor maps for the bulk copy engine where the rows
  // are 64 values and the operands' pointers and strides allow it: bit 0,
  // and bits 1, 2 for q, k with their own head axis
  CUtensorMap tmq{}, tmk{}, tmv{};
  int tma = 0;
  if (Sh::kSwz && dk == 64 && dv == 64) {
    bool q4, k4, v4;
    if (encode_rows(&tmq, q, B, S, H, qsb, qss, qsh, Q, &q4) &&
        encode_rows(&tmk, k, B, S, H, ksb, kss, ksh, Q, &k4) &&
        encode_rows(&tmv, v, B, S, H, vsb, vss, vsh, Q, &v4) && v4)
      tma = 1 | (q4 ? 2 : 0) | (k4 ? 4 : 0);
  }
  ssd_chunk_scan_mma<T, KD, VD, kLean, kW, kMinBlocks>
      <<<B * H, 32 * kW, Sh::bytes(round_up(Q, 16)), stream>>>(
          q, k, v, a, gi, h0, S, H, dk, dv, Q, qsb, qss, qsh, ksb, kss, ksh,
          vsb, vss, vsh, vec, tma, tmq, tmk, tmv, y, h_out, states);
  return cudaGetLastError();
}

// The tensor-core design, but for f32 at dk or dv > 64, whose three-part
// planes would not fit: two stages for bf16 at dk, dv <= 64, else one.
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* a, const float* gi, const float* h0,
                   int bf16, int B, int S, int H, int dk, int dv, int Q,
                   int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
                   int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
                   int64_t vsh, void* y, float* h_out, float* states,
                   cudaStream_t stream) {
  if (B < 1 || S < 1 || H < 1 || Q < 1 || Q > kMaxQ || S % Q != 0 ||
      dk < 1 || dk > kMaxD || dv < 1 || dv > kMaxD ||
      (int64_t)B * H > 0x7fffffff)
    return cudaErrorInvalidValue;
  const bool narrow = dk <= 64 && dv <= 64;
#define REPRO_SSD_ARGS(T)                                                    \
  static_cast<const T*>(q), static_cast<const T*>(k),                        \
      static_cast<const T*>(v), a, gi, h0, B, S, H, dk, dv, Q, qsb, qss, qsh, \
      ksb, kss, ksh, vsb, vss, vsh, static_cast<T*>(y), h_out, states,      \
      stream
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (bf16 && narrow)
    err = launch_mma<bf, 64, 64, false, 8>(REPRO_SSD_ARGS(bf));
  else if (bf16)
    err = launch_mma<bf, 128, 128, true, 16>(REPRO_SSD_ARGS(bf));
  else if (narrow)
    err = launch_mma<float, 64, 64, true, 8>(REPRO_SSD_ARGS(float));
  else
    err = launch_tile<float, 128, 128, 16>(REPRO_SSD_ARGS(float));
#undef REPRO_SSD_ARGS
  return err;
}

}  // namespace

// q, k: (B, S, H, dk), v: (B, S, H, dv), with element strides (sb, ss, sh,
// 1) each (a head stride may be 0); dtype f32 (bf16 == 0) or bf16
// (bf16 == 1) for all three and for y (B, S, H, dv) contiguous. a, i:
// (B, S, H) f32 contiguous. h0: (B, H, dk, dv) f32 contiguous, or null for
// a zero initial state; h_out: (B, H, dk, dv) f32, the final state;
// states: (B, S / chunk, H, dk, dv) f32, the state before each chunk (what
// the backward, ssd_scan_bwd.cu, reads), or null when no gradient is
// wanted. S % chunk == 0, chunk <= 128, dk, dv <= 128. Returns a
// cudaError_t.
extern "C" int repro_ssd_scan(const void* q, const void* k, const void* v,
                              const float* a, const float* i,
                              const float* h0, int bf16, int B, int S, int H,
                              int dk, int dv, int chunk, long long qsb,
                              long long qss, long long qsh, long long ksb,
                              long long kss, long long ksh, long long vsb,
                              long long vss, long long vsh, void* y,
                              float* h_out, float* states, void* stream) {
  return launch(q, k, v, a, i, h0, bf16, B, S, H, dk, dv, chunk, qsb, qss,
                qsh, ksb, kss, ksh, vsb, vss, vsh, y, h_out, states,
                static_cast<cudaStream_t>(stream));
}
