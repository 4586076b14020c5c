// K5: sliding-window single-token decode attention with grouped KV heads.
//
// Replaces the Pallas kernel src/repro/kernels/swa_decode.py:_kernel
// (wrapped by swa_decode): for each sequence b and KV head kv, the G = H/KV
// query rows q[b, kv*G + g] * hd^-0.5 attend over the cache slots
// max(cur - window + 1, 0) <= pos <= cur of k/v[b, :, kv], with the
// softmax in f32 and the output in the input dtype.
//
// Bound on the H100: bytes. Each cache slot costs 4*G*hd flops against
// 2*hd*elt bytes of K and V: G = 4 flops per byte at danube's bf16 shape,
// far below the ~20 flops per byte of f32 outside the tensor cores, so the
// kernel streams rows with 16-byte loads and does its arithmetic in f32 on
// the ordinary cores (G = 4 rows are far below a tensor-core tile).
//
// Design (flash-decoding): the window is cut into chunks of `chunk` slots.
// Block (c, b*KV + kv) reads its chunk's K rows once (one thread per slot),
// keeps the G x chunk scores in shared memory, takes their max and
// exp-sum per query row, then reads the chunk's V rows (a row's 16-byte
// pieces across threads, slots across thread groups) and writes its partial
// (m, l, acc[G][hd]) to a buffer. A second launch combines the chunks of
// each (b, kv) in chunk order. At danube's decode shape (B = 4, KV = 8,
// window 4096, chunk 256) that is 16 x 32 = 512 blocks for 132 SMs, where
// one block per (b, kv) would leave 100 SMs idle.
//
// The caches are read where they lie, in the (B, S, KV, hd) layer view of
// the stacked cache, through the strides the host passes: no copy to a
// (B, KV, S, hd) layout, no padding of hd to 128 (an 80-wide bf16 row is
// ten 16-byte loads), and no alignment of S to a block: only the slots in
// the window are visited. Every sum has one fixed order and there are no
// atomics, so two launches on the same inputs give the same bits.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kSwaThreads = 128;
constexpr int kMaxG = 16;      // query rows per KV head
constexpr int kMaxHd = 256;

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Shared memory of swa_partial, in floats: the scaled q rows [MG][hd], the
// scores [MG][chunk], the PV partial sums [groups][MG][hd], and m, l [MG].
inline int partial_smem_floats(int MG, int hd, int chunk, int groups) {
  return MG * hd + MG * chunk + groups * MG * hd + 2 * MG;
}

template <typename T, int MG>
__global__ void __launch_bounds__(kSwaThreads)
swa_partial(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, int H, int KV, int G, int hd,
            int64_t sb, int64_t ss, int64_t sh, int lo, int hi, int chunk,
            float scale, float* __restrict__ m_part,
            float* __restrict__ l_part, float* __restrict__ acc_part) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ float smem[];
  const int nvec = hd / kVec;               // 16-byte pieces of a row
  const int groups = kSwaThreads / nvec;    // slot groups of the PV pass
  float* q_s = smem;
  float* p_s = q_s + MG * hd;
  float* red = p_s + MG * chunk;
  float* stat = red + groups * MG * hd;

  const int c = blockIdx.x, bk = blockIdx.y;
  const int b = bk / KV, kv = bk % KV;
  const int p0 = lo + c * chunk;
  const int n = min(chunk, hi - p0 + 1);
  const T* kb = k + b * sb + kv * sh;
  const T* vb = v + b * sb + kv * sh;
  const T* qb = q + ((int64_t)b * H + (int64_t)kv * G) * hd;
  const int t = threadIdx.x;

  // the group's query rows, scaled, in f32; rows g >= G are zero
  for (int i = t; i < MG * hd; i += kSwaThreads)
    q_s[i] = i < G * hd ? rt::to_f32(qb[i]) * scale : 0.f;
  __syncthreads();

  // scores: one thread per slot, the K row in 16-byte loads
  for (int j = t; j < n; j += kSwaThreads) {
    const T* row = kb + (int64_t)(p0 + j) * ss;
    float s[MG];
#pragma unroll
    for (int g = 0; g < MG; ++g) s[g] = 0.f;
#pragma unroll 4
    for (int e = 0; e < nvec; ++e) {
      float kf[kVec];
      rt::load_f32<T, kVec>(row + e * kVec, kf);
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        const float* qr = q_s + g * hd + e * kVec;
#pragma unroll
        for (int i = 0; i < kVec; ++i) s[g] += qr[i] * kf[i];
      }
    }
#pragma unroll
    for (int g = 0; g < MG; ++g) p_s[g * chunk + j] = s[g];
  }
  __syncthreads();

  // per query row: max over the chunk, then p = exp(s - m) and l = sum p
  const int lane = t & 31, warp = t >> 5;
  for (int g = warp; g < G; g += kSwaThreads / 32) {
    float* pr = p_s + g * chunk;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, pr[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      l += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      stat[g] = m;
      stat[MG + g] = l;
    }
  }
  __syncthreads();

  // acc[g][:] = sum_j p[g][j] * v[j][:]: thread (grp, e) owns the e-th
  // 16-byte piece of the rows j = grp, grp + groups, ...
  if (t < groups * nvec) {
    const int e = t % nvec, grp = t / nvec;
    float acc[MG][kVec];
#pragma unroll
    for (int g = 0; g < MG; ++g)
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[g][i] = 0.f;
#pragma unroll 4
    for (int j = grp; j < n; j += groups) {
      float vf[kVec];
      rt::load_f32<T, kVec>(vb + (int64_t)(p0 + j) * ss + e * kVec, vf);
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        const float p = p_s[g * chunk + j];
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[g][i] += p * vf[i];
      }
    }
#pragma unroll
    for (int g = 0; g < MG; ++g)
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        red[(grp * MG + g) * hd + e * kVec + i] = acc[g][i];
  }
  __syncthreads();

  // this chunk's partial: the thread groups' sums in group order
  const int64_t part = (int64_t)bk * gridDim.x + c;
  for (int i = t; i < G * hd; i += kSwaThreads) {
    const int g = i / hd, d = i - g * hd;
    float a = 0.f;
    for (int r = 0; r < groups; ++r) a += red[(r * MG + g) * hd + d];
    acc_part[part * G * hd + i] = a;
  }
  if (t < G) {
    m_part[part * G + t] = stat[t];
    l_part[part * G + t] = stat[MG + t];
  }
}

// out[b, kv*G + g, :] = sum_c e^(m_c - M) acc_c / sum_c e^(m_c - M) l_c over
// the chunks c of (b, kv) in chunk order, M = max_c m_c. out is (B, H, hd)
// contiguous, so (b, kv, g) is row bk*G + g.
template <typename T>
__global__ void __launch_bounds__(kSwaThreads)
swa_combine(const float* __restrict__ m_part,
            const float* __restrict__ l_part,
            const float* __restrict__ acc_part, int nchunks, int G, int hd,
            T* __restrict__ out) {
  const int64_t bk = blockIdx.x;
  for (int i = threadIdx.x; i < G * hd; i += kSwaThreads) {
    const int g = i / hd;
    const float* mp = m_part + bk * nchunks * G + g;
    const float* lp = l_part + bk * nchunks * G + g;
    const float* ap = acc_part + bk * nchunks * G * hd + i;
    float M = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < nchunks; ++c) M = fmaxf(M, mp[c * G]);
    float L = 0.f, A = 0.f;
#pragma unroll 8
    for (int c = 0; c < nchunks; ++c) {
      const float w = expf(mp[c * G] - M);
      L += lp[c * G] * w;
      A += ap[(int64_t)c * G * hd] * w;
    }
    store_out(out + bk * G * hd + i, A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int MG>
cudaError_t launch_mg(const T* q, const T* k, const T* v, int B, int H,
                      int KV, int hd, int64_t sb, int64_t ss, int64_t sh,
                      int cur, int window, int chunk, float* m_part,
                      float* l_part, float* acc_part, T* out,
                      cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int G = H / KV;
  const int lo = max(cur - window + 1, 0);
  const int nchunks = rt::cdiv(cur - lo + 1, chunk);
  const int groups = kSwaThreads / (hd / kVec);
  const size_t smem =
      sizeof(float) * partial_smem_floats(MG, hd, chunk, groups);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        swa_partial<T, MG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float scale = 1.f / sqrtf((float)hd);
  swa_partial<T, MG><<<dim3(nchunks, B * KV), kSwaThreads, smem, stream>>>(
      q, k, v, H, KV, G, hd, sb, ss, sh, lo, cur, chunk, scale, m_part,
      l_part, acc_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  swa_combine<T><<<B * KV, kSwaThreads, 0, stream>>>(
      m_part, l_part, acc_part, nchunks, G, hd, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, int B, int H,
                   int KV, int hd, int64_t sb, int64_t ss, int64_t sh,
                   int cur, int window, int S, int chunk, float* m_part,
                   float* l_part, float* acc_part, void* out,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (B < 1 || KV < 1 || H < KV || H % KV != 0 || H / KV > kMaxG ||
      hd < kVec || hd > kMaxHd || hd % kVec != 0 || cur < 0 || cur >= S ||
      window < 1 || chunk < 1 || sb % kVec || ss % kVec || sh % kVec ||
      !rt::aligned16(q) || !rt::aligned16(k) || !rt::aligned16(v))
    return cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  const int G = H / KV;
#define REPRO_SWA_MG(MG)                                                    \
  return launch_mg<T, MG>(qt, kt, vt, B, H, KV, hd, sb, ss, sh, cur, window, \
                          chunk, m_part, l_part, acc_part, ot, stream)
  if (G <= 1) REPRO_SWA_MG(1);
  if (G <= 2) REPRO_SWA_MG(2);
  if (G <= 4) REPRO_SWA_MG(4);
  if (G <= 8) REPRO_SWA_MG(8);
  REPRO_SWA_MG(16);
#undef REPRO_SWA_MG
}

}  // namespace

// q: (B, H, hd) contiguous; k, v: (B, S, KV, hd) with element strides
// (sb, ss, sh, 1), both the same; dtype f32 (bf16 == 0) or bf16 (bf16 == 1)
// for all three and for out (B, H, hd). m_part, l_part: (B*KV, nchunks, G)
// f32 scratch, acc_part: (B*KV, nchunks, G, hd) f32 scratch, with
// nchunks = ceil((cur - max(cur - window + 1, 0) + 1) / chunk).
// Returns a cudaError_t.
extern "C" int repro_swa_decode(const void* q, const void* k, const void* v,
                                int bf16, int B, int H, int KV, int hd,
                                long long sb, long long ss, long long sh,
                                int cur, int window, int S, int chunk,
                                float* m_part, float* l_part, float* acc_part,
                                void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, B, H, KV, hd, sb, ss, sh, cur,
                                 window, S, chunk, m_part, l_part, acc_part,
                                 out, st);
  return launch<float>(q, k, v, B, H, KV, hd, sb, ss, sh, cur, window, S,
                       chunk, m_part, l_part, acc_part, out, st);
}
