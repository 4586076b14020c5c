// K5: sliding-window single-token decode attention with grouped KV heads.
//
// Replaces the Pallas kernel src/repro/kernels/swa_decode.py:_kernel
// (wrapped by swa_decode): for each sequence b and KV head kv, the G = H/KV
// query rows q[b, kv*G + g] * hd^-0.5 attend over the cache slots
// max(cur - window + 1, 0) <= pos <= cur of k/v[b, :, kv], with the
// softmax in f32 and the output in the input dtype.
//
// Bound on the H100: bytes. Each cache slot costs 4*G*hd flops against
// 2*hd*elt bytes of K and V (G = 4 flops per byte at danube's bf16 shape).
// The flops are few, but on the ordinary cores each multiply-add also costs
// a shared-memory load and a bf16 unpack: a design that did the products
// there was bound by instructions, not bytes (each of its three phases,
// scores, softmax and p.v, cost about as much time as streaming the window
// did), because the eight warps per SM that the grid gives cannot hide
// those chains. So the products run on the tensor cores (mma.sync
// m16n8k16, f32 accumulators), with the G <= 16 query rows of a KV head as
// the 16 rows of the A tile. Operands that are not bf16 are split into a
// sum of bf16 parts: with bf16 caches q and p in two (two products per
// tile), with f32 caches q, k, p and v in three, the products of parts
// i + j < 3 taken (six), so the scores and p.v sums keep about f32's 24
// bits.
//
// Design: one launch. The window is cut into nchunks <= 8 chunks (a
// multiple of 64 slots; the host's plan), one block each per (b, kv). In a
// block each of the 4 warps takes every
// 4th 16-slot tile of the chunk and streams it through its own ring of
// kStages stages in shared memory with 16-byte cp.async (the slots past the
// window are zero-filled), so a warp never waits on another: per tile it
// forms S = q k^T (ldmatrix of the K rows), keeps a running max m and sum l
// per query row in registers, rescales its p.v accumulators by
// exp(m_prev - m_new), and adds P v (ldmatrix.trans of the V rows). At the
// end the block combines its 4 warps in warp order into a partial
// (m, l, acc[G][hd]), writes it to a small scratch buffer (0.7 MB at
// danube's serve shape, against 42 MB of K and V) and counts its arrival
// on its (b, kv)'s int counter (rt::last_to_arrive, which sets it back to
// 0 for the next launch); the block that arrives last reads every chunk's
// partial, combines them in chunk order whatever the order of arrival and
// writes `out` in q's dtype. One chunk writes `out` at once. No second
// launch.
//
// The chunks of one (b, kv) were first a thread block cluster combined
// through distributed shared memory; at the serve shape the cluster launch
// alone cost about a quarter of the kernel's time in bf16 (more in f32),
// more than the partials' round trip through L2 costs.
//
// The caches are read where they lie, in the (B, S, KV, hd) layer view of
// the stacked cache, through the strides the host passes: no copy to a
// (B, KV, S, hd) layout, no padding of hd in device memory, and no
// alignment of S to a block: only the slots in the window are visited. The
// ring's rows are an odd number of 16-byte pieces apart, so ldmatrix's
// eight row reads hit distinct banks. Every sum has one fixed order and
// there are no float atomics, so two launches on the same inputs give the
// same bits.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kSwaThreads = 32 * kWarps;
constexpr int kSlots = 16;       // slots per warp tile (one mma k-step of P v)
constexpr int kMaxChunks = 8;    // chunks (blocks) of one (b, kv)
constexpr int kMaxG = 16;        // query rows per KV head: the mma's 16 rows

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

// Shapes and shared memory of one instantiation, sizes in bytes. kQ, kK:
// bf16 parts of q and p, of k and v. A ring row (one slot's K or V row) is
// kStride 16-byte pieces: hd's pieces, rounded up to an odd count. The
// ring holds kStages tiles of K and V per warp: 3 where the block then
// stays within ~73 KB, so that three blocks fit on an SM, else 2. After
// the last tile it holds the warps' partials m, l [kWarps][16] and
// o [kWarps][16][HD] f32, and in the block that combines the chunks, every
// chunk's partial. Before it: during the tiles the query's A fragments
// [HD/16][32 lanes][kQ parts][4] u32, after them the block's partial
// m, l [16] and acc [16][HD] f32.
template <typename T, int HD>
struct Shape {
  static constexpr int kQ = sizeof(T) == 2 ? 2 : 3;
  static constexpr int kK = sizeof(T) == 2 ? 1 : 3;
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kPieces = HD / kVec;
  static constexpr int kStride = kPieces | 1;
  static constexpr int kTileBytes = 2 * kSlots * kStride * 16;   // K and V
  static constexpr int kFragBytes = (HD / 16) * 32 * kQ * 16;
  static constexpr int kBlockBytes = 16 * (2 + HD) * 4;
  static constexpr int kRing =
      kFragBytes > kBlockBytes ? kFragBytes : kBlockBytes;
  static constexpr int kStages =
      kRing + kWarps * 3 * kTileBytes <= 73 * 1024 ? 3 : 2;
  static constexpr int kRingBytes = kWarps * kStages * kTileBytes;
  static constexpr int kWarpPart = kWarps * 16 * (2 + HD) * 4;
  static constexpr int kChunkParts = kMaxChunks * (32 + kMaxG * HD) * 4;
  static constexpr int kAfter =
      kWarpPart > kChunkParts ? kWarpPart : kChunkParts;
  static constexpr int kBytes =
      kRing + (kRingBytes > kAfter ? kRingBytes : kAfter);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kSwaThreads)
swa_decode_chunks(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, int H, int KV, int G, int64_t sb,
                  int64_t ss, int64_t sh, int lo, int hi, int chunk,
                  float scale, int* __restrict__ count,
                  float* __restrict__ part, T* __restrict__ out) {
  using Sh = Shape<T, HD>;
  constexpr int kVec = Sh::kVec, kPieces = Sh::kPieces;
  constexpr int kStride = Sh::kStride, kStages = Sh::kStages;
  constexpr int kQ = Sh::kQ, kK = Sh::kK;
  constexpr int KS = HD / 16;      // k-steps of q k^T
  constexpr int DT = HD / 8;       // 8-wide column tiles of P v
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* qf = reinterpret_cast<uint4*>(smem);         // during the tiles
  float* m_s = reinterpret_cast<float*>(smem);        // after them
  float* l_s = m_s + 16;
  float* acc_s = l_s + 16;
  uint4* ring = reinterpret_cast<uint4*>(smem + Sh::kRing);
  float* wm = reinterpret_cast<float*>(smem + Sh::kRing);   // after the ring
  float* wl = wm + kWarps * 16;
  float* wo = wl + kWarps * 16;

  const int c = blockIdx.x, nchunks = gridDim.x;
  const int bk = blockIdx.y;
  const int b = bk / KV, kv = bk % KV;
  const int p0 = lo + c * chunk;
  const int n = min(chunk, hi - p0 + 1);
  const int ntiles = (n + kSlots - 1) / kSlots;
  const T* kb = k + b * sb + kv * sh + p0 * ss;
  const T* vb = v + b * sb + kv * sh + p0 * ss;
  const T* qb = q + ((int64_t)b * H + (int64_t)kv * G) * HD;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;

  // this warp's tiles: w, w + kWarps, ...; its ring stage i % kStages
  uint4* wring = ring + w * kStages * (Sh::kTileBytes / 16);
  const int nmine = (ntiles - w + kWarps - 1) / kWarps;
  auto issue = [&](int i) {
    if (i < nmine) {
      const int j0 = (w + i * kWarps) * kSlots;
      uint4* dst = wring + (i % kStages) * (Sh::kTileBytes / 16);
#pragma unroll 2
      for (int idx = lane; idx < 2 * kSlots * kPieces; idx += 32) {
        const int which = idx / (kSlots * kPieces);
        const int r = idx - which * kSlots * kPieces;
        const int j = r / kPieces, e = r - j * kPieces;
        const bool valid = j0 + j < n;
        const T* src = (which ? vb : kb) +
                       (valid ? (int64_t)(j0 + j) * ss + e * kVec : 0);
        cp_async16_zfill(dst + (which * kSlots + j) * kStride + e, src,
                             valid ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  // q's A fragments, scaled, in kQ bf16 parts: entry (ks, ln) holds rows
  // ln/4 and ln/4 + 8, columns 16 ks + 2 (ln % 4) + {0, 1} and + 8
  for (int i = t; i < KS * 32; i += kSwaThreads) {
    const int ks = i / 32, ln = i % 32;
    float x[8];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int g = ln / 4 + (h & 1) * 8;
      const int col = 16 * ks + 2 * (ln % 4) + (h >> 1) * 8;
      x[2 * h] = g < G ? rt::to_f32(qb[g * HD + col]) * scale : 0.f;
      x[2 * h + 1] = g < G ? rt::to_f32(qb[g * HD + col + 1]) * scale : 0.f;
    }
    uint32_t a[4][kQ];
#pragma unroll
    for (int h = 0; h < 4; ++h) split_bf16<kQ>(x[2 * h], x[2 * h + 1], a[h]);
#pragma unroll
    for (int pq = 0; pq < kQ; ++pq)
      qf[i * kQ + pq] = make_uint4(a[0][pq], a[1][pq], a[2][pq], a[3][pq]);
  }
  __syncthreads();

  // per lane: rows r0 = lane/4 and r1 = r0 + 8 of the 16 query rows
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int quad = lane % 4;

  for (int i = 0; i < nmine; ++i) {
    __syncwarp();                 // stage (i - 1) % kStages is consumed
    issue(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();                 // every lane's copies of tile i are in
    const uint4* kt = wring + (i % kStages) * (Sh::kTileBytes / 16);
    const uint4* vt = kt + kSlots * kStride;
    const int nv = min(kSlots, n - (w + i * kWarps) * kSlots);

    // S = q k^T over the tile's 16 slots: s[nt] covers slots 8 nt + ...
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[kQ][4];
#pragma unroll
      for (int pq = 0; pq < kQ; ++pq) {
        const uint4 x = qf[(ks * 32 + lane) * kQ + pq];
        a[pq][0] = x.x;
        a[pq][1] = x.y;
        a[pq][2] = x.z;
        a[pq][3] = x.w;
      }
      if constexpr (sizeof(T) == 2) {
        // matrix m = lane / 8: slots 8 (m / 2) + lane % 8, piece 2 ks + m % 2
        uint32_t r[4];
        const int m = lane / 8;
        ldmatrix_x4(r, kt + (8 * (m / 2) + lane % 8) * kStride + 2 * ks +
                           m % 2);
        const uint32_t b00[1] = {r[0]}, b01[1] = {r[1]};
        const uint32_t b10[1] = {r[2]}, b11[1] = {r[3]};
        mma_parts<kQ, 1>(s[0], a, b00, b01);
        mma_parts<kQ, 1>(s[1], a, b10, b11);
      } else {
        const float* kf = reinterpret_cast<const float*>(kt);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float* row = kf + (8 * nt + lane / 4) * kStride * 4 +
                             16 * ks + 2 * quad;
          const float2 x = *reinterpret_cast<const float2*>(row);
          const float2 y = *reinterpret_cast<const float2*>(row + 8);
          uint32_t b0[kK], b1[kK];
          split_bf16<kK>(x.x, x.y, b0);
          split_bf16<kK>(y.x, y.y, b1);
          mma_parts<kQ, kK>(s[nt], a, b0, b1);
        }
      }
    }
    // slots past the window: -inf (their rows were zero-filled)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * nt + 2 * quad + (e & 1) >= nv) s[nt][e] = -INFINITY;

    // running softmax of rows r0 (e = 0, 1) and r1 (e = 2, 3); a row's
    // four lanes hold its 16 slots, so its max takes two quad shuffles
    float x0 = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
    float x1 = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, off));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
    }
    const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
    const float a0 = expf(m0 - n0), a1 = expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    float p[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      p[nt][0] = expf(s[nt][0] - n0);
      p[nt][1] = expf(s[nt][1] - n0);
      p[nt][2] = expf(s[nt][2] - n1);
      p[nt][3] = expf(s[nt][3] - n1);
    }
    l0 = l0 * a0 + ((p[0][0] + p[0][1]) + (p[1][0] + p[1][1]));
    l1 = l1 * a1 + ((p[0][2] + p[0][3]) + (p[1][2] + p[1][3]));
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= a0;
      o[d][1] *= a0;
      o[d][2] *= a1;
      o[d][3] *= a1;
    }
    // P as the A fragment of P v (slots are its k), in kQ bf16 parts
    uint32_t pa[kQ][4];
    {
      uint32_t h[4][kQ];
      split_bf16<kQ>(p[0][0], p[0][1], h[0]);
      split_bf16<kQ>(p[0][2], p[0][3], h[1]);
      split_bf16<kQ>(p[1][0], p[1][1], h[2]);
      split_bf16<kQ>(p[1][2], p[1][3], h[3]);
#pragma unroll
      for (int pq = 0; pq < kQ; ++pq)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[pq][e] = h[e][pq];
    }

    // o += P v, two 8-wide column tiles of v per step
#pragma unroll
    for (int d = 0; d < DT; d += 2) {
      if constexpr (sizeof(T) == 2) {
        // matrix m = lane / 8: slots 8 (m % 2) + lane % 8, piece d + m / 2
        uint32_t r[4];
        const int m = lane / 8;
        ldmatrix_x4_trans(r, vt + (8 * (m % 2) + lane % 8) * kStride + d +
                                 m / 2);
        const uint32_t b00[1] = {r[0]}, b01[1] = {r[1]};
        const uint32_t b10[1] = {r[2]}, b11[1] = {r[3]};
        mma_parts<kQ, 1>(o[d], pa, b00, b01);
        mma_parts<kQ, 1>(o[d + 1], pa, b10, b11);
      } else {
        const float* vf = reinterpret_cast<const float*>(vt);
        const int rs = kStride * 4;       // floats from one slot to the next
#pragma unroll
        for (int dd = 0; dd < 2; ++dd) {
          const float* col = vf + (2 * quad) * rs + 8 * (d + dd) + lane / 4;
          uint32_t b0[kK], b1[kK];
          split_bf16<kK>(col[0], col[rs], b0);
          split_bf16<kK>(col[8 * rs], col[9 * rs], b1);
          mma_parts<kQ, kK>(o[d + dd], pa, b0, b1);
        }
      }
    }
  }
  cp_async_wait<0>();         // only empty groups remain
  // a row's sum over its four lanes (each lane's own order, then pairs)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  __syncthreads();                // every warp is done with ring and qf

  // the warps' partials, then the block's: warps combined in warp order
  const int r0 = lane / 4;
  if (quad == 0) {
    wm[w * 16 + r0] = m0;
    wm[w * 16 + r0 + 8] = m1;
    wl[w * 16 + r0] = l0;
    wl[w * 16 + r0 + 8] = l1;
  }
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      wo[(w * 16 + r0 + (e >> 1) * 8) * HD + 8 * d + 2 * quad + (e & 1)] =
          o[d][e];
  __syncthreads();
  for (int i = t; i < G * HD; i += kSwaThreads) {
    const int g = i / HD;
    float M = -INFINITY;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) M = fmaxf(M, wm[u * 16 + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) {
      const float f = expf(wm[u * 16 + g] - M);
      L += wl[u * 16 + g] * f;
      A += wo[u * 16 * HD + i] * f;
    }
    acc_s[i] = A;
    if (i % HD == 0) {
      m_s[g] = M;
      l_s[g] = L;
    }
  }
  __syncthreads();
  // out is (B, H, hd) contiguous: (b, kv, g) is row bk*G + g
  T* ob = out + (int64_t)bk * G * HD;
  if (nchunks == 1) {
    for (int i = t; i < G * HD; i += kSwaThreads)
      store_out(ob + i, acc_s[i] / fmaxf(l_s[i / HD], 1e-30f));
    return;
  }
  // publish this chunk's partial [m 16][l 16][acc G*HD]; the last chunk of
  // (b, kv) to arrive combines them all
  const int pw = 32 + G * HD;
  float* mine = part + ((int64_t)bk * nchunks + c) * pw;
  for (int i = t; i < pw; i += kSwaThreads) mine[i] = m_s[i];
  if (!rt::last_to_arrive(count + bk, nchunks)) return;

  // stage every chunk's partial in the (now free) ring in one round of
  // 16-byte copies from L2, then out = sum_c e^(m_c - M) acc_c /
  // sum_c e^(m_c - M) l_c in chunk order, M = max_c m_c
  float* all = reinterpret_cast<float*>(smem + Sh::kRing);
  const uint4* pb = reinterpret_cast<const uint4*>(
      part + (int64_t)bk * nchunks * pw);
  for (int j = t; j < nchunks * pw / 4; j += kSwaThreads)
    cp_async16_zfill(reinterpret_cast<uint4*>(all) + j, pb + j, 16);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int i = t; i < G * HD; i += kSwaThreads) {
    const int g = i / HD;
    float M = -INFINITY;
    for (int cc = 0; cc < nchunks; ++cc) M = fmaxf(M, all[cc * pw + g]);
    float L = 0.f, A = 0.f;
    for (int cc = 0; cc < nchunks; ++cc) {
      const float f = expf(all[cc * pw + g] - M);
      L += all[cc * pw + 16 + g] * f;
      A += all[cc * pw + 32 + i] * f;
    }
    store_out(ob + i, A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const T* q, const T* k, const T* v, int B, int H,
                      int KV, int64_t sb, int64_t ss, int64_t sh, int lo,
                      int cur, int chunk, int nchunks, int* count,
                      float* part, T* out, cudaStream_t stream) {
  using Sh = Shape<T, HD>;
  static_assert(Sh::kBytes <= 227 * 1024, "shared memory");
  static uint32_t raised = 0;     // devices where this kernel's limit is up
  cudaError_t err = raise_smem_once(swa_decode_chunks<T, HD>,
                                        Sh::kBytes, raised);
  if (err != cudaSuccess) return err;
  swa_decode_chunks<T, HD><<<dim3(nchunks, B * KV), kSwaThreads, Sh::kBytes,
                             stream>>>(q, k, v, H, KV, H / KV, sb, ss, sh, lo,
                                       cur, chunk, 1.f / sqrtf((float)HD),
                                       count, part, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, int B, int H,
                   int KV, int hd, int64_t sb, int64_t ss, int64_t sh,
                   int cur, int window, int S, int chunk, int nchunks,
                   int* count, float* part, void* out, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (B < 1 || KV < 1 || H < KV || H % KV != 0 || H / KV > kMaxG ||
      cur < 0 || cur >= S || window < 1 || sb % kVec || ss % kVec ||
      sh % kVec || !rt::aligned16(q) || !rt::aligned16(k) ||
      !rt::aligned16(v) || (nchunks > 1 && (!count || !part)))
    return cudaErrorInvalidValue;
  // the plan: nchunks chunks of `chunk` slots, whole warp tiles, none empty
  const int lo = max(cur - window + 1, 0);
  const int n = cur - lo + 1;
  if (chunk < 1 || chunk % kSlots != 0 || nchunks < 1 ||
      nchunks > kMaxChunks || (int64_t)(nchunks - 1) * chunk >= n ||
      (int64_t)nchunks * chunk < n)
    return cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
#define REPRO_SWA_HD(HD)                                                    \
  if (hd == HD)                                                             \
  return launch_hd<T, HD>(qt, kt, vt, B, H, KV, sb, ss, sh, lo, cur, chunk, \
                          nchunks, count, part, ot, stream)
  REPRO_SWA_HD(32);
  REPRO_SWA_HD(64);
  REPRO_SWA_HD(80);
  REPRO_SWA_HD(128);
#undef REPRO_SWA_HD
  return cudaErrorInvalidValue;   // a head width the kernel is not built for
}

}  // namespace

// q: (B, H, hd) contiguous; k, v: (B, S, KV, hd) with element strides
// (sb, ss, sh, 1), both the same; dtype f32 (bf16 == 0) or bf16 (bf16 == 1)
// for all three and for out (B, H, hd); hd one of 32, 64, 80, 128.
// The plan (kernels/swa_decode.py plan): the window's slots in nchunks <= 8
// chunks of `chunk` slots, a multiple of 16, none empty. With nchunks > 1:
// count, (B*KV,) int, all 0 (and 0 again when the kernel ends), and part,
// (B*KV, nchunks, 32 + G*hd) f32 scratch; only one launch at a time may
// use them. Returns a cudaError_t.
extern "C" int repro_swa_decode(const void* q, const void* k, const void* v,
                                int bf16, int B, int H, int KV, int hd,
                                long long sb, long long ss, long long sh,
                                int cur, int window, int S, int chunk,
                                int nchunks, int* count, float* part,
                                void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, B, H, KV, hd, sb, ss, sh, cur,
                                 window, S, chunk, nchunks, count, part, out,
                                 st);
  return launch<float>(q, k, v, B, H, KV, hd, sb, ss, sh, cur, window, S,
                       chunk, nchunks, count, part, out, st);
}
