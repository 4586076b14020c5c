// K4's backward: the gradient of the SSD / decay-attention chunk scan.
//
// The TPU has no kernel here: the JAX package trains through XLA's autodiff
// of the jnp chunked_decay_attention (src/repro/models/ssm.py:45), while the
// port's forward is the kernel ssd_scan.cu, whose gradient therefore needs a
// kernel of its own. For each (b, h), by chunks of Q positions, with cum the
// chunk's inclusive cumsum of a, tot = cum_{Q-1}, L_ts = exp(cum_t - cum_s)
// (s <= t), w_s = exp(tot - cum_s) i_s, H_n the state before chunk n
// (written by the forward) and G_n the gradient of the state after it:
//   S_ts = q_t . k_s,  D_ts = dy_t . v_s,  P = S L i_s,  R = D L i_s
//   dq_t = sum_s R_ts k_s + exp(cum_t) H_n dy_t
//   dk_s = sum_t R_ts q_t + w_s G_n v_s
//   dv_s = sum_t P_ts dy_t + w_s G_n^T k_s
//   di_s = sum_t S_ts D_ts L_ts + exp(tot - cum_s) k_s^T G_n v_s
//   dcum = row sums - column sums of S D L i_s, + exp(cum_t) q_t . H_n dy_t
//          at t, - w_s k_s^T G_n v_s at s, + exp(tot) <H_n, G_n> +
//          sum_s w_s k_s^T G_n v_s at Q - 1;  da = reverse cumsum of dcum
//   G_{n-1} = exp(tot_n) G_n + X_n,  X_n = sum_t exp(cum_t) q_t dy_t^T,
//   G_{nc-1} = dh_final,  dh0 = G_{-1}
// (the plain version, ssd_scan.ssd_scan_bwd_ref, spells out the same).
//
// Bound on the H100: bytes. At zamba2-7b's training shape (B 4, S 512, H
// 112, dk = dv = 64, Q 128, bf16) the function needs 17.0 GFLOP against
// 195 MB of HBM bytes, ~87 flops a byte: below the bf16 tensor cores' ridge
// (295), so 0.0582 ms on the bytes (ssd_scan.bwd_bound); on the ordinary
// f32 cores the flops alone would take 0.254 ms.
//
// The tensor-core design (dk, dv <= 64, Q a multiple of 16; the dispatch's
// instantiations 0, bf16, and 1, f32), stage by stage:
//
// 1. The chunks in parallel. G's dependence between chunks is linear, so a
//    cluster of kC = 4 blocks serves one (b, h): block c takes the run of
//    chunks [c r, c r + r), r = ceil(nc / 4) (one chunk at the training
//    shape: 1,792 blocks where one block per (b, h) made 448). Each block
//    first forms its run's Y by Horner from zero (Y <- exp(tot_m) Y + X_m,
//    the last chunk first) and E, the product of exp(tot_m), publishes both
//    in its shared memory and arrives at a cluster barrier. It waits there
//    only after the work of its chunk that needs no G (stage 3), then reads
//    the later blocks' (E, Y) through distributed shared memory and forms
//    G after its run by the same Horner walk from dh_final, the last block
//    first. With one chunk a block (nc <= 4), Y = X_m and E = exp(tot_m)
//    exactly, so every block's G has the bits of a serial walk over the
//    chunks. The block then walks its run in reverse (restaging the rows
//    where r > 1), stepping G <- exp(tot_m) G + X_m; block 0 ends with
//    dh0. A second cluster barrier, waited on at the end, keeps each
//    block's shared memory alive until the others have read it.
// 2. Products on the tensor cores: mma.sync m16n8k16 on bf16 operands, f32
//    accumulators, operands by ldmatrix (.trans for the transposed ones)
//    from planes of the chunk's q, k, v and dy rows (bf16 rows of 64 in the
//    128-byte swizzle, piece c of row r at c ^ (r % 8)). bf16 q, k, v, dy
//    are exact operands; what is f32 by nature (P, R, H_n, G and exp(cum_t)
//    q_t) is split into NP bf16 parts, part j rounding what parts 0 .. j - 1
//    left (rt::split_bf16), and the part products i + j < NP are summed in
//    f32: two parts (~2^-17) for bf16 inputs. f32 inputs keep their rows as
//    f32 in shared memory (row stride 68 floats) and split q, k, v and dy
//    into three parts as a fragment is loaded, with three parts of the rest
//    (~2^-24). The decay is never factored as exp(cum_t) exp(-cum_s): |cum|
//    reaches ~900 at zamba2's gates. It is exp of the difference on each
//    element, selected to 0 above the diagonal (never an inf times a 0).
// 3. The triangles stay in registers, as FlashAttention-2's backward keeps
//    them. Warp w owns the 16-row tile w (w < 4) or 11 - w, so that the two
//    warps on one scheduler share the causal work evenly. As query
//    positions t it forms dq_t = exp(cum_t) H_n dy_t + R k over the blocks
//    s <= t, with D = dy v^T formed again for its rows rather than R
//    stored (beside f32 rows it would not fit). As key positions s, for
//    every block t >= s it forms S^T and D^T in accumulators, gates them
//    there into P^T and R^T and feeds those as A fragments straight into
//    dv_s += P^T dy and dk_s += R^T q, summing the columns of S D L along
//    its rows and writing the rows of S D L i_s, summed over its 16 s, to
//    shared memory. Neither needs G, and no barrier separates them. With G
//    in, it adds w_s G v_s and w_s G^T k_s, and assembles di_s and dcum for
//    its own rows (the tiles' row sums of G in tile order).
// 4. H_n and G once a chunk in shared memory, as NP bf16 planes for the
//    products. G's f32 value stays in the accumulator layout of the warps
//    that form it (warp w: rows 16 (w >> 1) .., columns 32 (w & 1) ..); the
//    forward's f32 states are read in that layout, outside any product
//    loop, once for their parts and once for <H_n, G>.
// 5. No serial tails: the chunk's cumsum and dcum's reverse cumsum are one
//    warp's shuffle scans over lane runs, <H_n, G> and sum_s w_s k^T G v are
//    butterfly shuffles and the warps' partials added in warp order. Four
//    block barriers a chunk, and two cluster barriers a block.
// The gates' loads go out first, then q and dy (one cp.async group), then
// k and v, which land while X_n is formed. bf16 output tiles of 64 columns
// leave through 2 KB of shared memory a warp as 16-byte stores, 8 lanes a
// row (4-byte stores of the accumulator pairs took ~11 % of the time).
//
// Measured at the training shape (NVIDIA H100 80GB HBM3, 700 W; `python -m
// repro_torch.tools.k4_bwd_designs`, PERF.md section 6): ~0.28 ms in bf16
// and ~0.81 ms in f32, against 3.17 and 3.19 ms for the first design. ptxas
// (-O3, sm_90a): bf16 249 registers, f32 255, no spills; 139,328 and
// 213,056 bytes of shared memory: one block of 8 warps an SM, and 30
// clusters of 4 at once (120 of the 132 SMs). Clusters of 2 (runs of two
// chunks, each staged twice, but all 132 SMs) take the same time, one
// block per (b, h) ~12 % more. Tried and not kept: 16 warps, two to a
// tile (one forming P and dv, the other R, dk and G's sums, dq split by
// columns), which duplicates S and D and spills at the 128-register cap;
// and the next block's S and D issued before this block's products.
// Both were slower (PERF.md section 6).
//
// The first design (instantiations 2-5) takes what the tensor-core design
// does not: dk or dv > 64, or Q not a multiple of 16. One block of 256
// threads per (b, h) walks the chunks in reverse; f32 FMAs in 4 x 4
// register tiles; the chunk's S and D as lower triangles in shared memory
// (S becomes P and D becomes R in place), with the chunk's rows in f32
// where they fit (2, 4), else read from global memory (3, 5); dH carried in
// dh0's buffer.
//
// No atomics in either design: every sum has one fixed order, and two
// launches on the same inputs give the same bits. q and k are read through
// their strides (a head stride of 0 reads one row for every head); dq and dk
// are written per head, and the caller sums them over the heads where q and
// k were shared.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxQ = 128;
constexpr int kMaxD = 128;
constexpr int kMaxSmem = 232448;

// -- the first design: f32 FMAs, one block per (b, h) ----------------------

constexpr int kThreads = 256;
constexpr int TM = 4, TN = 4;           // register tile of a product
constexpr int kVecs = 8;                // (Q,) vectors in shared memory

__host__ __device__ __forceinline__ int tri(int n) { return n * (n + 1) / 2; }

// Shared memory of one block, in floats: the two triangles, the vectors,
// one partial sum a thread, two (Q, ceil(dk / 4)) tables of partial
// sums, and with `staged` q, k (rows of dk + 1) and dy, v (rows of dv + 1).
inline int64_t smem_floats(int Q, int dk, int dv, bool staged) {
  const int64_t ndt = (dk + TN - 1) / TN;
  return 2 * (int64_t)tri(Q) + kVecs * Q + kThreads + 2 * Q * ndt +
         (staged ? (int64_t)Q * (2 * (dk + 1) + 2 * (dv + 1)) : 0);
}

// Rows s0 .. s0 + Q - 1 of one operand, row r at column c: staged in shared
// memory (f32, row stride ss) or read from global memory (row stride gs).
template <typename T, bool kStaged>
struct Rows {
  const float* s;
  int ss;
  const T* g;
  int64_t gs;
  __device__ __forceinline__ float operator()(int r, int c) const {
    if constexpr (kStaged)
      return s[r * ss + c];
    else
      return rt::to_f32(g[(int64_t)r * gs + c]);
  }
};

// acc[i][j] += sum_{kk in [k0, k1)} A(m0 + i, kk) B(kk, n0 + j), kk in
// order; A and B return 0 outside the operands.
template <class FA, class FB>
__device__ __forceinline__ void mac(float (&acc)[TM][TN], int m0, int n0,
                                    int k0, int k1, FA A, FB B) {
  for (int kk = k0; kk < k1; ++kk) {
    float x[TM], y[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) x[i] = A(m0 + i, kk);
#pragma unroll
    for (int j = 0; j < TN; ++j) y[j] = B(kk, n0 + j);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan_bwd(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ a,
                   const float* __restrict__ gi,
                   const float* __restrict__ states,
                   const T* __restrict__ dy,
                   const float* __restrict__ dh_final, int S, int H, int dk,
                   int dv, int Q, int64_t qsb, int64_t qss, int64_t qsh,
                   int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb,
                   int64_t vss, int64_t vsh, T* __restrict__ dq,
                   T* __restrict__ dk_out, T* __restrict__ dv_out,
                   float* __restrict__ da, float* __restrict__ di,
                   float* dh0) {
  extern __shared__ __align__(16) float smem[];
  const int nc = S / Q, nt = tri(Q);
  const int ndt = (dk + TN - 1) / TN, nvt = (dv + TN - 1) / TN;
  const int nq = (Q + TM - 1) / TM;
  float* Ps = smem;                 // [tri(Q)] S, then P = S L i_s
  float* Rs = Ps + nt;              // [tri(Q)] D, then R = D L i_s
  float* cum = Rs + nt;             // [Q] cumsum of a over the chunk
  float* ecum = cum + Q;            // exp(cum_t)
  float* iv = ecum + Q;             // i_s
  float* ew = iv + Q;               // exp(tot - cum_s)
  float* rowg = ew + Q;             // sum_s G_ts
  float* colsd = rowg + Q;          // sum_t S_ts D_ts L_ts
  float* dcum = colsd + Q;          // the gradient of cum_t
  float* wk = dcum + Q;             // w_s k_s^T dH v_s
  float* red = wk + Q;              // [kThreads] partials of <H_n, dH>
  float* part_q = red + kThreads;   // [Q][ndt] q_t . (exp(cum_t) H_n dy_t)
  float* part_k = part_q + Q * ndt; // [Q][ndt] k_s . (dH v_s)
  float* rows = part_k + Q * ndt;
  const int sk = dk + 1, sv = dv + 1;
  float* q_s = rows;
  float* k_s = q_s + Q * sk;
  float* dy_s = k_s + Q * sk;
  float* v_s = dy_s + Q * sv;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t gb = (int64_t)b * S * H + h;       // gates: (B, S, H)
  float* dH = dh0 + (int64_t)bh * dk * dv;         // dH, carried in place
  for (int x = t; x < dk * dv; x += kThreads)
    dH[x] = dh_final ? dh_final[(int64_t)bh * dk * dv + x] : 0.f;

  for (int n = nc - 1; n >= 0; --n) {
    const int s0 = n * Q;
    const float* Hn = states + ((int64_t)(b * nc + n) * H + h) * dk * dv;
    const Rows<T, kStaged> Aq{q_s, sk, q + b * qsb + h * qsh + s0 * qss, qss};
    const Rows<T, kStaged> Ak{k_s, sk, k + b * ksb + h * ksh + s0 * kss, kss};
    const Rows<T, kStaged> Av{v_s, sv, v + b * vsb + h * vsh + s0 * vss, vss};
    const Rows<T, kStaged> Ady{dy_s, sv, dy + (gb + (int64_t)s0 * H) * dv,
                               (int64_t)H * dv};
    __syncthreads();        // the previous chunk is done with smem and dH
    if constexpr (kStaged) {
      for (int x = t; x < Q * dk; x += kThreads) {
        const int r = x / dk, c = x - r * dk;
        q_s[r * sk + c] = rt::to_f32(Aq.g[(int64_t)r * qss + c]);
        k_s[r * sk + c] = rt::to_f32(Ak.g[(int64_t)r * kss + c]);
      }
      for (int x = t; x < Q * dv; x += kThreads) {
        const int r = x / dv, c = x - r * dv;
        v_s[r * sv + c] = rt::to_f32(Av.g[(int64_t)r * vss + c]);
        dy_s[r * sv + c] = rt::to_f32(Ady.g[(int64_t)r * H * dv + c]);
      }
    }
    if (t < Q) iv[t] = gi[gb + (int64_t)(s0 + t) * H];
    if (warp == 0) {
      // cumsum: lane l sums its run of E consecutive gates, a shuffle scan
      // adds the runs before it
      const int E = (Q + 31) / 32;
      const int lo = min(lane * E, Q), hi = min(lo + E, Q);
      float run = 0.f;
      for (int s = lo; s < hi; ++s) {
        run += a[gb + (int64_t)(s0 + s) * H];
        cum[s] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float nb = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += nb;
      }
      const float before = incl - run;
      for (int s = lo; s < hi; ++s) cum[s] += before;
    }
    __syncthreads();
    const float tot = cum[Q - 1], etot = expf(tot);
    if (t < Q) {
      ecum[t] = expf(cum[t]);
      ew[t] = expf(tot - cum[t]);
    }

    // S = q k^T and D = dy v^T over the lower triangle, 4 x 4 tiles
    for (int x = t; x < nq * nq; x += kThreads) {
      const int ti = x / nq, tj = x - ti * nq;
      if (tj > ti) continue;
      const int t0 = TM * ti, c0 = TN * tj;
      float sa[TM][TN], sd[TM][TN];
      zero(sa);
      zero(sd);
      mac(sa, t0, c0, 0, dk,
          [&](int r, int c) { return r < Q ? Aq(r, c) : 0.f; },
          [&](int kk, int c) { return c < Q ? Ak(c, kk) : 0.f; });
      mac(sd, t0, c0, 0, dv,
          [&](int r, int c) { return r < Q ? Ady(r, c) : 0.f; },
          [&](int kk, int c) { return c < Q ? Av(c, kk) : 0.f; });
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int tt = t0 + i, s = c0 + j;
          if (tt < Q && s <= tt) {
            Ps[tri(tt) + s] = sa[i][j];
            Rs[tri(tt) + s] = sd[i][j];
          }
        }
    }
    __syncthreads();

    // row t: sum_s G_ts; column s: sum_t S D L (G's column sum is i_s that)
    if (t < Q) {
      const float ct = cum[t];
      const float* ps = Ps + tri(t);
      const float* rs = Rs + tri(t);
      float r = 0.f;
      for (int s = 0; s <= t; ++s)
        r = fmaf(ps[s] * rs[s], expf(ct - cum[s]) * iv[s], r);
      rowg[t] = r;
    } else if (t < 2 * Q) {
      const int s = t - Q;
      const float cs = cum[s];
      float c = 0.f;
      for (int tt = s; tt < Q; ++tt)
        c = fmaf(Ps[tri(tt) + s] * Rs[tri(tt) + s], expf(cum[tt] - cs), c);
      colsd[s] = c;
    }
    __syncthreads();
    // P = S L i_s and R = D L i_s in place
    for (int tt = warp; tt < Q; tt += kThreads / 32) {
      const float ct = cum[tt];
      for (int s = lane; s <= tt; s += 32) {
        const float li = expf(ct - cum[s]) * iv[s];
        Ps[tri(tt) + s] *= li;
        Rs[tri(tt) + s] *= li;
      }
    }
    __syncthreads();

    // the causal triangles as operands: R[t][s] and its transpose
    auto Rrow = [&](int r, int c) {            // R_rc, r = t, c = s
      return (r < Q && c <= r) ? Rs[tri(r) + c] : 0.f;
    };
    auto Rcol = [&](int r, int c) {            // R_cr, r = s, c = t
      return (r < Q && c >= r && c < Q) ? Rs[tri(c) + r] : 0.f;
    };
    auto Pcol = [&](int r, int c) {
      return (r < Q && c >= r && c < Q) ? Ps[tri(c) + r] : 0.f;
    };
    // dq = R k + exp(cum_t) H_n dy_t; q_t . (exp(cum_t) H_n dy_t) per tile
    for (int x = t; x < nq * ndt; x += kThreads) {
      const int ti = x / ndt, dj = x - ti * ndt;
      const int t0 = TM * ti, d0 = TN * dj;
      float acc[TM][TN], hy[TM][TN];
      zero(acc);
      zero(hy);
      mac(acc, t0, d0, 0, min(t0 + TM, Q), Rrow,
          [&](int kk, int c) { return c < dk ? Ak(kk, c) : 0.f; });
      mac(hy, t0, d0, 0, dv,
          [&](int r, int c) { return r < Q ? Ady(r, c) : 0.f; },
          [&](int kk, int c) { return c < dk ? Hn[c * dv + kk] : 0.f; });
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int tt = t0 + i;
        if (tt >= Q) continue;
        const float ec = ecum[tt];
        float p = 0.f;
        T* out = dq + (gb + (int64_t)(s0 + tt) * H) * dk;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int d = d0 + j;
          if (d >= dk) continue;
          const float inter = hy[i][j] * ec;
          rt::store_out(out + d, acc[i][j] + inter);
          p = fmaf(Aq(tt, d), inter, p);
        }
        part_q[tt * ndt + dj] = p;
      }
    }
    // dk = R^T q + w_s dH v_s; k_s . (dH v_s) per tile
    for (int x = t; x < nq * ndt; x += kThreads) {
      const int si = x / ndt, dj = x - si * ndt;
      const int c0 = TM * si, d0 = TN * dj;
      float acc[TM][TN], z[TM][TN];
      zero(acc);
      zero(z);
      mac(acc, c0, d0, c0, Q, Rcol,
          [&](int kk, int c) { return c < dk ? Aq(kk, c) : 0.f; });
      mac(z, c0, d0, 0, dv,
          [&](int r, int c) { return r < Q ? Av(r, c) : 0.f; },
          [&](int kk, int c) { return c < dk ? dH[c * dv + kk] : 0.f; });
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int s = c0 + i;
        if (s >= Q) continue;
        const float w = ew[s] * iv[s];
        float p = 0.f;
        T* out = dk_out + (gb + (int64_t)(s0 + s) * H) * dk;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int d = d0 + j;
          if (d >= dk) continue;
          rt::store_out(out + d, fmaf(w, z[i][j], acc[i][j]));
          p = fmaf(Ak(s, d), z[i][j], p);
        }
        part_k[s * ndt + dj] = p;
      }
    }
    // dv = P^T dy + w_s dH^T k_s
    for (int x = t; x < nq * nvt; x += kThreads) {
      const int si = x / nvt, ej = x - si * nvt;
      const int c0 = TM * si, e0 = TN * ej;
      float acc[TM][TN], z[TM][TN];
      zero(acc);
      zero(z);
      mac(acc, c0, e0, c0, Q, Pcol,
          [&](int kk, int c) { return c < dv ? Ady(kk, c) : 0.f; });
      mac(z, c0, e0, 0, dk,
          [&](int r, int c) { return r < Q ? Ak(r, c) : 0.f; },
          [&](int kk, int c) { return c < dv ? dH[kk * dv + c] : 0.f; });
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int s = c0 + i;
        if (s >= Q) continue;
        const float w = ew[s] * iv[s];
        T* out = dv_out + (gb + (int64_t)(s0 + s) * H) * dv;
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (e0 + j < dv)
            rt::store_out(out + e0 + j, fmaf(w, z[i][j], acc[i][j]));
      }
    }
    {                       // <H_n, dH>, this thread's share
      float p = 0.f;
      for (int x = t; x < dk * dv; x += kThreads) p = fmaf(Hn[x], dH[x], p);
      red[t] = p;
    }
    __syncthreads();        // every read of dH (the one after the chunk) done

    if (t < Q) {
      float inter = 0.f, kz = 0.f;
      for (int j = 0; j < ndt; ++j) {
        inter += part_q[t * ndt + j];
        kz += part_k[t * ndt + j];
      }
      const float w = ew[t] * iv[t];
      di[gb + (int64_t)(s0 + t) * H] = fmaf(ew[t], kz, colsd[t]);
      wk[t] = w * kz;
      dcum[t] = rowg[t] - iv[t] * colsd[t] + inter - w * kz;
    }
    // dH <- exp(tot) dH + sum_t exp(cum_t) q_t dy_t^T (the one before)
    for (int x = t; x < ndt * nvt; x += kThreads) {
      const int di_ = x / nvt, ej = x - di_ * nvt;
      const int d0 = TM * di_, e0 = TN * ej;
      float acc[TM][TN];
      zero(acc);
      mac(acc, d0, e0, 0, Q,
          [&](int r, int c) { return r < dk ? Aq(c, r) * ecum[c] : 0.f; },
          [&](int kk, int c) { return c < dv ? Ady(kk, c) : 0.f; });
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int d = d0 + i, e = e0 + j;
          if (d < dk && e < dv) dH[d * dv + e] = fmaf(etot, dH[d * dv + e],
                                                      acc[i][j]);
        }
    }
    __syncthreads();
    if (t == 0) {
      // the gradient of tot joins dcum at Q - 1; da is dcum's reverse cumsum
      float hd = 0.f, sw = 0.f;
      for (int x = 0; x < kThreads; ++x) hd += red[x];
      for (int s = 0; s < Q; ++s) sw += wk[s];
      float run = fmaf(etot, hd, sw);
      for (int s = Q - 1; s >= 0; --s) {
        run += dcum[s];
        da[gb + (int64_t)(s0 + s) * H] = run;
      }
    }
  }
}

template <typename T, bool kStaged>
cudaError_t launch_fma(const T* q, const T* k, const T* v, const float* a,
                       const float* gi, const float* states, const T* dy,
                       const float* dh_final, int B, int S, int H, int dk,
                       int dv, int Q, int64_t qsb, int64_t qss, int64_t qsh,
                       int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb,
                       int64_t vss, int64_t vsh, T* dq, T* dk_out, T* dv_out,
                       float* da, float* di, float* dh0,
                       cudaStream_t stream) {
  const int64_t smem = sizeof(float) * smem_floats(Q, dk, dv, kStaged);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static uint32_t raised = 0;     // devices where this kernel's limit is up
  cudaError_t err =
      rt::raise_smem_once(ssd_chunk_scan_bwd<T, kStaged>, kMaxSmem, raised);
  if (err != cudaSuccess) return err;
  ssd_chunk_scan_bwd<T, kStaged><<<B * H, kThreads, smem, stream>>>(
      q, k, v, a, gi, states, dy, dh_final, S, H, dk, dv, Q, qsb, qss, qsh,
      ksb, kss, ksh, vsb, vss, vsh, dq, dk_out, dv_out, da, di, dh0);
  return cudaGetLastError();
}

// -- the tensor-core design: clusters of chunks, mma.sync --------------------

constexpr int kD = 64;         // dk and dv, zero-padded up to it
constexpr int kW = 8;          // warps a block, one to a 16-row tile
constexpr int kCluster = 4;    // blocks a (b, h)
constexpr int kRS = 68;        // row stride (floats) of an f32 row plane

// Shared memory of one block: four row planes (q, k, v, dy), the NP parts
// of G and of H_n (8 KB a part), the exchange slice of (E, Y) (16 KB), in
// bf16 a 2 KB output buffer a warp, and the vectors: cum, exp(cum), i,
// exp(tot - cum), dcum, w_s k_s^T G v_s, q_t . exp(cum_t) H_n dy_t, sum_t
// S_ts D_ts L_ts ([QP] each), the row sums of G by s tile ([kW][QP]),
// <H_n, G> by warp ([kW]), then E, tot and exp(tot).
template <typename T>
struct Tb {
  static constexpr int NP = sizeof(T) == 2 ? 2 : 3;
  static constexpr __host__ __device__ int row_bytes(int QP) {
    return sizeof(T) == 2 ? QP * 128 : QP * kRS * 4;
  }
  // bf16 output tiles leave through 2 KB a warp (store_tile)
  static constexpr int kOut = sizeof(T) == 2 ? kW * 2048 : 0;
  static constexpr __host__ __device__ int64_t bytes(int QP) {
    return 4 * (int64_t)row_bytes(QP) + 2 * NP * 8192 + 16384 + kOut +
           4 * (int64_t)(8 * QP + kW * QP + 2 * kW);
  }
};

// piece c of row r of a plane of 128-byte rows (64 bf16) in the 128-byte
// swizzle
__device__ __forceinline__ uint4* swz(void* plane, int r, int c) {
  return reinterpret_cast<uint4*>(plane) + r * 8 + (c ^ (r & 7));
}

using rt::exp_of;
using rt::unpack_bf16x2;

// Fragments of a bf16 plane by ldmatrix (lane layout as the forward's):
// A (16 x 16) at rows r0.., columns k0..; A transposed from rows k0..,
// columns m0..; B of two 8-column tiles, (f[0], f[1]) the tile n0 and
// (f[2], f[3]) n0 + 8, with the plane's rows its n (ldb) or its k (ldbt).
__device__ __forceinline__ void lda(uint32_t (&f)[4], void* pl, int r0,
                                    int k0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  rt::ldmatrix_x4(f, swz(pl, r0 + 8 * (mi & 1) + r8, k0 / 8 + (mi >> 1)));
}
__device__ __forceinline__ void ldat(uint32_t (&f)[4], void* pl, int k0,
                                     int m0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  rt::ldmatrix_x4_trans(f,
                        swz(pl, k0 + 8 * (mi >> 1) + r8, m0 / 8 + (mi & 1)));
}
__device__ __forceinline__ void ldb(uint32_t (&f)[4], void* pl, int n0,
                                    int k0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  rt::ldmatrix_x4(f, swz(pl, n0 + 8 * (mi >> 1) + r8, k0 / 8 + (mi & 1)));
}
__device__ __forceinline__ void ldbt(uint32_t (&f)[4], void* pl, int k0,
                                     int n0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  rt::ldmatrix_x4_trans(f,
                        swz(pl, k0 + 8 * (mi & 1) + r8, n0 / 8 + (mi >> 1)));
}

// f[p][e] = part p of the pair x[e]
template <int N>
__device__ __forceinline__ void split4(uint32_t (&f)[N][4],
                                       const float2 (&x)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t h[N];
    rt::split_bf16<N>(x[e].x, x[e].y, h);
#pragma unroll
    for (int p = 0; p < N; ++p) f[p][e] = h[p];
  }
}

// The fragments of the row planes, in N bf16 parts: bf16 planes by
// ldmatrix (N = 1, exact), f32 planes (row stride kRS) by loads of the
// values, split into N = 3 parts. at_vals: the values of A transposed.
template <typename T>
struct Frag;

template <>
struct Frag<__nv_bfloat16> {
  static constexpr int N = 1;
  static __device__ __forceinline__ void a(uint32_t (&f)[1][4], void* pl,
                                           int r0, int k0) {
    lda(f[0], pl, r0, k0);
  }
  static __device__ __forceinline__ void b(uint32_t (&f)[1][4], void* pl,
                                           int n0, int k0) {
    ldb(f[0], pl, n0, k0);
  }
  static __device__ __forceinline__ void bt(uint32_t (&f)[1][4], void* pl,
                                            int k0, int n0) {
    ldbt(f[0], pl, k0, n0);
  }
  static __device__ __forceinline__ void at_vals(float2 (&x)[4], void* pl,
                                                 int k0, int m0) {
    uint32_t f[4];
    ldat(f, pl, k0, m0);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = unpack_bf16x2(f[e]);
  }
  // the values (r, c) and (r, c + 1), c even
  static __device__ __forceinline__ float2 pair(void* pl, int r, int c) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(swz(pl, r, c / 8));
    return unpack_bf16x2(p[(c & 7) / 2]);
  }
};

template <>
struct Frag<float> {
  static constexpr int N = 3;
  static __device__ __forceinline__ const float* at_(void* pl, int r, int c) {
    return reinterpret_cast<const float*>(pl) + r * kRS + c;
  }
  static __device__ __forceinline__ float2 ld2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void a(uint32_t (&f)[3][4], void* pl,
                                           int r0, int k0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
    const float* s = at_(pl, r0 + g, k0 + 2 * qd);
    const float2 x[4] = {ld2(s), ld2(s + 8 * kRS), ld2(s + 8),
                         ld2(s + 8 * kRS + 8)};
    split4<3>(f, x);
  }
  static __device__ __forceinline__ void b(uint32_t (&f)[3][4], void* pl,
                                           int n0, int k0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
    const float* s = at_(pl, n0 + g, k0 + 2 * qd);
    const float2 x[4] = {ld2(s), ld2(s + 8), ld2(s + 8 * kRS),
                         ld2(s + 8 * kRS + 8)};
    split4<3>(f, x);
  }
  static __device__ __forceinline__ void bt(uint32_t (&f)[3][4], void* pl,
                                            int k0, int n0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
    const float* s = at_(pl, k0 + 2 * qd, n0 + g);
    const float2 x[4] = {make_float2(s[0], s[kRS]),
                         make_float2(s[8 * kRS], s[9 * kRS]),
                         make_float2(s[8], s[kRS + 8]),
                         make_float2(s[8 * kRS + 8], s[9 * kRS + 8])};
    split4<3>(f, x);
  }
  static __device__ __forceinline__ void at_vals(float2 (&x)[4], void* pl,
                                                 int k0, int m0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
    const float* s = at_(pl, k0 + 2 * qd, m0 + g);
    x[0] = make_float2(s[0], s[kRS]);
    x[1] = make_float2(s[8], s[kRS + 8]);
    x[2] = make_float2(s[8 * kRS], s[9 * kRS]);
    x[3] = make_float2(s[8 * kRS + 8], s[9 * kRS + 8]);
  }
  static __device__ __forceinline__ float2 pair(void* pl, int r, int c) {
    return ld2(at_(pl, r, c));
  }
};

// B fragments of the NP parts of G or H_n (bf16 planes of 64 x 64, 512
// pieces apart)
template <int NP>
__device__ __forceinline__ void parts_b(uint32_t (&f)[NP][4], uint4* pl,
                                        int n0, int k0) {
#pragma unroll
  for (int p = 0; p < NP; ++p) ldb(f[p], pl + p * 512, n0, k0);
}
template <int NP>
__device__ __forceinline__ void parts_bt(uint32_t (&f)[NP][4], uint4* pl,
                                         int k0, int n0) {
#pragma unroll
  for (int p = 0; p < NP; ++p) ldbt(f[p], pl + p * 512, k0, n0);
}

// (c0, c1) += a b for the two 8-column tiles of b
template <int NA, int NB>
__device__ __forceinline__ void mma2(float (&c0)[4], float (&c1)[4],
                                     const uint32_t (&a)[NA][4],
                                     const uint32_t (&b)[NB][4]) {
  uint32_t b00[NB], b01[NB], b10[NB], b11[NB];
#pragma unroll
  for (int p = 0; p < NB; ++p)
    b00[p] = b[p][0], b01[p] = b[p][1], b10[p] = b[p][2], b11[p] = b[p][3];
  rt::mma_parts<NA, NB>(c0, a, b00, b01);
  rt::mma_parts<NA, NB>(c1, a, b10, b11);
}

// The accumulators of two 8-column tiles as the A fragment (16 x 16) of
// the next product, in NP parts
template <int NP>
__device__ __forceinline__ void split_acc(uint32_t (&a)[NP][4],
                                          const float (&c0)[4],
                                          const float (&c1)[4]) {
  const float2 x[4] = {make_float2(c0[0], c0[1]), make_float2(c0[2], c0[3]),
                       make_float2(c1[0], c1[1]), make_float2(c1[2], c1[3])};
  split4<NP>(a, x);
}

template <typename T>
__device__ __forceinline__ void put2(T* row, int c, int d, float x, float y) {
  if (c + 1 < d && (d & 1) == 0) {
    if constexpr (sizeof(T) == 2)
      *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(x, y);
    else
      *reinterpret_cast<float2*>(row + c) = make_float2(x, y);
  } else {
    if (c < d) rt::store_out(row + c, x);
    if (c + 1 < d) rt::store_out(row + c + 1, y);
  }
}

// A warp's 16 x d output tile, held as accumulators acc[j][e] (row g + 8
// (e >> 1), column 8 j + 2 qd + (e & 1)), into the rows rowp(0 .. 15): bf16
// rows of 64 go through the warp's 2 KB of shared memory (128-byte rows in
// the swizzle) and leave as 16-byte stores, 8 lanes a row; other rows leave
// as pairs.
template <typename T, class RowP>
__device__ __forceinline__ void store_tile(const float (&acc)[8][4], int d,
                                           uint4* buf, RowP rowp) {
  const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
  if constexpr (sizeof(T) == 2) {
    if (d == kD) {
      __syncwarp();                   // the buffer's last reads are done
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          __nv_bfloat162 x =
              __floats2bfloat162_rn(acc[j][2 * hf], acc[j][2 * hf + 1]);
          reinterpret_cast<uint32_t*>(swz(buf, g + 8 * hf, j))[qd] =
              *reinterpret_cast<uint32_t*>(&x);
        }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (lane >> 3) + 4 * i, c = lane & 7;
        *reinterpret_cast<uint4*>(rowp(r) + 8 * c) = *swz(buf, r, c);
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    put2(rowp(g), 8 * j + 2 * qd, d, acc[j][0], acc[j][1]);
    put2(rowp(g + 8), 8 * j + 2 * qd, d, acc[j][2], acc[j][3]);
  }
}

// Rows 0 .. Q - 1 of one operand (row stride ss, d values a row, zero past
// d) into a row plane in 16-byte pieces (8 bf16, swizzled; 4 f32, row
// stride kRS): by cp.async where `vec` (16-byte aligned rows), else value by
// value.
template <typename T>
__device__ __forceinline__ void stage_plane(const T* __restrict__ src,
                                            int64_t ss, int d, int Q,
                                            void* pl, bool vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int PR = kD / V;
  for (int x = threadIdx.x; x < Q * PR; x += blockDim.x) {
    const int r = x / PR, c = x - r * PR;
    const int n = max(0, min(V, d - V * c));
    uint4* o = sizeof(T) == 2
                   ? swz(pl, r, c)
                   : reinterpret_cast<uint4*>(reinterpret_cast<float*>(pl) +
                                              r * kRS + V * c);
    const T* p = src + (int64_t)r * ss + V * c;
    if (vec) {
      rt::cp_async16_zfill(o, n ? p : src, n * (int)sizeof(T));
    } else {
      __align__(16) T e[V];
#pragma unroll
      for (int j = 0; j < V; ++j) e[j] = j < n ? p[j] : T(0.f);
      *o = *reinterpret_cast<const uint4*>(e);
    }
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// vec: bit 0, 1, 2, 3 where q, k, v, dy allow 16-byte copies.
template <typename T, int kC>
__global__ void __cluster_dims__(kC, 1, 1) __launch_bounds__(kW * 32, 1)
ssd_chunk_scan_bwd_mma(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ a,
                       const float* __restrict__ gi,
                       const float* __restrict__ states,
                       const T* __restrict__ dy,
                       const float* __restrict__ dh_final, int S, int H,
                       int dk, int dv, int Q, int64_t qsb, int64_t qss,
                       int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                       int64_t vsb, int64_t vss, int64_t vsh, int vec,
                       T* __restrict__ dq, T* __restrict__ dk_out,
                       T* __restrict__ dv_out, float* __restrict__ da,
                       float* __restrict__ di, float* __restrict__ dh0) {
  using F = Frag<T>;
  constexpr int NQ = F::N, NP = Tb<T>::NP;
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int SJ = 4;               // 8-column tiles of a warp's slice
  extern __shared__ __align__(128) unsigned char bsm[];
  const int nT = Q / 16, nc = S / Q;
  const int rb = Tb<T>::row_bytes(Q);
  void* qpl = bsm;
  void* kpl = bsm + rb;
  void* vpl = bsm + 2 * rb;
  void* ypl = bsm + 3 * rb;
  uint4* gparts = reinterpret_cast<uint4*>(bsm + 4 * rb);   // G's parts
  uint4* hparts = gparts + NP * 512;                         // H_n's parts
  float* xs = reinterpret_cast<float*>(hparts + NP * 512);   // Y slices
  float* cum = reinterpret_cast<float*>(bsm + 4 * rb + 2 * NP * 8192 +
                                        16384 + Tb<T>::kOut);
  float* ecum = cum + Q;
  float* iv = ecum + Q;
  float* ew = iv + Q;
  float* dcol = ew + Q;      // dcum
  float* wk = dcol + Q;      // w_s k_s^T G v_s
  float* qh = wk + Q;        // q_t . exp(cum_t) H_n dy_t
  float* colsd = qh + Q;     // sum_t S_ts D_ts L_ts
  float* rowg = colsd + Q;   // [kW][Q] rows of S D L i_s by s tile
  float* red = rowg + kW * Q;  // <H_n, G> by warp; E, tot, exp(tot)

  cg::cluster_group cluster = cg::this_cluster();
  const int crank = (int)cluster.block_rank();
  const int bh = blockIdx.x / kC, b = bh / H, h = bh - b * H;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int g = lane >> 2, qd = lane & 3;
  uint4* obuf = reinterpret_cast<uint4*>(xs + 4096) + w * 128;  // bf16
  const int run = (nc + kC - 1) / kC;
  const int lo = min(crank * run, nc), hi = min(lo + run, nc);
  const int64_t gb = (int64_t)b * S * H + h;       // gates: (B, S, H)
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;
  const int64_t ys = (int64_t)H * dv;              // dy: (B, S, H, dv)
  const T* yb = dy + gb * dv;
  // the state's (dk x dv) slice of this thread, in the accumulator layout
  // of four 8-column tiles: warp w has rows 16 (w >> 1) .., columns
  // 32 (w & 1) ..
  const int sd0 = 16 * (w >> 1), se0 = 32 * (w & 1);
  auto state_at = [&](const float* m, int j, int e) {
    const int d = sd0 + g + 8 * (e >> 1), c = se0 + 8 * j + 2 * qd + (e & 1);
    return (d < dk && c < dv) ? m[d * dv + c] : 0.f;
  };
  // the warp's 16-row tile, as query positions t and as key positions s:
  // w or 11 - w, so that the two warps on one scheduler share the causal
  // work evenly
  const int tile = nT == kW ? (w < 4 ? w : 11 - w) : w;

  // chunk m's gates (warp 0: loads first, the scan after the copies are
  // asked for) and rows (q and dy, then k and v: two cp.async groups)
  auto stage = [&](int m) {
    const int s0 = m * Q;
    const int E = (Q + 31) / 32;
    const int glo = min(lane * E, Q), ghi = min(glo + E, Q);
    float ga[4], gv[4];
    if (w == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t o = gb + (int64_t)(s0 + glo + j) * H;
        ga[j] = glo + j < ghi ? a[o] : 0.f;
        gv[j] = glo + j < ghi ? gi[o] : 0.f;
      }
    }
    rt::cp_async_wait<0>();           // no older copy lands on these
    stage_plane<T>(qb + s0 * qss, qss, dk, Q, qpl, vec & 1);
    stage_plane<T>(yb + s0 * ys, ys, dv, Q, ypl, vec & 8);
    rt::cp_async_commit();
    stage_plane<T>(kb + s0 * kss, kss, dk, Q, kpl, vec & 2);
    stage_plane<T>(vb + s0 * vss, vss, dv, Q, vpl, vec & 4);
    rt::cp_async_commit();
    if (w == 0) {
      // cumsum: each lane sums its run of E <= 4 gates, a shuffle scan adds
      // the runs before it
      float c[4], r = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (glo + j < ghi) r += ga[j];
        c[j] = r;
      }
      float incl = r;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float nb = __shfl_up_sync(kAll, incl, o);
        if (lane >= o) incl += nb;
      }
      const float before = incl - r;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (glo + j < ghi) cum[glo + j] = c[j] + before;
      __syncwarp();
      const float tot = cum[Q - 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = glo + j;
        if (s < ghi) {
          ecum[s] = expf(cum[s]);
          ew[s] = expf(tot - cum[s]);
          iv[s] = gv[j];
        }
      }
      if (lane == 0) red[kW + 1] = tot, red[kW + 2] = expf(tot);
    }
  };

  // H_n of chunk m, this thread's slice, from the forward's f32 states
  float hv[SJ][4];
  int hv_chunk = -1;
  auto load_h = [&](int m) {
    const float* Hn = states + ((int64_t)(b * nc + m) * H + h) * dk * dv;
#pragma unroll
    for (int j = 0; j < SJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hv[j][e] = state_at(Hn, j, e);
    hv_chunk = m;
  };
  // the NP bf16 parts of a slice into their planes
  auto put_parts = [&](uint4* pl, const float (&x)[SJ][4]) {
#pragma unroll
    for (int j = 0; j < SJ; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int d = sd0 + g + 8 * hf, c = se0 + 8 * j + 2 * qd;
        uint32_t pt[NP];
        rt::split_bf16<NP>(x[j][2 * hf], x[j][2 * hf + 1], pt);
#pragma unroll
        for (int p = 0; p < NP; ++p)
          reinterpret_cast<uint32_t*>(swz(pl + p * 512, d, c / 8))
              [(c & 7) / 2] = pt[p];
      }
  };
  auto xs_at = [&](int j, int e) { return ((w * SJ + j) * 4 + e) * 32 + lane; };

  // X = sum_t exp(cum_t) q_t dy_t^T on this thread's slice: A = (exp(cum)
  // q)^T from the q plane (values scaled, then split into NP parts), B =
  // dy's rows
  auto xprod = [&](float (&xa)[SJ][4]) {
#pragma unroll
    for (int j = 0; j < SJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) xa[j][e] = 0.f;
    for (int ks = 0; ks < nT; ++ks) {
      float2 x[4];
      F::at_vals(x, qpl, 16 * ks, sd0);
      const float2 ea = *reinterpret_cast<const float2*>(ecum + 16 * ks +
                                                         2 * qd);
      const float2 eb = *reinterpret_cast<const float2*>(ecum + 16 * ks + 8 +
                                                         2 * qd);
      x[0].x *= ea.x, x[0].y *= ea.y, x[1].x *= ea.x, x[1].y *= ea.y;
      x[2].x *= eb.x, x[2].y *= eb.y, x[3].x *= eb.x, x[3].y *= eb.y;
      uint32_t af[NP][4];
      split4<NP>(af, x);
#pragma unroll
      for (int jj = 0; jj < SJ / 2; ++jj) {
        uint32_t bf[NQ][4];
        F::bt(bf, ypl, 16 * ks, se0 + 16 * jj);
        mma2<NP, NQ>(xa[2 * jj], xa[2 * jj + 1], af, bf);
      }
    }
  };

  // pass 1: the run's (E, Y), published for the cluster
  float ya[SJ][4];
#pragma unroll
  for (int j = 0; j < SJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ya[j][e] = 0.f;
  float E = 1.f;
  int staged = -1;
  for (int m = hi - 1; m >= lo; --m) {
    __syncthreads();                  // the planes are free
    stage(m);
    staged = m;
    if (run == 1) load_h(m);          // in flight while X is formed
    rt::cp_async_wait<1>();           // q and dy are in
    __syncthreads();
    float xa[SJ][4];
    xprod(xa);
    const float et = red[kW + 2];
#pragma unroll
    for (int j = 0; j < SJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[j][e] = fmaf(et, ya[j][e], xa[j][e]);
    E *= et;
  }
#pragma unroll
  for (int j = 0; j < SJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) xs[xs_at(j, e)] = ya[j][e];
  if (t == 0) red[kW] = E;
  cluster_arrive();                   // this block's (E, Y) is out

  // G after the run: from dh_final, G <- E_c G + Y_c over the later
  // blocks, the last first (read once the cluster's (E, Y) are out)
  float G[SJ][4];
  auto exchange = [&]() {
#pragma unroll
    for (int j = 0; j < SJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        G[j][e] = dh_final ? state_at(dh_final + (int64_t)bh * dk * dv, j, e)
                           : 0.f;
    cluster_wait();
    for (int c2 = kC - 1; c2 > crank; --c2) {
      const float* ry = cluster.map_shared_rank(xs, c2);
      const float e2 = *cluster.map_shared_rank(red + kW, c2);
#pragma unroll
      for (int j = 0; j < SJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          G[j][e] = fmaf(e2, G[j][e], ry[xs_at(j, e)]);
    }
    cluster_arrive();                 // the reads of the others are done
  };

  // Query positions t of the warp's tile: dq_t = exp(cum_t) H_n dy_t (n:
  // d, k: e) + R k over the blocks s <= t, R = D L i_s from D = dy v^T; and
  // q_t . exp(cum_t) H_n dy_t into qh.
  const int r0 = 16 * tile, ra_ = r0 + g, rb_ = ra_ + 8;  // its two rows
  auto query = [&](int s0) {
    const float cta = cum[ra_], ctb = cum[rb_];
    float dqa[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t af[NQ][4];
      F::a(af, ypl, r0, 16 * ks);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bf[NP][4];
        parts_b<NP>(bf, hparts, 16 * jj, 16 * ks);
        mma2<NQ, NP>(dqa[2 * jj], dqa[2 * jj + 1], af, bf);
      }
    }
    const float eca = ecum[ra_], ecb = ecum[rb_];
    float ia = 0.f, ib = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dqa[j][0] *= eca, dqa[j][1] *= eca, dqa[j][2] *= ecb, dqa[j][3] *= ecb;
      const int c = 8 * j + 2 * qd;
      const float2 qa = F::pair(qpl, ra_, c);
      const float2 qb2 = F::pair(qpl, rb_, c);
      ia = fmaf(qa.x, dqa[j][0], ia);
      ia = fmaf(qa.y, dqa[j][1], ia);
      ib = fmaf(qb2.x, dqa[j][2], ib);
      ib = fmaf(qb2.y, dqa[j][3], ib);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      ia += __shfl_xor_sync(kAll, ia, o);
      ib += __shfl_xor_sync(kAll, ib, o);
    }
    if (qd == 0) qh[ra_] = ia, qh[rb_] = ib;
    for (int sbk = 0; sbk <= tile; ++sbk) {
      const int c0 = 16 * sbk;
      float rc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) rc[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t af[NQ][4], bf[NQ][4];
        F::a(af, ypl, r0, 16 * ks);
        F::b(bf, vpl, c0, 16 * ks);
        mma2<NQ, NQ>(rc[0], rc[1], af, bf);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int sc0 = c0 + 8 * nt + 2 * qd;
        const float2 cs = *reinterpret_cast<const float2*>(cum + sc0);
        const float2 is = *reinterpret_cast<const float2*>(iv + sc0);
        float l[4] = {exp_of(cta - cs.x), exp_of(cta - cs.y),
                      exp_of(ctb - cs.x), exp_of(ctb - cs.y)};
        if (sbk == tile) {            // above the diagonal: selected to 0
          l[0] = sc0 <= ra_ ? l[0] : 0.f;
          l[1] = sc0 + 1 <= ra_ ? l[1] : 0.f;
          l[2] = sc0 <= rb_ ? l[2] : 0.f;
          l[3] = sc0 + 1 <= rb_ ? l[3] : 0.f;
        }
        rc[nt][0] *= l[0] * is.x;
        rc[nt][1] *= l[1] * is.y;
        rc[nt][2] *= l[2] * is.x;
        rc[nt][3] *= l[3] * is.y;
      }
      uint32_t ra[NP][4];
      split_acc<NP>(ra, rc[0], rc[1]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bf[NQ][4];
        F::bt(bf, kpl, c0, 16 * jj);
        mma2<NP, NQ>(dqa[2 * jj], dqa[2 * jj + 1], ra, bf);
      }
    }
    store_tile<T>(dqa, dk, obuf, [&](int r) {
      return dq + (gb + (int64_t)(s0 + r0 + r) * H) * dk;
    });
  };

  // Key positions s of the warp's tile without G: over the causal blocks
  // t >= s, S^T and D^T in accumulators, gated there into P^T for dv_s +=
  // P^T dy and R^T for dk_s += R^T q, with the columns of S D L into colsd
  // and the rows of S D L i_s summed over the tile's 16 s into rowg.
  auto key_intra = [&](float (&dva)[8][4], float (&dka)[8][4]) {
    const float csa = cum[ra_], csb = cum[rb_], isa = iv[ra_], isb = iv[rb_];
    float cola = 0.f, colb = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dva[j][e] = dka[j][e] = 0.f;
    for (int tb = tile; tb < nT; ++tb) {
      const int t0 = 16 * tb;
      float sc[2][4], dc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = dc[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t af[NQ][4], bf[NQ][4];
        F::a(af, kpl, r0, 16 * ks);
        F::b(bf, qpl, t0, 16 * ks);
        mma2<NQ, NQ>(sc[0], sc[1], af, bf);
        F::a(af, vpl, r0, 16 * ks);
        F::b(bf, ypl, t0, 16 * ks);
        mma2<NQ, NQ>(dc[0], dc[1], af, bf);
      }
      float rg[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int tc = t0 + 8 * nt + 2 * qd;
        const float2 ct = *reinterpret_cast<const float2*>(cum + tc);
        float l[4] = {exp_of(ct.x - csa), exp_of(ct.y - csa),
                      exp_of(ct.x - csb), exp_of(ct.y - csb)};
        if (tb == tile) {             // above the diagonal: selected to 0
          l[0] = ra_ <= tc ? l[0] : 0.f;
          l[1] = ra_ <= tc + 1 ? l[1] : 0.f;
          l[2] = rb_ <= tc ? l[2] : 0.f;
          l[3] = rb_ <= tc + 1 ? l[3] : 0.f;
        }
        float gg[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ii = e < 2 ? isa : isb;
          const float sl = sc[nt][e] * l[e];
          const float sdl = sl * dc[nt][e];
          if (e < 2)
            cola += sdl;
          else
            colb += sdl;
          gg[e] = sdl * ii;
          dc[nt][e] = dc[nt][e] * l[e] * ii;        // R^T
          sc[nt][e] = sl * ii;                      // P^T
        }
        rg[nt][0] = gg[0] + gg[2];
        rg[nt][1] = gg[1] + gg[3];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
            rg[nt][x] += __shfl_xor_sync(kAll, rg[nt][x], o);
      if (g == 0) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          *reinterpret_cast<float2*>(rowg + tile * Q + t0 + 8 * nt +
                                     2 * qd) =
              make_float2(rg[nt][0], rg[nt][1]);
      }
      uint32_t pa[NP][4], ra[NP][4];
      split_acc<NP>(pa, sc[0], sc[1]);
      split_acc<NP>(ra, dc[0], dc[1]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bf[NQ][4];
        F::bt(bf, ypl, t0, 16 * jj);
        mma2<NP, NQ>(dva[2 * jj], dva[2 * jj + 1], pa, bf);
        F::bt(bf, qpl, t0, 16 * jj);
        mma2<NP, NQ>(dka[2 * jj], dka[2 * jj + 1], ra, bf);
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      cola += __shfl_xor_sync(kAll, cola, o);
      colb += __shfl_xor_sync(kAll, colb, o);
    }
    if (qd == 0) colsd[ra_] = cola, colsd[rb_] = colb;
  };

  // Key positions s, the state's terms: dk_s += w_s G v_s (n: d, k: e),
  // then di_s, w_s k_s^T G v_s and dcum for the same rows as query
  // positions; dv_s += w_s G^T k_s (n: e, k: d).
  auto key_state = [&](float (&dva)[8][4], float (&dka)[8][4], int s0) {
    const float isa = iv[ra_], isb = iv[rb_];
    const float wa = ew[ra_] * isa, wb = ew[rb_] * isb;
    {
      float kza = 0.f, kzb = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float z[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) z[nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t af[NQ][4], bf[NP][4];
          F::a(af, vpl, r0, 16 * ks);
          parts_b<NP>(bf, gparts, 16 * jj, 16 * ks);
          mma2<NQ, NP>(z[0], z[1], af, bf);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int j = 2 * jj + nt;
          const float2 ka = F::pair(kpl, ra_, 8 * j + 2 * qd);
          const float2 kb2 = F::pair(kpl, rb_, 8 * j + 2 * qd);
          kza = fmaf(ka.x, z[nt][0], kza);
          kza = fmaf(ka.y, z[nt][1], kza);
          kzb = fmaf(kb2.x, z[nt][2], kzb);
          kzb = fmaf(kb2.y, z[nt][3], kzb);
          dka[j][0] = fmaf(wa, z[nt][0], dka[j][0]);
          dka[j][1] = fmaf(wa, z[nt][1], dka[j][1]);
          dka[j][2] = fmaf(wb, z[nt][2], dka[j][2]);
          dka[j][3] = fmaf(wb, z[nt][3], dka[j][3]);
        }
      }
      store_tile<T>(dka, dk, obuf, [&](int r) {
        return dk_out + (gb + (int64_t)(s0 + r0 + r) * H) * dk;
      });
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        kza += __shfl_xor_sync(kAll, kza, o);
        kzb += __shfl_xor_sync(kAll, kzb, o);
      }
      if (qd == 0) {
        const float cola = colsd[ra_], colb = colsd[rb_];
        di[gb + (int64_t)(s0 + ra_) * H] = fmaf(ew[ra_], kza, cola);
        di[gb + (int64_t)(s0 + rb_) * H] = fmaf(ew[rb_], kzb, colb);
        wk[ra_] = wa * kza;
        wk[rb_] = wb * kzb;
        // dcum = row sums of G (s tiles in order) - i colsd + inter - w kz
        float sa_ = 0.f, sb_ = 0.f;
        for (int j = 0; j <= tile; ++j) {
          sa_ += rowg[j * Q + ra_];
          sb_ += rowg[j * Q + rb_];
        }
        dcol[ra_] = sa_ - isa * cola + qh[ra_] - wa * kza;
        dcol[rb_] = sb_ - isb * colb + qh[rb_] - wb * kzb;
      }
    }
    {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float u[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) u[nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t af[NQ][4], bf[NP][4];
          F::a(af, kpl, r0, 16 * ks);
          parts_bt<NP>(bf, gparts, 16 * ks, 16 * jj);
          mma2<NQ, NP>(u[0], u[1], af, bf);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int j = 2 * jj + nt;
          dva[j][0] = fmaf(wa, u[nt][0], dva[j][0]);
          dva[j][1] = fmaf(wa, u[nt][1], dva[j][1]);
          dva[j][2] = fmaf(wb, u[nt][2], dva[j][2]);
          dva[j][3] = fmaf(wb, u[nt][3], dva[j][3]);
        }
      }
      store_tile<T>(dva, dv, obuf, [&](int r) {
        return dv_out + (gb + (int64_t)(s0 + r0 + r) * H) * dv;
      });
    }
  };

  // pass 2: the run's chunks in reverse
  float dva[8][4], dka[8][4];         // dv_s and dk_s of the warp's tile
  for (int m = hi - 1; m >= lo; --m) {
    if (m != staged) {
      __syncthreads();                // the planes are free
      stage(m);
      staged = m;
    }
    if (hv_chunk != m) load_h(m);
    const int s0 = m * Q;
    put_parts(hparts, hv);
    rt::cp_async_wait<0>();
    __syncthreads();                  // rows, gates and H_n's parts are in

    // the warp's tile as query positions, then as key positions: no
    // barrier between them, and neither needs G
    if (tile < nT) {
      query(s0);
      key_intra(dva, dka);
    }

    // G after this chunk (the cluster's, the first time), its parts, and
    // <H_n, G> by warp (H_n read again, once)
    if (m == hi - 1) exchange();
    {
      load_h(m);
      float hg = 0.f;
#pragma unroll
      for (int j = 0; j < SJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hg = fmaf(hv[j][e], G[j][e], hg);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) hg += __shfl_xor_sync(kAll, hg, o);
      if (lane == 0) red[w] = hg;
      put_parts(gparts, G);
    }
    __syncthreads();                  // G's parts and the row sums are in

    if (tile < nT) key_state(dva, dka, s0);
    __syncthreads();                  // dcum and w k^T G v are in

    if (w == 0) {
      // the gradient of tot joins dcum at Q - 1; da is dcum's reverse
      // cumsum: each lane sums its run from the end, a shuffle scan adds
      // the runs after it
      float hg = 0.f;
#pragma unroll
      for (int x = 0; x < kW; ++x) hg += red[x];
      const int Er = (Q + 31) / 32;
      const int glo = min(lane * Er, Q), ghi = min(glo + Er, Q);
      float sw = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (glo + j < ghi) sw += wk[glo + j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sw += __shfl_xor_sync(kAll, sw, o);
      const float dtot = fmaf(red[kW + 2], hg, sw);
      float x[4], r = 0.f;
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        const int s = glo + j;
        if (s < ghi) r += s == Q - 1 ? dcol[s] + dtot : dcol[s];
        x[j] = r;
      }
      float incl = r;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float nb = __shfl_down_sync(kAll, incl, o);
        if (lane + o < 32) incl += nb;
      }
      float after = __shfl_down_sync(kAll, incl, 1);
      if (lane == 31) after = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (glo + j < ghi) da[gb + (int64_t)(s0 + glo + j) * H] = x[j] + after;
    }

    // G before this chunk, where a later step needs it
    if (m > lo || crank == 0) {
      float xa[SJ][4];
      if (run == 1) {                 // Y is this chunk's X
#pragma unroll
        for (int j = 0; j < SJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) xa[j][e] = xs[xs_at(j, e)];
      } else {
        xprod(xa);
      }
      const float et = red[kW + 2];
#pragma unroll
      for (int j = 0; j < SJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) G[j][e] = fmaf(et, G[j][e], xa[j][e]);
      if (m == 0) {
#pragma unroll
        for (int j = 0; j < SJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = sd0 + g + 8 * (e >> 1);
            const int c = se0 + 8 * j + 2 * qd + (e & 1);
            if (d < dk && c < dv)
              dh0[((int64_t)bh * dk + d) * dv + c] = G[j][e];
          }
      }
    }
  }
  if (lo == hi) exchange();           // a block without chunks takes part
  cluster_wait();                     // no block leaves while read
}

template <typename T, int kC>
cudaError_t launch_mma(const T* q, const T* k, const T* v, const float* a,
                       const float* gi, const float* states, const T* dy,
                       const float* dh_final, int B, int S, int H, int dk,
                       int dv, int Q, int64_t qsb, int64_t qss, int64_t qsh,
                       int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb,
                       int64_t vss, int64_t vsh, T* dq, T* dk_out, T* dv_out,
                       float* da, float* di, float* dh0,
                       cudaStream_t stream) {
  constexpr int64_t kMaxBytes = Tb<T>::bytes(kMaxQ);
  static_assert(kMaxBytes <= kMaxSmem, "shared memory");
  if ((int64_t)B * H * kC > 0x7fffffff) return cudaErrorInvalidValue;
  static uint32_t raised = 0;     // devices where this kernel's limit is up
  cudaError_t err = rt::raise_smem_once(ssd_chunk_scan_bwd_mma<T, kC>,
                                        (int)kMaxBytes, raised);
  if (err != cudaSuccess) return err;
  constexpr int kVec = 16 / sizeof(T);
  auto fits = [&](const T* p, int64_t sb, int64_t ss, int64_t sh) {
    return rt::aligned16(p) && sb % kVec == 0 && ss % kVec == 0 &&
           sh % kVec == 0;
  };
  const int vec = (fits(q, qsb, qss, qsh) ? 1 : 0) |
                  (fits(k, ksb, kss, ksh) ? 2 : 0) |
                  (fits(v, vsb, vss, vsh) ? 4 : 0) |
                  (fits(dy, (int64_t)S * H * dv, (int64_t)H * dv, dv) ? 8 : 0);
  ssd_chunk_scan_bwd_mma<T, kC>
      <<<B * H * kC, kW * 32, Tb<T>::bytes(Q), stream>>>(
          q, k, v, a, gi, states, dy, dh_final, S, H, dk, dv, Q, qsb, qss,
          qsh, ksb, kss, ksh, vsb, vss, vsh, vec, dq, dk_out, dv_out, da, di,
          dh0);
  return cudaGetLastError();
}

// The instantiation the dispatch takes: 0, 1 the tensor-core design in
// bf16, f32; 2, 3 the first design in bf16 with the rows in shared memory,
// read from global memory; 4, 5 the same in f32.
int design(int bf16, int dk, int dv, int Q) {
  if (dk <= kD && dv <= kD && Q % 16 == 0) return bf16 ? 0 : 1;
  const bool staged =
      sizeof(float) * smem_floats(Q, dk, dv, true) <= kMaxSmem;
  return (bf16 ? 2 : 4) + (staged ? 0 : 1);
}

bool valid(int B, int S, int H, int dk, int dv, int chunk) {
  return B >= 1 && S >= 1 && H >= 1 && chunk >= 1 && chunk <= kMaxQ &&
         S % chunk == 0 && dk >= 1 && dk <= kMaxD && dv >= 1 &&
         dv <= kMaxD && (int64_t)B * H <= 0x7fffffff;
}

}  // namespace

// Which instantiation repro_ssd_scan_bwd launches for these operands
// (design() above), or -1 where it launches none.
extern "C" int repro_ssd_scan_bwd_design(int bf16, int dk, int dv,
                                         int chunk) {
  return valid(1, chunk, 1, dk, dv, chunk) ? design(bf16, dk, dv, chunk)
                                           : -1;
}

// q, k: (B, S, H, dk), v: (B, S, H, dv), with element strides (sb, ss, sh,
// 1) each (a head stride may be 0); dtype f32 (bf16 == 0) or bf16 (bf16 ==
// 1) for all three, for dy (B, S, H, dv) contiguous and for the outputs dq,
// dk (B, S, H, dk) and dv (B, S, H, dv), contiguous. a, i: (B, S, H) f32
// contiguous; states: (B, S / chunk, H, dk, dv) f32, the state before each
// chunk as ssd_scan.cu writes it; dh_final: (B, H, dk, dv) f32 or null for
// zeros. da, di: (B, S, H) f32; dh0: (B, H, dk, dv) f32, the initial state's
// gradient. S % chunk == 0, chunk <= 128, dk, dv <= 128. Returns a
// cudaError_t.
extern "C" int repro_ssd_scan_bwd(const void* q, const void* k,
                                  const void* v, const float* a,
                                  const float* i, const float* states,
                                  const void* dy, const float* dh_final,
                                  int bf16, int B, int S, int H, int dk,
                                  int dv, int chunk, long long qsb,
                                  long long qss, long long qsh, long long ksb,
                                  long long kss, long long ksh, long long vsb,
                                  long long vss, long long vsh, void* dq,
                                  void* dk_out, void* dv_out, float* da,
                                  float* di, float* dh0, void* stream) {
  if (!valid(B, S, H, dk, dv, chunk) || !states) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BWD_ARGS(T)                                                   \
  static_cast<const T*>(q), static_cast<const T*>(k),                       \
      static_cast<const T*>(v), a, i, states, static_cast<const T*>(dy),    \
      dh_final, B, S, H, dk, dv, chunk, qsb, qss, qsh, ksb, kss, ksh, vsb,  \
      vss, vsh, static_cast<T*>(dq), static_cast<T*>(dk_out),               \
      static_cast<T*>(dv_out), da, di, dh0, st
  using bf = __nv_bfloat16;
  switch (design(bf16, dk, dv, chunk)) {
    case 0: return launch_mma<bf, kCluster>(REPRO_BWD_ARGS(bf));
    case 1: return launch_mma<float, kCluster>(REPRO_BWD_ARGS(float));
    case 2: return launch_fma<bf, true>(REPRO_BWD_ARGS(bf));
    case 3: return launch_fma<bf, false>(REPRO_BWD_ARGS(bf));
    case 4: return launch_fma<float, true>(REPRO_BWD_ARGS(float));
    default: return launch_fma<float, false>(REPRO_BWD_ARGS(float));
  }
#undef REPRO_BWD_ARGS
}
