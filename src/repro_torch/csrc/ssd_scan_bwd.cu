// K4's backward: the gradient of the SSD / decay-attention chunk scan.
//
// The TPU has no kernel here: the JAX package trains through XLA's autodiff
// of the jnp chunked_decay_attention (src/repro/models/ssm.py:45), while the
// port's forward is the kernel ssd_scan.cu, whose gradient therefore needs a
// kernel of its own. For each (b, h), by chunks of Q positions in reverse,
// with cum the chunk's inclusive cumsum of a, tot = cum_{Q-1}, L_ts =
// exp(cum_t - cum_s) (s <= t), w_s = exp(tot - cum_s) i_s, H_n the state
// before the chunk (written by the forward) and dH the gradient of the state
// after it (dh_final for the last chunk):
//   S_ts = q_t . k_s,  D_ts = dy_t . v_s,  P = S L i_s,  R = D L i_s
//   dq_t = sum_s R_ts k_s + exp(cum_t) H_n dy_t
//   dk_s = sum_t R_ts q_t + w_s dH v_s
//   dv_s = sum_t P_ts dy_t + w_s dH^T k_s
//   di_s = sum_t S_ts D_ts L_ts + exp(tot - cum_s) k_s^T dH v_s
//   dcum = row sums - column sums of G = S D L i_s, + exp(cum_t) q_t . H_n
//          dy_t at t, - w_s k_s^T dH v_s at s, + exp(tot) <H_n, dH> +
//          sum_s w_s k_s^T dH v_s at Q - 1;  da = reverse cumsum of dcum
//   dH  <- exp(tot) dH + sum_t exp(cum_t) q_t dy_t^T;  dh0 = dH after chunk 0
// (the plain version, ssd_scan.ssd_scan_bwd_ref, spells out the same).
//
// Bound on the H100: at zamba2-7b's training shape (B 4, S 512, H 112, dk =
// dv = 64, Q 128, bf16) the function needs 19 GFLOP against 0.20 GB of HBM
// bytes: ~95 flops a byte, below the bf16 tensor cores' ridge (295), so its
// bound is the bytes; on the ordinary f32 cores, where this first design
// does its products, it is the flops (ssd_scan.bwd_bound).
//
// Design, the simplest that is right: one block of 256 threads per (b, h)
// walks the chunks in reverse. Shared memory holds the chunk's two Q x Q
// products S and D as lower triangles (Q(Q+1)/2 floats each; S becomes P and
// D becomes R in place), the chunk's gate vectors, partial sums, and, where
// they fit (dk, dv <= 64 at Q = 128), the chunk's q, k, v and dy rows in f32;
// otherwise the products read those rows from global memory (L1/L2). The
// state before the chunk is read from the forward's states, and dH is kept
// in dh0's own (B, H, dk, dv) f32 buffer, updated in place a chunk at a time.
// Every product is a register tile of 4 x 4 f32 FMAs over one operand pair,
// in a fixed order; the row and column sums are serial loops of one thread,
// and the reverse cumsum and the chunk's scalar sums are taken by thread 0.
// No atomics: two launches on the same inputs give the same bits. q and k
// are read through their strides (a head stride of 0 reads one row for every
// head); dq and dk are written per head, and the caller sums them over the
// heads where q and k were shared.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;
constexpr int kMaxD = 128;
constexpr int kMaxSmem = 232448;
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
cudaError_t launch_bwd(const T* q, const T* k, const T* v, const float* a,
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

}  // namespace

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
  if (B < 1 || S < 1 || H < 1 || chunk < 1 || chunk > kMaxQ ||
      S % chunk != 0 || dk < 1 || dk > kMaxD || dv < 1 || dv > kMaxD ||
      (int64_t)B * H > 0x7fffffff || !states)
    return cudaErrorInvalidValue;
  const bool staged =
      sizeof(float) * smem_floats(chunk, dk, dv, true) <= kMaxSmem;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BWD_ARGS(T)                                                   \
  static_cast<const T*>(q), static_cast<const T*>(k),                       \
      static_cast<const T*>(v), a, i, states, static_cast<const T*>(dy),    \
      dh_final, B, S, H, dk, dv, chunk, qsb, qss, qsh, ksb, kss, ksh, vsb,  \
      vss, vsh, static_cast<T*>(dq), static_cast<T*>(dk_out),               \
      static_cast<T*>(dv_out), da, di, dh0, st
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (bf16)
    err = staged ? launch_bwd<bf, true>(REPRO_BWD_ARGS(bf))
                 : launch_bwd<bf, false>(REPRO_BWD_ARGS(bf));
  else
    err = staged ? launch_bwd<float, true>(REPRO_BWD_ARGS(float))
                 : launch_bwd<float, false>(REPRO_BWD_ARGS(float));
#undef REPRO_BWD_ARGS
  return err;
}
