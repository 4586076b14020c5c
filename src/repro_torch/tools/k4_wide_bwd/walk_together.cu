// A candidate for K4's wide backward (tools/k4_wide_bwd_designs.py): the
// current design (csrc/ssd_scan_wide_bwd.cu) with its launches 1 and 2 in
// one, the score blocks first in the grid and then the walk blocks, all at
// one block an SM (the score blocks hold S and D in 128 accumulator
// registers a thread) with the walk's ring of four stages; four launches a
// call. It was the first tensor-core build: at xlstm-1.3b's training shape
// its 96 score blocks keep 96 SMs for their whole length while the 1,152
// short walk blocks pass through the other 36.
#define repro_ssd_scan_wide_bwd repro_ssd_scan_wide_bwd_current
#define repro_ssd_scan_wide_bwd_scratch repro_ssd_scan_wide_bwd_scratch_now
#include "ssd_scan_wide_bwd.cu"
#undef repro_ssd_scan_wide_bwd
#undef repro_ssd_scan_wide_bwd_scratch

namespace {

constexpr int kTogetherStages = 4;
constexpr int kTogetherSmem = 2 * cmax(kScoreStages * kScoreStage,
                                       kTogetherStages * kWalkStage);

// blocks [0, nscore) are score blocks, the rest walk blocks
__global__ void __launch_bounds__(kThreads, 1)
    together(const Call c, int nscore) {
  extern __shared__ __align__(16) bf16 smem[];
  __shared__ float red[6 * kT];
  if ((int)blockIdx.x < nscore)
    score_block(c, blockIdx.x, smem, red);
  else
    walk_block<kTogetherStages>(c, blockIdx.x - nscore, smem, red);
}

}  // namespace

extern "C" int repro_ssd_scan_wide_bwd_scratch(int B, int S, int H, int dk,
                                               int dv, int chunk,
                                               int has_h0, int has_dh_final,
                                               long long* bytes) {
  return repro_ssd_scan_wide_bwd_scratch_now(B, S, H, dk, dv, chunk, has_h0,
                                             has_dh_final, bytes);
}

extern "C" int repro_ssd_scan_wide_bwd(
    const float* q, const float* k, const float* v, const float* a,
    const float* i, const float* states, const float* dy,
    const float* dh_final, int B, int S, int H, int dk, int dv, int chunk,
    int has_h0, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, void* scratch, long long scratch_bytes, float* dq,
    float* dk_out, float* dv_out, float* da, float* di, float* dh0,
    void* stream) {
  Call c;
  Grids g;
  cudaError_t err = static_cast<cudaError_t>(prepare(
      q, k, v, a, i, states, dy, dh_final, B, S, H, dk, dv, chunk, has_h0,
      qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, scratch, scratch_bytes,
      dq, dk_out, dv_out, da, di, dh0, c, g));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  static uint32_t r1 = 0, r2 = 0;
  err = rt::raise_smem_once(together, kTogetherSmem, r1);
  if (err == cudaSuccess)
    err = rt::raise_smem_once(ssd_wide_bwd_rows, kSmemRows, r2);
  if (err != cudaSuccess) return err;
  ssd_wide_bwd_split<<<(unsigned)g.g0, kThreads, 0, st>>>(
      c, g.vec_qk, g.vec_v, g.vec_dy, g.vec_h);
  together<<<(unsigned)(g.nscore + g.nwalk), kThreads, kTogetherSmem, st>>>(
      c, (int)g.nscore);
  ssd_wide_bwd_rows<<<(unsigned)g.g3, kThreads, kSmemRows, st>>>(c,
                                                                (int)g.nq);
  ssd_wide_bwd_gates<<<(unsigned)g.bhn, kThreads, 0, st>>>(c);
  return cudaGetLastError();
}
