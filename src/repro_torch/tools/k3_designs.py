"""Time K3 against its earlier design and the designs that lost to it, on
one card.

    python -m repro_torch.tools.k3_designs --baseline FILE [--reps 30]
                                           [--shapes ...] [--out DIR]

(from the checkout root with ``PYTHONPATH=src``). At each shape
``W:dtype`` (default: PERF.md §6's W 16, 4096 and 10240 at D = 21840 and
the LLM round's flat pack, W 8 at D = 134,515,008 bf16; ``W:dtype:D``
names another D) it times:

- ``baseline``: ``--baseline FILE``, the earlier two-launch design of
  ``csrc/fused_async_agg.cu`` (``git show
  <rev>:src/repro_torch/csrc/fused_async_agg.cu``, whose C entry takes a
  row count and a partials buffer), through its own C entry, with its
  (cdiv(W, 128), D) partials allocated a call as its wrapper did;
- ``library``: ``fused_round.fused_async_agg``, the library's kernel in
  ``fused_round.plan``;
- the library's kernel, through its C entry, in other plans: 32 to 256
  threads a block, in the row splits that give 1, 2, 4 and 8 waves of
  132 blocks;
- ``VARIANTS``: copies of ``csrc/fused_async_agg.cu`` changed by text
  substitution (each must match once): other row batches, the evict-first
  hint (``ld/st .cs``) on some streams, 256-byte L2 prefetches;
- ``BULK``: rows brought in by the bulk copy engine, 8 rows x 4 stages of
  u and pending strips in a ring in shared memory on mbarriers, as K1
  does, with new pending stored from registers or bulk-stored from
  shared memory.

Every design is held to the plain version (the aggregate within 1e-4 of
its largest value, the new pending buffer equal) and two launches must
give the same bits; then the designs are timed in turns, twice (CUDA
events, median of ``--reps`` launches queued behind a sleep kernel).
Prints one JSON line per shape and design with the byte bound at 3.35
TB/s, one line with the time and rate of a PyTorch copy of pending (a
stream of reads and writes, the yardstick of what the card reaches), then
the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fused_round as K3

HBM = 3.35e12            # bytes/s of an H100 SXM
D_PAPER = 21840
D_LLM = 134_515_008

# the lines of csrc/fused_async_agg.cu the variants change
_BATCH = "constexpr int kBatchRows = 16;"
_LOAD_U = "xu[i] = __ldg(uc + row * ustep);"
_LOAD_P = "xp[i][j] = __ldg(pc + row * pstep + j);"
_STORE = "oc[row * pstep + j] = q[j];"
_INCLUDE = '#include "common.cuh"\n'

_L2_256 = r"""
// 256-byte L2 prefetch on 16-byte loads; other loads as before
template <typename R>
__device__ __forceinline__ R ld_l2_256(const R* p) { return __ldg(p); }
__device__ __forceinline__ uint4 ld_l2_256(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ float4 ld_l2_256(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}
"""

_EVICT_U = (_LOAD_U, "xu[i] = __ldcs(uc + row * ustep);")
_EVICT_P = (_LOAD_P, "xp[i][j] = __ldcs(pc + row * pstep + j);")
_EVICT_ST = (_STORE, "__stcs(oc + row * pstep + j, q[j]);")


def _rows(n):
    return (_BATCH, f"constexpr int kBatchRows = {n};")


# name -> the (old, new) substitutions that make the variant
VARIANTS = {
    "8 rows": [_rows(8)],
    "4 rows": [_rows(4)],
    "8 rows, evict-first on all streams (the first design)":
        [_rows(8), _EVICT_U, _EVICT_P, _EVICT_ST],
    "evict-first on all streams": [_EVICT_U, _EVICT_P, _EVICT_ST],
    "evict-first on u": [_EVICT_U],
    "evict-first on the stores": [_EVICT_ST],
    "256-byte L2 prefetch on the loads":
        [(_INCLUDE, _INCLUDE + _L2_256),
         (_LOAD_U, "xu[i] = ld_l2_256(uc + row * ustep);"),
         (_LOAD_P, "xp[i][j] = ld_l2_256(pc + row * pstep + j);")],
}

BULK = r"""
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(rt::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(rt::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_s2g(void* dst, const void* src,
                                         int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(rt::smem_u32(src)), "r"(bytes)
               : "memory");
}

// Block (x, s) as in fused_async_agg_tiles (16-byte pieces only). Thread 0
// brings kRows rows of the tile's u and pending strips a stage into a ring
// of kStages stages; every thread reads its pieces from shared memory.
template <typename T, int kRows, int kStages, bool kBulkStore>
__global__ void __launch_bounds__(kMaxThreads)
k3_bulk(const T* __restrict__ u, const float* __restrict__ pending,
        const float* __restrict__ weights, const float* __restrict__ keep,
        int W, int D, int rows, int* __restrict__ count,
        float* __restrict__ part, float* __restrict__ agg,
        float* __restrict__ new_pending) {
  constexpr int N = 16 / sizeof(T);
  constexpr int NP = N / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nt = blockDim.x, x = threadIdx.x;
  const int ubytes = nt * 16, pbytes = nt * 16 * NP;
  const int stage = kRows * (ubytes + pbytes * (kBulkStore ? 2 : 1));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kStages * stage);
  const int S = gridDim.y, s = blockIdx.y;
  const int r0 = s * rows, r1 = min(W, r0 + rows);
  const int64_t c0 = (int64_t)blockIdx.x * nt * N;
  const int cols = (int)min((int64_t)nt * N, (int64_t)D - c0);
  const int ub = cols * (int)sizeof(T), pb = cols * 4;
  const int nb = rt::cdiv(r1 - r0, kRows);
  auto su = [&](int st, int i) { return smem + st * stage + i * ubytes; };
  auto sp = [&](int st, int i) {
    return smem + st * stage + kRows * ubytes + i * pbytes;
  };
  auto so = [&](int st, int i) {
    return smem + st * stage + kRows * (ubytes + pbytes) + i * pbytes;
  };
  if (x == 0) {
    for (int i = 0; i < kStages; ++i) rt::mbar_init(bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int b) {
    const int st = b % kStages, ra = r0 + b * kRows;
    const int n = min(kRows, r1 - ra);
    rt::mbar_expect(bar + st, n * (ub + pb));
    for (int i = 0; i < n; ++i) {
      bulk_g2s(su(st, i), u + (int64_t)(ra + i) * D + c0, ub, bar + st);
      bulk_g2s(sp(st, i), pending + (int64_t)(ra + i) * D + c0, pb,
               bar + st);
    }
  };
  if (x == 0)
    for (int b = 0; b < min(kStages, nb); ++b) issue(b);
  const bool live = x * N < cols;
  const int64_t d0 = c0 + (int64_t)x * N;
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  for (int b = 0; b < nb; ++b) {
    const int st = b % kStages, ra = r0 + b * kRows;
    const int n = min(kRows, r1 - ra);
    rt::mbar_wait(bar + st, (b / kStages) & 1);
    if constexpr (kBulkStore) {
      if (b >= kStages) {           // this stage's last bulk store has read
        if (x == 0)
          asm volatile("cp.async.bulk.wait_group.read %0;\n"
                       ::"n"(kStages - 1) : "memory");
        __syncthreads();
      }
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (i < n) {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(su(st, i) + x * 16);
          const T* e = reinterpret_cast<const T*>(&raw);
          const float* p = reinterpret_cast<const float*>(sp(st, i) +
                                                          x * 16 * NP);
          float4 q[NP];
          float* qf = reinterpret_cast<float*>(q);
          const float k = __ldg(keep + ra + i), w = __ldg(weights + ra + i);
#pragma unroll
          for (int m = 0; m < N; ++m) {
            const float t = rt::to_f32(e[m]) + p[m];
            qf[m] = t * k;
            acc[m] += w * t;
          }
          float4* o = kBulkStore
              ? reinterpret_cast<float4*>(so(st, i) + x * 16 * NP)
              : reinterpret_cast<float4*>(new_pending +
                                          (int64_t)(ra + i) * D + d0);
#pragma unroll
          for (int j = 0; j < NP; ++j) o[j] = q[j];
        }
      }
    }
    if constexpr (kBulkStore)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                  // stage st read by every thread
    if (x == 0) {
      if constexpr (kBulkStore) {
        for (int i = 0; i < n; ++i)
          bulk_s2g(new_pending + (int64_t)(ra + i) * D + c0, so(st, i), pb);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      if (b + kStages < nb) issue(b + kStages);
    }
  }
  if constexpr (kBulkStore) {
    if (x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
  if (S == 1) {
    if (live) rt::store_f32<N>(agg + d0, acc);
    return;
  }
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
  rt::store_f32<N>(agg + d0, sum);
}

template <typename T, bool kBulkStore>
cudaError_t go(const void* u, const float* pending, const float* weights,
               const float* keep, int W, int D, int threads, int splits,
               int* count, float* part, float* agg, float* new_pending,
               cudaStream_t st) {
  constexpr int N = 16 / sizeof(T), kRows = 8, kStages = 4;
  if (D % N != 0 || threads % 32 != 0 || threads > kMaxThreads ||
      splits < 1 || splits > W || (splits > 1 && (!count || !part)))
    return cudaErrorInvalidValue;
  const int stage = kRows * threads * 16 *
                    (1 + (N / 4) * (kBulkStore ? 2 : 1));
  const int bytes = kStages * stage + kStages * 8;
  auto kern = k3_bulk<T, kRows, kStages, kBulkStore>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();            // leave no error for the next launch
    return err;
  }
  const dim3 grid(rt::cdiv(rt::cdiv(D, N), threads), splits);
  kern<<<grid, threads, bytes, st>>>(static_cast<const T*>(u), pending,
                                     weights, keep, W, D,
                                     rt::cdiv(W, splits), count, part, agg,
                                     new_pending);
  return cudaGetLastError();
}

}  // namespace

extern "C" int probe_k3_bulk(int bulk_store, const void* u, int bf16,
                             const float* pending, const float* weights,
                             const float* keep, int W, int D, int threads,
                             int splits, int* count, float* part,
                             float* agg, float* new_pending, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K3_ARGS u, pending, weights, keep, W, D, threads, splits, count, \
                part, agg, new_pending, st
  if (bf16)
    return bulk_store ? go<__nv_bfloat16, true>(K3_ARGS)
                      : go<__nv_bfloat16, false>(K3_ARGS);
  return bulk_store ? go<float, true>(K3_ARGS) : go<float, false>(K3_ARGS);
#undef K3_ARGS
}
"""

_P, _I = ctypes.c_void_p, ctypes.c_int


def variant_source(subs) -> str:
    src = (_build.CSRC / "fused_async_agg.cu").read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"{old!r} is not in csrc/fused_async_agg.cu "
                               f"once: the variant no longer applies")
        src = src.replace(old, new)
    return src


def build(out_dir: Path, baseline: Path):
    """Compile the variants, the bulk-copy designs and the baseline, all
    at once (one nvcc each): {name: CDLL}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = {"bulk": BULK}
    srcs.update({f"variant_{i}": variant_source(subs)
                 for i, subs in enumerate(VARIANTS.values())})
    jobs = {}
    for name, text in srcs.items():
        (out_dir / f"{name}.cu").write_text(text)
    for name in [*srcs, "baseline"]:
        src = baseline if name == "baseline" else out_dir / f"{name}.cu"
        jobs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(_build.CSRC), "-shared", "-o", str(out_dir / f"{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, job in jobs.items():
        log = job.communicate()[0]
        (out_dir / f"{name}.log").write_text(log)
        if job.returncode != 0:
            raise RuntimeError(f"build of {name} failed:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(out_dir / f"{name}.so"))
    libs["bulk"].probe_k3_bulk.argtypes = [_I, _P, _I, _P, _P, _P] + \
        [_I] * 4 + [_P] * 5
    libs["baseline"].repro_fused_async_agg.argtypes = [
        _P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P]
    for name in srcs:
        if name.startswith("variant_"):
            libs[name].repro_fused_async_agg.argtypes = \
                _build._SIGNATURES["repro_fused_async_agg"]
    for lib in libs.values():
        for fn in ("probe_k3_bulk", "repro_fused_async_agg"):
            if hasattr(lib, fn):
                getattr(lib, fn).restype = _I
    return libs


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def plan_at(W, D, itemsize, threads, splits):
    """``fused_round.plan``'s pieces with ``threads`` and ``splits``
    pinned."""
    vec = K3.plan(W, D, itemsize).vec
    tiles = -(-(-(-D // vec)) // threads)
    rows = -(-W // max(1, min(W, splits)))
    return K3.Plan(vec, threads, tiles, -(-W // rows), rows)


def call(entry, p, u, pending, weights, keep, bulk_store=None):
    """One launch of a C entry with the library's arguments (with
    ``bulk_store``, the bulk-copy probe's) in plan ``p``: (agg,
    new_pending)."""
    W, D = u.shape
    cnt = part = None
    if p.splits > 1:
        cnt, part = _build.scratch("k3_probe", u.device, p.tiles,
                                   p.splits * D)
    agg = torch.empty((D,), dtype=torch.float32, device=u.device)
    newp = torch.empty((W, D), dtype=torch.float32, device=u.device)
    args = [u.data_ptr(), int(u.dtype == torch.bfloat16), pending.data_ptr(),
            weights.data_ptr(), keep.data_ptr(), W, D, p.threads, p.splits,
            _build.ptr(cnt), _build.ptr(part), agg.data_ptr(),
            newp.data_ptr(), _stream()]
    if bulk_store is None:
        args.insert(7, p.vec)
        err = entry(*args)
    else:
        err = entry(int(bulk_store), *args)
    if err:
        raise RuntimeError(f"plan {p}: CUDA error {err}")
    return agg, newp


def baseline_call(old, u, pending, weights, keep, rows=128):
    """The two-launch design's wrapper: partials of cdiv(W, 128) rows
    allocated a call."""
    W, D = u.shape
    f32 = dict(dtype=torch.float32, device=u.device)
    partial = torch.empty((-(-W // rows), D), **f32)
    agg = torch.empty((D,), **f32)
    newp = torch.empty((W, D), **f32)
    err = old.repro_fused_async_agg(
        u.data_ptr(), int(u.dtype == torch.bfloat16), pending.data_ptr(),
        weights.data_ptr(), keep.data_ptr(), W, D, rows, partial.data_ptr(),
        agg.data_ptr(), newp.data_ptr(), _stream())
    if err:
        raise RuntimeError(f"the two-launch design: CUDA error {err}")
    return agg, newp


def time_ms(fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def designs(libs, W, D, isz):
    """(label, plan, call on (u, pending, weights, keep)) of each design
    at a shape."""
    lib = K3.plan(W, D, isz)
    out = [("baseline", None, lambda *a: baseline_call(libs["baseline"], *a)),
           ("library", lib, K3.fused_async_agg)]
    entry = _build.load().repro_fused_async_agg
    swept = set()
    for t in (32, 64, 128, 256):
        tiles = plan_at(W, D, isz, t, 1).tiles
        for waves in (1, 2, 4, 8):
            p = plan_at(W, D, isz, t, -(-(waves * K3.SMS) // tiles))
            if (t, p.splits) not in swept:
                swept.add((t, p.splits))
                out.append((f"library kernel, {t} threads, {p.splits} "
                            f"splits", p, lambda *a, p=p: call(entry, p, *a)))
    for i, name in enumerate(VARIANTS):
        fn = libs[f"variant_{i}"].repro_fused_async_agg
        out.append((name, lib, lambda *a, fn=fn: call(fn, lib, *a)))
    bulk = libs["bulk"].probe_k3_bulk
    for label, t, store in (("bulk-copy ring", 32, False),
                            ("bulk-copy ring", 128, False),
                            ("bulk-copy ring, bulk stores", 32, True)):
        p = plan_at(W, D, isz, t, lib.splits)
        out.append((f"{label}, {t} threads", p,
                    lambda *a, p=p, s=store: call(bulk, p, *a,
                                                  bulk_store=s)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    help="the two-launch fused_async_agg.cu, to time beside")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--shapes", default=f"16:f32,4096:f32,4096:bf16,"
                    f"10240:f32,8:bf16:{D_LLM}")
    ap.add_argument("--out", default="build/k3_probe")
    args = ap.parse_args(argv)
    libs = build(Path(args.out), args.baseline)
    dev = torch.device("cuda")
    for shape in args.shapes.split(","):
        parts = shape.split(":")
        W, dt = int(parts[0]), parts[1]
        D = int(parts[2]) if len(parts) > 2 else D_PAPER
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
        gen = torch.Generator(device=dev).manual_seed(W + D)
        u = torch.randn((W, D), generator=gen, device=dev).to(dtype)
        pending = torch.randn((W, D), generator=gen, device=dev)
        weights = torch.rand((W,), generator=gen, device=dev)
        keep = (torch.rand((W,), generator=gen, device=dev) > 0.5).float()
        args4 = (u, pending, weights, keep)
        want_agg, want_newp = K3.fused_async_agg_ref(*args4)
        tol = 1e-4 * max(1.0, float(want_agg.abs().max()))
        bound = K3.hbm_bytes(W, D, u.element_size())["minimum"] / HBM * 1e3
        rows = designs(libs, W, D, u.element_size())
        results = []
        for label, p, fn in rows:
            r = {"W": W, "D": D, "dtype": dt, "design": label,
                 "plan": p._asdict() if p else None, "ok": False, "ms": [],
                 "bound_ms": bound}
            results.append(r)
            try:             # a design the card refuses (shared memory)
                a1, n1 = fn(*args4)
                torch.cuda.synchronize()
            except RuntimeError as e:
                r["error"] = str(e)
                continue
            r["max_abs_err"] = float((a1 - want_agg).abs().max())
            r["ok"] = bool(r["max_abs_err"] <= tol
                           and torch.equal(n1, want_newp))
            del n1
            a2, n2 = fn(*args4)
            r["bitwise_equal_rerun"] = bool(torch.equal(a1, a2))
            del a1, a2, n2
        del want_newp
        torch.cuda.empty_cache()
        for _ in range(2):               # in turns: a, b, ..., a, b, ...
            for r, (_, _, fn) in zip(results, rows):
                if r["ok"]:
                    r["ms"].append(time_ms(lambda: fn(*args4), args.reps))
        for r in results:
            print(json.dumps(r), flush=True)
        # the card's rate for a stream of reads and writes: one copy of
        # pending (W * D f32 read and written), timed the same way
        dst = torch.empty_like(pending)
        copy = [time_ms(lambda: dst.copy_(pending), args.reps)
                for _ in range(2)]
        print(json.dumps({"W": W, "D": D, "dtype": dt,
                          "yardstick": "torch copy_ of pending", "ms": copy,
                          "bytes": 2 * pending.numel() * 4,
                          "TB_per_s": 2 * pending.numel() * 4
                          / statistics.mean(copy) / 1e9}), flush=True)
        del dst, u, pending, weights, keep, args4, rows
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
