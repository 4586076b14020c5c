"""Time K4's designs side by side on one card.

    python -m repro_torch.tools.k4_designs [--reps 30] [--heads 112]
                                           [--out DIR]

(from the checkout root with ``PYTHONPATH=src``). Builds a probe library
from ``csrc/ssd_scan.cu`` plus two extra entry points: ``probe_ssd``
launches any one of the source's instantiations by number (``DESIGNS``),
whatever the dispatch of ``repro_ssd_scan`` picks, and
``probe_occupancy`` reports its registers a thread, shared memory a
block and blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).
Each design runs at zamba2-7b's prefill shape (B 4, S 4096, dk = dv = 64,
chunk 128, q and k head-stride-0 views, the model's gates) with each head
count of ``--heads`` (112 is the model's: 448 blocks, one a (b, h)) in its
dtype and is held to ``ssd_scan.excess`` around the plain version's f32
result; then the designs are timed in turns (CUDA events, median of
``--reps`` launches, v and y larger than L2). Prints one JSON line per
design and head count and the card's ``nvidia-smi`` name and power limit.

    python -m repro_torch.tools.k4_designs --phases

instead times the phases of one chunk inside the serve path's design
(bf16, dk = dv = 64, two stages, 8 compute warps): a copy of the source
with ``clock64()`` reads inserted at the phase boundaries (``PHASES``),
run once at the serve shape; prints the SM cycles each phase takes a
chunk, averaged over blocks, for each compute warp. A read just after a
barrier can run before the warp has waited there (the barrier defers its
block), so the cycles a warp waits may land in the phase after it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ssd_scan

# number -> (name, dtype): the cases of probe_ssd below. 1-3 are what
# repro_ssd_scan dispatches to (3 at the serve shape padded to 128); 0 is
# PR 13's ordinary-core design, the f32 yardstick; 4 is 2's shared memory
# with its registers capped so that two blocks fit an SM.
DESIGNS = {
    0: ("f32 ordinary cores, RT 32 (the first design)", torch.float32),
    1: ("mma bf16 64, two stages, 8 warps", torch.bfloat16),
    2: ("mma f32 64, one stage, 3 parts, 8 warps", torch.float32),
    3: ("mma bf16 128, one stage, 16 warps", torch.bfloat16),
    4: ("mma bf16 64, one stage, 8 warps, two blocks an SM",
        torch.bfloat16),
}

PROBE = r"""
#include "ssd_scan.cu"
using bf = __nv_bfloat16;
// (number, T, launcher, kernel, template arguments, threads, shared bytes
// at chunk 128)
#define REPRO_DESIGNS(X)                                                  \
  X(0, float, launch_tile, ssd_chunk_scan, (float, 64, 64, 32),          \
    kSsdThreads, 4 * smem_floats(kMaxQ, 64, 64, 64, 32))                 \
  X(1, bf, launch_mma, ssd_chunk_scan_mma, (bf, 64, 64, false, 8), 256,  \
    (Tc<bf, 64, 64, false, 8>::bytes(kMaxQ)))                            \
  X(2, float, launch_mma, ssd_chunk_scan_mma, (float, 64, 64, true, 8),  \
    256, (Tc<float, 64, 64, true, 8>::bytes(kMaxQ)))                     \
  X(3, bf, launch_mma, ssd_chunk_scan_mma, (bf, 128, 128, true, 16), 512, \
    (Tc<bf, 128, 128, true, 16>::bytes(kMaxQ)))                          \
  X(4, bf, launch_mma, ssd_chunk_scan_mma, (bf, 64, 64, true, 8, 2), 256, \
    (Tc<bf, 64, 64, true, 8>::bytes(kMaxQ)))
#define REPRO_UNPAREN(...) __VA_ARGS__

extern "C" int probe_ssd(int design, const void* q, const void* k,
                         const void* v, const float* a, const float* i,
                         int B, int S, int H, int dk, int dv, int chunk,
                         long long qsb, long long qss, long long qsh,
                         long long ksb, long long kss, long long ksh,
                         long long vsb, long long vss, long long vsh,
                         void* y, float* h, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CASE(n, T, launch, kernel, targs, threads, smem)                  \
  case n:                                                                \
    return launch<REPRO_UNPAREN targs>(                                  \
        static_cast<const T*>(q), static_cast<const T*>(k),              \
        static_cast<const T*>(v), a, i, nullptr, B, S, H, dk, dv, chunk, \
        qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, static_cast<T*>(y), \
        h, st);
  switch (design) { REPRO_DESIGNS(CASE) }
#undef CASE
  return cudaErrorInvalidValue;
}

// registers a thread, shared bytes a block at chunk 128 and blocks an SM
// of one design; call after its first launch, which raised its
// shared-memory limit
extern "C" int probe_occupancy(int design, int* out) {
#define CASE(n, T, launch, kernel, targs, threads, smem)                  \
  case n: {                                                              \
    cudaFuncAttributes fa;                                               \
    cudaError_t err =                                                    \
        cudaFuncGetAttributes(&fa, kernel<REPRO_UNPAREN targs>);         \
    if (err != cudaSuccess) return err;                                  \
    out[0] = fa.numRegs;                                                 \
    out[1] = (int)(smem);                                                \
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(                \
        &out[2], kernel<REPRO_UNPAREN targs>, threads, (int)(smem));     \
  }
  switch (design) { REPRO_DESIGNS(CASE) }
#undef CASE
  return cudaErrorInvalidValue;
}
"""


# (phase, the source line it ends at, whether the read goes after the line)
PHASES = [
    ("wait at the chunk's first barrier",
     "    __syncthreads();          // chunk n's rows, gates and state parts "
     "are in\n", True),
    ("ask for chunk n + 1, split w.v, second barrier",
     "      __syncthreads();        // the w.v parts are in\n", True),
    ("y: q.h, scores, gate, P v, store (warp 0: and the next gates)",
     "    if constexpr (kLean) __syncthreads();   // the state's parts are "
     "read\n", False),
    ("state update",
     "    if (n + 1 < nc) write_hparts(kLean ? 0 : hb ^ 1);\n", False),
    ("state parts for chunk n + 1",
     "    if constexpr (kLean) {\n      __syncthreads();        // every "
     "warp is done", False),
]
PHASE_START = "  const bool even = dv % 2 == 0;"
PHASE_END = "  rt::cp_async_wait<0>();\n#pragma unroll\n  for (int m = 0;"
MAX_BLOCKS, MAX_WARPS = 448, 8


def phase_source() -> str:
    """ssd_scan.cu with clock64() reads at the PHASES boundaries, each
    warp's sums written to ``probe_phase`` at the end."""
    src = (_build.CSRC / "ssd_scan.cu").read_text()

    def insert(text, anchor, code, after):
        if text.count(anchor) != 1:
            raise RuntimeError(f"phase anchor not found once: {anchor!r}")
        return text.replace(anchor, anchor + code if after else
                            code + anchor)
    src = insert(src, PHASE_START, "  unsigned long long pt_acc[8] = {}, "
                 "pt_last = clock64();\n", False)
    for i, (_, anchor, after) in enumerate(PHASES):
        src = insert(src, anchor, f"    {{ const unsigned long long now = "
                     f"clock64(); pt_acc[{i}] += now - pt_last; pt_last = "
                     f"now; }}\n", after)
    src = insert(src, PHASE_END, "  if (lane == 0 && blockIdx.x < "
                 f"{MAX_BLOCKS} && w < {MAX_WARPS})\n    for (int i = 0; "
                 f"i < {len(PHASES)}; ++i)\n      probe_phase[(blockIdx.x * "
                 f"{MAX_WARPS} + w) * 8 + i] = pt_acc[i];\n", False)
    head = ("#include \"common.cuh\"\n__device__ unsigned long long "
            f"probe_phase[{MAX_BLOCKS * MAX_WARPS * 8}];\n")
    return head + src.replace('#include "common.cuh"', "") + r"""
extern "C" int probe_phases(const void* q, const void* k, const void* v,
                            const float* a, const float* i, int B, int S,
                            int H, int dk, int dv, int chunk, long long qsb,
                            long long qss, long long qsh, long long ksb,
                            long long kss, long long ksh, long long vsb,
                            long long vss, long long vsh, void* y, float* h,
                            unsigned long long* out, void* stream) {
  using bf = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_mma<bf, 64, 64, false, 8>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), a, i, nullptr, B, S, H, dk, dv, chunk, qsb,
      qss, qsh, ksb, kss, ksh, vsb, vss, vsh, static_cast<bf*>(y), h, st);
  if (err) return err;
  return cudaMemcpyFromSymbolAsync(out, probe_phase, sizeof(probe_phase), 0,
                                   cudaMemcpyDeviceToHost, st);
}
"""


def phases(out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "phases.cu"
    src.write_text(phase_source())
    lib = out_dir / "libk4phases.so"
    res = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-shared", "-o", str(lib), str(src)], capture_output=True,
        text=True)
    if res.returncode != 0:
        raise RuntimeError(f"phase build failed:\n{res.stderr[-4000:]}")
    so = ctypes.CDLL(str(lib))
    so.probe_phases.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
        [ctypes.c_int64] * 9 + [ctypes.c_void_p] * 4
    so.probe_phases.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, a, i = inputs(torch.bfloat16, gen)
    B, S, H, dk = q.shape
    out = torch.zeros(MAX_BLOCKS * MAX_WARPS * 8, dtype=torch.int64)
    for _ in range(2):                  # the second run is the one read
        y = torch.empty_like(v)
        h = torch.empty((B, H, dk, dk), dtype=torch.float32,
                        device=v.device)
        err = so.probe_phases(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              a.data_ptr(), i.data_ptr(), B, S, H, dk, dk,
                              128, *q.stride()[:3], *k.stride()[:3],
                              *v.stride()[:3], y.data_ptr(), h.data_ptr(),
                              out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"phase probe: CUDA error {err}")
    per_chunk = out.view(MAX_BLOCKS, MAX_WARPS, 8)[:B * H, :, :len(PHASES)]
    per_chunk = per_chunk.double() / (S // 128)
    for j, (name, _, _) in enumerate(PHASES):
        by_warp = per_chunk[:, :, j].mean(0)
        print(json.dumps({"phase": name,
                          "cycles_per_chunk_by_warp": [round(float(x), 1)
                                                       for x in by_warp]}))
    total = per_chunk.sum(-1).mean(0)
    print(json.dumps({"phase": "all", "cycles_per_chunk_by_warp":
                      [round(float(x), 1) for x in total]}))


def build(out_dir: Path) -> ctypes.CDLL:
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "probe.cu"
    src.write_text(PROBE)
    lib = out_dir / "libk4probe.so"
    res = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(_build.CSRC), "-shared", "-o", str(lib), str(src)],
        capture_output=True, text=True)
    (out_dir / "ptxas.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"probe build failed:\n{res.stderr[-4000:]}")
    so = ctypes.CDLL(str(lib))
    so.probe_ssd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 6 + [ctypes.c_int64] * 9 + [ctypes.c_void_p] * 3
    so.probe_ssd.restype = ctypes.c_int
    so.probe_occupancy.argtypes = [ctypes.c_int, ctypes.c_void_p]
    so.probe_occupancy.restype = ctypes.c_int
    return so


def inputs(dtype, gen, B=4, S=4096, H=112, dk=64, dv=64):
    """The serve shape's operands: q and k head-stride-0 views of one
    (B, S, 2 dk) projection, v (B, S, H, dv), the model's gates."""
    dev = torch.device("cuda")
    bc = torch.randn((B, S, 2 * dk), generator=gen, device=dev).to(dtype)
    k = bc[..., :dk][:, :, None].expand(B, S, H, dk)
    q = bc[..., dk:][:, :, None].expand(B, S, H, dk)
    v = torch.randn((B, S, H, dv), generator=gen, device=dev).to(dtype)
    i = F.softplus(torch.randn((B, S, H), generator=gen, device=dev))
    a = i * -torch.linspace(1.0, 16.0, H, device=dev)
    return q, k, v, a, i


def call(so, design, q, k, v, a, i, chunk=128):
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    y = torch.empty((B, S, H, dv), dtype=v.dtype, device=v.device)
    h = torch.empty((B, H, dk, dv), dtype=torch.float32, device=v.device)
    err = so.probe_ssd(design, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       a.data_ptr(), i.data_ptr(), B, S, H, dk, dv, chunk,
                       *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                       y.data_ptr(), h.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"design {design}: CUDA error {err}")
    return y, h


def time_ms(fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def occupancy(so, design):
    out = (ctypes.c_int * 3)()
    err = so.probe_occupancy(design, out)
    if err:
        raise RuntimeError(f"design {design}: CUDA error {err}")
    return {"registers": out[0], "smem_bytes": out[1],
            "blocks_per_sm": out[2]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--designs", default=",".join(map(str, DESIGNS)))
    ap.add_argument("--heads", default="112",
                    help="head counts, comma-separated (B = 4)")
    ap.add_argument("--out", default="build/k4_probe")
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args(argv)
    if args.phases:
        phases(Path(args.out))
        return
    so = build(Path(args.out))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    designs = [int(x) for x in args.designs.split(",")]
    rows = []
    for H in (int(x) for x in args.heads.split(",")):
        gen = torch.Generator(device="cuda").manual_seed(0)
        ops = {dt: inputs(dt, gen, H=H)
               for dt in (torch.float32, torch.bfloat16)}
        for dt, (q, k, v, a, i) in ops.items():
            y32, h32 = ssd_scan.ssd_scan_ref(q.float(), k.float(), v.float(),
                                             a, i, chunk=128)
            for d in designs:
                name, ddt = DESIGNS[d]
                if ddt != dt:
                    continue
                y, h = call(so, d, q, k, v, a, i)
                y2, h2 = call(so, d, q, k, v, a, i)
                torch.cuda.synchronize()
                occ = occupancy(so, d)
                blocks = q.shape[0] * H
                rows.append({
                    "design": d, "name": name, "dtype": str(dt), "H": H,
                    "blocks": blocks, **occ,
                    "waves": blocks / (sms * occ["blocks_per_sm"]),
                    "excess_y": ssd_scan.excess(y, y32, ssd_scan.RTOL[dt]),
                    "excess_state": ssd_scan.excess(h, h32),
                    "max_abs_err": float((y.float() - y32).abs().max()),
                    "bitwise_equal_rerun": bool(torch.equal(y, y2)
                                                and torch.equal(h, h2)),
                    "ms": [], "ops": ops[dt]})
            del y32, h32
    for _ in range(2):                   # in turns: a, b, ..., a, b, ...
        for r in rows:
            q, k, v, a, i = r["ops"]
            r["ms"].append(time_ms(
                lambda: call(so, r["design"], q, k, v, a, i), args.reps))
    for r in rows:
        del r["ops"]
        print(json.dumps(r), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
