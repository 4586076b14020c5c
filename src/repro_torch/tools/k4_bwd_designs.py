"""Time K4's backward designs side by side on one card.

    python -m repro_torch.tools.k4_bwd_designs --baseline FILE [--reps 30]
                                               [--designs 0,1,...]
                                               [--out DIR]

(from the checkout root with ``PYTHONPATH=src``). FILE is an earlier
``csrc/ssd_scan_bwd.cu`` (``git show <rev>:src/repro_torch/csrc/
ssd_scan_bwd.cu`` saved under ``build/``; the first design, one block of
f32 FMAs per (b, h), is ``777c599``), built into a library of its own and
called through its C entry ``repro_ssd_scan_bwd``. The current source is
built with two extra entry points: ``probe_bwd`` launches any one of its
instantiations by number (``DESIGNS``), whatever the dispatch picks, and
``probe_occupancy`` reports its registers a thread, shared memory a block,
blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and
clusters the card holds at once (``cudaOccupancyMaxActiveClusters``).

At zamba2-7b's training shape (B 4, S 512, H 112, dk = dv = 64, chunk
128: four chunks; q and k head-stride-0 views of one projection, the
model's gates, the states K4's forward writes) every design runs in its
dtype and is held to ``ssd_scan.bwd_margins`` around the plain backward's
f32 result, with a second launch that must give the same bits; then the
designs are timed in turns, twice (CUDA events, median of ``--reps``
launches queued behind a sleep kernel). Prints one JSON line per design,
ptxas's registers, spills and stack for every backward kernel of the
probe, and the card's ``nvidia-smi`` name and power limit.

    python -m repro_torch.tools.k4_bwd_designs --phases

instead times the phases of the dispatch's bf16 design inside a block: a
copy of the source with ``clock64()`` reads at the phase boundaries
(``PHASES``), run once at the training shape; prints the SM cycles each
phase takes a block (one chunk a block at this shape), averaged over
blocks, for each warp. A read just after a barrier can run before the
warp has waited there, so a warp's wait may land in the phase after it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ssd_scan

# number -> (name, dtype): the cases of probe_bwd below. 0-5 are what
# repro_ssd_scan_bwd dispatches to (ssd_scan_bwd.cu's design()); 6 and 7
# are the tensor-core design with clusters of 2 blocks (runs of 2 chunks
# at the training shape, each staged twice) and of 1 (one block per (b,
# h) walking its chunks).
DESIGNS = {
    0: ("mma bf16, clusters of 4", torch.bfloat16),
    1: ("mma f32, clusters of 4, 3 parts", torch.float32),
    2: ("f32 FMAs bf16, rows in shared memory", torch.bfloat16),
    3: ("f32 FMAs bf16, rows from global memory", torch.bfloat16),
    4: ("f32 FMAs f32, rows in shared memory", torch.float32),
    5: ("f32 FMAs f32, rows from global memory", torch.float32),
    6: ("mma bf16, clusters of 2", torch.bfloat16),
    7: ("mma bf16, one block per (b, h)", torch.bfloat16),
}
WIDTH = {0: 4, 1: 4, 6: 2, 7: 1}        # blocks a (b, h)

PROBE = r"""
#include "ssd_scan_bwd.cu"
using bf = __nv_bfloat16;
// (number, T, launcher, kernel, template arguments, shared bytes at Q)
#define REPRO_DESIGNS(X)                                                    \
  X(0, bf, launch_mma, ssd_chunk_scan_bwd_mma, (bf, 4), Tb<bf>::bytes(Q))  \
  X(1, float, launch_mma, ssd_chunk_scan_bwd_mma, (float, 4),              \
    Tb<float>::bytes(Q))                                                   \
  X(2, bf, launch_fma, ssd_chunk_scan_bwd, (bf, true),                     \
    4 * smem_floats(Q, dk, dv, true))                                      \
  X(3, bf, launch_fma, ssd_chunk_scan_bwd, (bf, false),                    \
    4 * smem_floats(Q, dk, dv, false))                                     \
  X(4, float, launch_fma, ssd_chunk_scan_bwd, (float, true),               \
    4 * smem_floats(Q, dk, dv, true))                                      \
  X(5, float, launch_fma, ssd_chunk_scan_bwd, (float, false),              \
    4 * smem_floats(Q, dk, dv, false))                                     \
  X(6, bf, launch_mma, ssd_chunk_scan_bwd_mma, (bf, 2), Tb<bf>::bytes(Q))  \
  X(7, bf, launch_mma, ssd_chunk_scan_bwd_mma, (bf, 1), Tb<bf>::bytes(Q))
#define REPRO_UNPAREN(...) __VA_ARGS__

extern "C" int probe_bwd(int design, const void* q, const void* k,
                         const void* v, const float* a, const float* i,
                         const float* states, const void* dy,
                         const float* dh_final, int B, int S, int H, int dk,
                         int dv, int Q, long long qsb, long long qss,
                         long long qsh, long long ksb, long long kss,
                         long long ksh, long long vsb, long long vss,
                         long long vsh, void* dq, void* dk_out, void* dv_out,
                         float* da, float* di, float* dh0, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CASE(n, T, launch, kernel, targs, smem)                             \
  case n:                                                                  \
    return launch<REPRO_UNPAREN targs>(                                    \
        static_cast<const T*>(q), static_cast<const T*>(k),                \
        static_cast<const T*>(v), a, i, states, static_cast<const T*>(dy), \
        dh_final, B, S, H, dk, dv, Q, qsb, qss, qsh, ksb, kss, ksh, vsb,   \
        vss, vsh, static_cast<T*>(dq), static_cast<T*>(dk_out),            \
        static_cast<T*>(dv_out), da, di, dh0, st);
  switch (design) { REPRO_DESIGNS(CASE) }
#undef CASE
  return cudaErrorInvalidValue;
}

// registers a thread, shared bytes a block, blocks an SM and clusters the
// card holds at once (blocks an SM over the cluster width where the kernel
// has no cluster) at (dk, dv, Q); call after a first launch, which raised
// the shared-memory limit
extern "C" int probe_occupancy(int design, int dk, int dv, int Q, int grid,
                               int* out) {
#define CASE(n, T, launch, kernel, targs, smem)                             \
  case n: {                                                                \
    auto* fn = kernel<REPRO_UNPAREN targs>;                                \
    cudaFuncAttributes fa;                                                 \
    cudaError_t err = cudaFuncGetAttributes(&fa, fn);                      \
    if (err != cudaSuccess) return err;                                    \
    out[0] = fa.numRegs;                                                   \
    out[1] = (int)(smem);                                                  \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fn, 256,  \
                                                        (int)(smem));      \
    if (err != cudaSuccess) return err;                                    \
    cudaLaunchConfig_t cfg = {};                                           \
    cfg.gridDim = dim3(grid);                                              \
    cfg.blockDim = dim3(256);                                              \
    cfg.dynamicSmemBytes = (size_t)(smem);                                 \
    if (cudaOccupancyMaxActiveClusters(&out[3], fn, &cfg) != cudaSuccess) {\
      cudaGetLastError();                                                  \
      out[3] = -1;                                                         \
    }                                                                      \
    return cudaSuccess;                                                    \
  }
  switch (design) { REPRO_DESIGNS(CASE) }
#undef CASE
  return cudaErrorInvalidValue;
}
"""

# (phase, the source line it ends at, whether the read goes after the line)
PHASES = [
    ("stage q, dy and the gates",
     "    rt::cp_async_wait<1>();           // q and dy are in\n"
     "    __syncthreads();\n", True),
    ("X_n, and (E, Y) published", "  if (t == 0) red[kW] = E;\n", True),
    ("parts of H_n, wait for k and v",
     "    __syncthreads();                  // rows, gates and H_n's parts "
     "are in\n", True),
    ("query positions (dq) and key positions without G",
     "    if (m == hi - 1) exchange();\n", False),
    ("cluster barrier, Horner, G's parts, <H_n, G>",
     "    __syncthreads();                  // G's parts and the row sums "
     "are in\n", True),
    ("key positions: G's terms, dk, dv, di, dcum",
     "    __syncthreads();                  // dcum and w k^T G v are in\n",
     True),
    ("da (warp 0) and G's step",
     "  if (lo == hi) exchange();           // a block without chunks takes "
     "part\n", False),
    ("cluster barrier at exit",
     "  cluster_wait();                     // no block leaves while read\n",
     True),
]
PHASE_START = "  const int tile = nT == kW ? (w < 4 ? w : 11 - w) : w;\n"
MAX_BLOCKS, MAX_WARPS, MAX_PHASES = 2048, 8, 8


def phase_source() -> str:
    """ssd_scan_bwd.cu with clock64() reads at the PHASES boundaries, each
    warp's sums written to ``probe_phase`` at the end."""
    src = (_build.CSRC / "ssd_scan_bwd.cu").read_text()

    def insert(text, anchor, code, after):
        if text.count(anchor) != 1:
            raise RuntimeError(f"phase anchor not found once: {anchor!r}")
        return text.replace(anchor, anchor + code if after else
                            code + anchor)
    src = insert(src, PHASE_START, f"  unsigned long long pt_acc"
                 f"[{MAX_PHASES}] = {{}}, pt_last = clock64();\n", True)
    for i, (_, anchor, after) in enumerate(PHASES):
        code = (f"    {{ const unsigned long long now = clock64(); "
                f"pt_acc[{i}] += now - pt_last; pt_last = now; }}\n")
        if i == len(PHASES) - 1:
            code += (f"  if (lane == 0 && blockIdx.x < {MAX_BLOCKS})\n"
                     f"    for (int x = 0; x < {len(PHASES)}; ++x)\n"
                     f"      probe_phase[(blockIdx.x * {MAX_WARPS} + w) * "
                     f"{MAX_PHASES} + x] = pt_acc[x];\n")
        src = insert(src, anchor, code, after)
    head = ("#include \"common.cuh\"\n__device__ unsigned long long "
            f"probe_phase[{MAX_BLOCKS * MAX_WARPS * MAX_PHASES}];\n")
    return head + src.replace('#include "common.cuh"', "") + r"""
extern "C" int probe_phases(const void* q, const void* k, const void* v,
                            const float* a, const float* i,
                            const float* states, const void* dy, int B,
                            int S, int H, int dk, int dv, int Q,
                            long long qsb, long long qss, long long qsh,
                            long long ksb, long long kss, long long ksh,
                            long long vsb, long long vss, long long vsh,
                            void* dq, void* dk_out, void* dv_out, float* da,
                            float* di, float* dh0, unsigned long long* out,
                            void* stream) {
  using bf = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_mma<bf, kCluster>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), a, i, states, static_cast<const bf*>(dy),
      nullptr, B, S, H, dk, dv, Q, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
      vsh, static_cast<bf*>(dq), static_cast<bf*>(dk_out),
      static_cast<bf*>(dv_out), da, di, dh0, st);
  if (err) return err;
  return cudaMemcpyFromSymbolAsync(out, probe_phase, sizeof(probe_phase), 0,
                                   cudaMemcpyDeviceToHost, st);
}
"""


def _nvcc(src: Path, lib: Path, log: Path) -> ctypes.CDLL:
    res = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(_build.CSRC), "-shared", "-o", str(lib), str(src)],
        capture_output=True, text=True)
    log.write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"build of {src} failed:\n{res.stderr[-4000:]}")
    return ctypes.CDLL(str(lib))


_BWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + \
    [ctypes.c_int64] * 9 + [ctypes.c_void_p] * 7


def build(out_dir: Path, baseline: Path):
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "probe.cu"
    src.write_text(PROBE)
    so = _nvcc(src, out_dir / "libk4bwdprobe.so", out_dir / "ptxas.log")
    so.probe_bwd.argtypes = [ctypes.c_int] + _BWD_ARGS
    so.probe_bwd.restype = ctypes.c_int
    so.probe_occupancy.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    so.probe_occupancy.restype = ctypes.c_int
    # the baseline's own copy, beside the current common.cuh
    base_src = out_dir / "baseline.cu"
    base_src.write_text(Path(baseline).read_text())
    base = _nvcc(base_src, out_dir / "libk4bwdbase.so",
                 out_dir / "ptxas_baseline.log")
    base.repro_ssd_scan_bwd.argtypes = [ctypes.c_void_p] * 8 + \
        [ctypes.c_int] * 7 + [ctypes.c_int64] * 9 + [ctypes.c_void_p] * 7
    base.repro_ssd_scan_bwd.restype = ctypes.c_int
    return so, base


def ptxas_lines(log: Path) -> list:
    """ptxas's registers, spills and stack for each backward kernel."""
    out, name = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        if name and "ssd_chunk_scan_bwd" in name and (
                "spill" in line or "Used" in line):
            out.append(f"{name}: {line.strip()}")
    return out


def inputs(dtype, gen, B=4, S=512, H=112, dk=64, dv=64, chunk=128):
    """The training shape's operands (q, k head-stride-0 views of one
    projection, the model's gates), dy, and the states K4's forward
    writes."""
    dev = torch.device("cuda")
    bc = torch.randn((B, S, 2 * dk), generator=gen, device=dev).to(dtype)
    k = bc[..., :dk][:, :, None].expand(B, S, H, dk)
    q = bc[..., dk:][:, :, None].expand(B, S, H, dk)
    v = torch.randn((B, S, H, dv), generator=gen, device=dev).to(dtype)
    i = F.softplus(torch.randn((B, S, H), generator=gen, device=dev))
    a = i * -torch.linspace(1.0, 16.0, H, device=dev)
    dy = torch.randn((B, S, H, dv), generator=gen, device=dev).to(dtype)
    _, _, states = ssd_scan._launch_fwd(q, k, v, a, i, None, chunk, True)
    return q, k, v, a.contiguous(), i.contiguous(), dy, states


def _outputs(q, v):
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    dev, f32 = q.device, torch.float32
    return (torch.empty((B, S, H, dk), dtype=q.dtype, device=dev),
            torch.empty((B, S, H, dk), dtype=q.dtype, device=dev),
            torch.empty((B, S, H, dv), dtype=q.dtype, device=dev),
            torch.empty((B, S, H), dtype=f32, device=dev),
            torch.empty((B, S, H), dtype=f32, device=dev),
            torch.empty((B, H, dk, dv), dtype=f32, device=dev))


def call(so, design, ops, chunk=128):
    """One launch of ``design`` (a probe number, or "baseline" through the
    baseline library's C entry) → (dq, dk, dv, da, di, dh0)."""
    q, k, v, a, i, dy, states = ops
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    out = _outputs(q, v)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), a.data_ptr(),
            i.data_ptr(), states.data_ptr(), dy.data_ptr(), None]
    tail = [B, S, H, dk, dv, chunk, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *(x.data_ptr() for x in out),
            torch.cuda.current_stream().cuda_stream]
    if design == "baseline":
        err = so.repro_ssd_scan_bwd(*args, int(q.dtype == torch.bfloat16),
                                    *tail)
    else:
        err = so.probe_bwd(design, *args, *tail)
    if err:
        raise RuntimeError(f"design {design}: CUDA error {err}")
    return out


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


def occupancy(so, design, grid):
    out = (ctypes.c_int * 4)()
    err = so.probe_occupancy(design, 64, 64, 128, grid, out)
    if err:
        raise RuntimeError(f"design {design}: CUDA error {err}")
    return {"registers": out[0], "smem_bytes": out[1],
            "blocks_per_sm": out[2], "max_active_clusters": out[3]}


def phases(out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "phases.cu"
    src.write_text(phase_source())
    so = _nvcc(src, out_dir / "libk4bwdphases.so",
               out_dir / "ptxas_phases.log")
    so.probe_phases.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
        [ctypes.c_int64] * 9 + [ctypes.c_void_p] * 8
    so.probe_phases.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)
    ops = inputs(torch.bfloat16, gen)
    q, k, v, a, i, dy, states = ops
    B, S, H, dk = q.shape
    blocks = B * H * 4
    if blocks > MAX_BLOCKS:
        raise RuntimeError(f"{blocks} blocks: the probe keeps {MAX_BLOCKS}")
    buf = torch.zeros(MAX_BLOCKS * MAX_WARPS * MAX_PHASES, dtype=torch.int64)
    for _ in range(2):                  # the second run is the one read
        out = _outputs(q, v)
        err = so.probe_phases(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), a.data_ptr(),
            i.data_ptr(), states.data_ptr(), dy.data_ptr(), B, S, H, dk, dk,
            128, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *(x.data_ptr() for x in out), buf.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"phase probe: CUDA error {err}")
    cyc = buf.view(MAX_BLOCKS, MAX_WARPS, MAX_PHASES)[:blocks, :,
                                                      :len(PHASES)].double()
    for j, (name, _, _) in enumerate(PHASES):
        by_warp = cyc[:, :, j].mean(0)
        print(json.dumps({"phase": name, "cycles_per_block_by_warp":
                          [round(float(x), 1) for x in by_warp]}))
    total = cyc.sum(-1).mean(0)
    print(json.dumps({"phase": "all", "cycles_per_block_by_warp":
                      [round(float(x), 1) for x in total]}))
    print(_smi(), flush=True)


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="an earlier ssd_scan_bwd.cu")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--designs", default=",".join(map(str, DESIGNS)))
    ap.add_argument("--out", default="build/k4_bwd_probe")
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args(argv)
    if args.phases:
        phases(Path(args.out))
        return
    if not args.baseline:
        ap.error("--baseline FILE is needed to time the designs")
    out_dir = Path(args.out)
    so, base = build(out_dir, Path(args.baseline))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    ops = {dt: inputs(dt, gen) for dt in (torch.float32, torch.bfloat16)}
    want = {dt: ssd_scan.ssd_scan_bwd_ref(
        o[0].float(), o[1].float(), o[2].float(), o[3], o[4], o[5], None,
        chunk=128, states=o[6]) for dt, o in ops.items()}
    B, S, H, dk = ops[torch.bfloat16][0].shape
    bound = {dt: ssd_scan.bwd_bound(B, S, H, dk, dk, 128, dt.itemsize,
                                    3.35e12, 989e12, 67e12)["bound_ms"]
             for dt in ops}
    rows = []
    for dt in ops:
        rows.append({"design": "baseline", "name": f"{args.baseline}",
                     "dtype": str(dt), "lib": base, "ops": ops[dt]})
    for d in (int(x) for x in args.designs.split(",")):
        name, dt = DESIGNS[d]
        rows.append({"design": d, "name": name, "dtype": str(dt), "lib": so,
                     "ops": ops[dt]})
    for r in rows:
        dt = r["ops"][0].dtype
        got = call(r["lib"], r["design"], r["ops"])
        again = call(r["lib"], r["design"], r["ops"])
        torch.cuda.synchronize()
        r["margins"] = ssd_scan.bwd_margins(got, want[dt])
        r["bitwise_equal_rerun"] = all(torch.equal(x, y)
                                       for x, y in zip(got, again))
        r["bound_ms"] = bound[dt]
        if r["design"] != "baseline":
            width = WIDTH.get(r["design"], 1)
            occ = occupancy(so, r["design"], B * H * width)
            r.update(occ)
            r["blocks"] = B * H * width
            r["waves"] = r["blocks"] / (sms * max(occ["blocks_per_sm"], 1))
        r["ms"] = []
        del got, again
    for _ in range(2):                   # in turns: a, b, ..., a, b, ...
        for r in rows:
            r["ms"].append(time_ms(
                lambda: call(r["lib"], r["design"], r["ops"]), args.reps))
    for r in rows:
        del r["ops"], r["lib"]
        r["share_of_bound"] = r["bound_ms"] / statistics.mean(r["ms"])
        print(json.dumps(r), flush=True)
    for line in ptxas_lines(out_dir / "ptxas.log") + \
            ptxas_lines(out_dir / "ptxas_baseline.log"):
        print(line, flush=True)
    print(_smi(), flush=True)


if __name__ == "__main__":
    main()
