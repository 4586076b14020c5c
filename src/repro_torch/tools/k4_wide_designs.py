"""Time K4's wide-path designs side by side on one card.

    python -m repro_torch.tools.k4_wide_designs --baseline FILE [--reps 20]
                                                [--out DIR]

(from the checkout root with ``PYTHONPATH=src``). FILE is the first wide
design, ``csrc/ssd_scan_wide.cu`` as it was at ``f5f169e`` (``git show
f5f169e:src/repro_torch/csrc/ssd_scan_wide.cu`` saved under ``build/``):
f32 FMAs on the ordinary cores, the gated scores of every (b, h, chunk) in
one launch, then 1,040 blocks of 16 state columns walking the chunks.
Each candidate is built by ``nvcc`` into a library of its own (all at
once) and called through its C entry ``repro_ssd_scan_wide``:

- ``first``: FILE as it is;
- ``first_scores``: FILE without its second launch (the scores alone);
- ``first_fma2x``: FILE with every FMA of its second launch done twice
  (wrong results, timed only): the time it adds is what the FMA issue
  costs, which tells FMA-bound from bound by the operands' traffic;
- ``a``: the current ``csrc/ssd_scan_wide.cu``, design (a), the
  chunk-parallel split (operands split into bf16 parts by a launch of
  their own, the states before each chunk, then y; ``mma.sync``);
- ``a_wgmma``: ``tools/k4_wide/wgmma.cu``, the same split with its
  products as ``wgmma`` from shared memory;
- ``a_split_in_kernel``: ``tools/k4_wide/split_in_kernel.cu``, the same
  split in two launches, each block splitting its f32 operands itself;
- ``b``: ``tools/k4_wide/walk_cluster.cu``, design (b), the sequential
  walk: a cluster of 8 blocks per (b, h) and 128 state columns, each
  block 128 state rows in its accumulators, the partial q . h of the 8
  summed in a fixed order through distributed shared memory.

``a`` and ``a_wgmma`` go through a probe that also runs their first one
or two launches alone (``_upto1``, ``_upto2``: the launches' shares by
difference) and reports each kernel's registers, shared memory and
blocks an SM; with them come copies of their source that leave one part
of the work out (``VARIANTS``, wrong results, timed only).

At xlstm-1.3b's prefill shape (B 4, S 1024, H 4, dk 1024, dv 1025, chunk
256) with mLSTM's gates, every candidate that computes the function is
held to ``ssd_scan.excess`` around the plain version's f32 result, with f32
q, k, v and with bf16-valued ones (the serve's), and must give the same
bits twice; then every candidate is timed in turns, twice (CUDA events,
median of ``--reps`` calls queued behind a sleep kernel), on the
bf16-valued inputs. Prints one JSON line per candidate, ptxas's registers
and spills for each kernel, and the card's ``nvidia-smi`` name and power
limit. A candidate that fails to build prints its error and is left out.
Not run by ``chip_smoke.py``.
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

SERVE = dict(B=4, S=1024, H=4, dk=1024, dv=1025, chunk=256)
CANDIDATES = Path(__file__).resolve().parent / "k4_wide"

PROBE = r"""
#include "ssd_scan_wide.cu"
// the first `launches` launches of a call (1 to 3)
extern "C" int probe_upto(int launches, const float* q, const float* k,
                          const float* v, const float* a, const float* i,
                          const float* h0, int B, int S, int H, int dk,
                          int dv, int chunk, long long qsb, long long qss,
                          long long qsh, long long ksb, long long kss,
                          long long ksh, long long vsb, long long vss,
                          long long vsh, void* scratch,
                          long long scratch_bytes, float* y, float* h_out,
                          void* stream) {
  return launch_wide(q, k, v, a, i, h0, B, S, H, dk, dv, chunk, qsb, qss,
                     qsh, ksb, kss, ksh, vsb, vss, vsh, scratch,
                     scratch_bytes, y, h_out,
                     static_cast<cudaStream_t>(stream), launches);
}
// registers a thread, shared bytes a block and blocks an SM of kernel
// n (0 split, 1 chunks, 2 y); call after a first call
extern "C" int probe_occupancy(int n, int* out) {
  const void* fn = n == 0 ? (const void*)ssd_wide_split
                 : n == 1 ? (const void*)ssd_wide_chunks<false>
                          : (const void*)ssd_wide_y;
  const int smem = n == 0 ? 0 : n == 1 ? kSmem1 : kSmem2;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = smem + (int)fa.sharedSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fn, kThreads,
                                                       smem);
}
"""

# the first design's second launch: its two FMA sites, each done twice
FMA2X = [
    ("          fma4x4(acc, x, hv);\n",
     "          fma4x4(acc, x, hv);\n          fma4x4(acc, x, hv);\n"),
    ("            up[r][3] = fmaf(kr[r], wr.w, up[r][3]);\n",
     "            up[r][3] = fmaf(kr[r], wr.w, up[r][3]);\n"
     "            up[r][0] = fmaf(kr[r], wr.x, up[r][0]);\n"
     "            up[r][1] = fmaf(kr[r], wr.y, up[r][1]);\n"
     "            up[r][2] = fmaf(kr[r], wr.z, up[r][2]);\n"
     "            up[r][3] = fmaf(kr[r], wr.w, up[r][3]);\n"),
]
NO_LAUNCH2 = [("  ssd_wide_state<<<(unsigned)g2,",
               "  if (g2 < 0) ssd_wide_state<<<(unsigned)g2,")]
# copies of a design's source that leave one part of the work out (wrong
# results, timed only): the states' writes for launch 2, the copies' misses
# in L2 (every slab's copies read one of the first slabs' addresses
# instead), the products, the copies; for the wgmma candidate also the
# proxy fence before its barrier and core matrices padded by 16 bytes
_COMMON = {
    "no_state_writes": [(
        "      if (n > 0 || c.h0) {             // launch 2 reads no zero "
        "state\n", "      if (false) {\n")],
    "hot_slabs": [("    if (next < G) stage(next, next % NS);\n",
                   "    if (next < G) stage(next % NS, next % NS);\n")],
    "no_copies": [("    if (g < G) stage(g, g);\n",
                   "    if (g < 0) stage(g, g);\n"),
                  ("    if (next < G) stage(next, next % NS);\n",
                   "    if (next < 0) stage(next, next % NS);\n")],
}
VARIANTS = {
    "a": {**_COMMON, "no_products": [(
        "  const int l7 = lane & 7,", "  if (na > 0) return;\n"
                                     "  const int l7 = lane & 7,")]},
    "a_wgmma": {
        **_COMMON,
        "no_products": [("  const int wg = threadIdx.x >> 7;\n",
                         "  if (na > 0) return;\n"
                         "  const int wg = threadIdx.x >> 7;\n")],
        "no_fence": [('    asm volatile("fence.proxy.async.shared::cta;\\n" '
                      '::: "memory");\n', "")],
        **{f"pad16{x}": [("constexpr int kPadK = 0, kPadW = 0;",
                          f"constexpr int kPadK = {16 * ('k' in x)}, "
                          f"kPadW = {16 * ('w' in x)};")]
           for x in ("k", "w", "kw")},
    },
}
TIMED_ONLY = ("first_scores", "first_fma2x",
              *(f"{d}_{v}" for d, vs in VARIANTS.items() for v in vs))


def substitute(text: str, subs) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"anchor not found once: {old!r}")
        text = text.replace(old, new)
    return text


def substitute_with_common(text: str, common: str, subs):
    """``subs`` applied to a kernel's source and, for an anchor the source
    does not hold (a helper of ``csrc/common.cuh``), to its copy of
    common.cuh; each anchor must be found once in one of them. Returns
    (source, common.cuh)."""
    for old, new in subs:
        if text.count(old) == 0 and common.count(old) == 1:
            common = common.replace(old, new)
        else:
            text = substitute(text, [(old, new)])
    return text, common


def write_candidate(out_dir: Path, name: str, text: str, common: str,
                    probe: str, include: str) -> str:
    """A candidate's source and its own copy of common.cuh into out_dir /
    name (an include of "common.cuh" there finds that copy first); returns
    the probe's text, whose ``#include "<include>"`` now names the copy."""
    sub = out_dir / name
    sub.mkdir(parents=True, exist_ok=True)
    (sub / "src.cu").write_text(text)
    (sub / "common.cuh").write_text(common)
    return probe.replace(f'"{include}"', f'"{name}/src.cu"')


_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 9


def build(out_dir: Path, baseline: Path) -> dict:
    """Every candidate's source into out_dir, built in parallel; returns
    name -> (library, ptxas log path)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    base = Path(baseline).read_text()
    sources = {
        "first": base,
        "first_scores": substitute(base, NO_LAUNCH2),
        "first_fma2x": substitute(base, FMA2X),
    }
    designs = {"a": (_build.CSRC / "ssd_scan_wide.cu").read_text()}
    for path in sorted(CANDIDATES.glob("*.cu")):
        if path.stem == "walk_cluster":
            sources["b"] = path.read_text()
        elif path.stem in ("wgmma",):
            designs["a_" + path.stem] = path.read_text()
        else:
            sources["a_" + path.stem] = path.read_text()
    # the designs and their variants through the probe, which runs their
    # launches one by one; a variant's anchors may lie in common.cuh
    common = (_build.CSRC / "common.cuh").read_text()
    for d, text in designs.items():
        for v, subs in {"": [], **VARIANTS.get(d, {})}.items():
            name = f"{d}_{v}" if v else d
            src, com = substitute_with_common(text, common, subs)
            sources[name] = write_candidate(out_dir, name, src, com, PROBE,
                                            "ssd_scan_wide.cu")
    procs = {}
    for name, text in sources.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, out_dir / f"ptxas_{name}.log", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(_build.CSRC), "-shared", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, log, p) in procs.items():
        text, _ = p.communicate()
        log.write_text(text)
        if p.returncode != 0:              # the others are still timed
            print(json.dumps({"candidate": name, "build_failed":
                              text[-2000:]}), flush=True)
            continue
        so = ctypes.CDLL(str(lib))
        if name.startswith("first"):
            so.repro_ssd_scan_wide.argtypes = _ARGS + [ctypes.c_void_p] * 4
        else:
            so.repro_ssd_scan_wide.argtypes = _ARGS + [
                ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 3
            so.repro_ssd_scan_wide_scratch.argtypes = [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            so.repro_ssd_scan_wide_scratch.restype = ctypes.c_int
        so.repro_ssd_scan_wide.restype = ctypes.c_int
        if "probe_upto" in sources[name]:
            so.probe_upto.argtypes = [ctypes.c_int] + list(
                so.repro_ssd_scan_wide.argtypes)
            so.probe_upto.restype = ctypes.c_int
            so.probe_occupancy.argtypes = [ctypes.c_int, ctypes.c_void_p]
            so.probe_occupancy.restype = ctypes.c_int
        libs[name] = (so, log)
    return libs


def inputs(gen, bf16_values: bool, B=4, S=1024, H=4, dk=1024, dv=1025):
    """mLSTM's operands (per-head q, k ~ N(0, 1/dk), v with a ones column,
    a = log sigmoid(3 + N(0, 1)), i = exp(clip(4 N(0, 1), -10, 10))), with
    q, k, v rounded to bf16 values where bf16_values, as at the serve."""
    dev = torch.device("cuda")
    q = torch.randn((B, S, H, dk), generator=gen, device=dev) * dk ** -0.5
    k = torch.randn((B, S, H, dk), generator=gen, device=dev) * dk ** -0.5
    v = torch.randn((B, S, H, dv), generator=gen, device=dev)
    v[..., -1] = 1.0
    if bf16_values:
        q, k, v = (x.bfloat16().float() for x in (q, k, v))
    a = F.logsigmoid(3.0 + torch.randn((B, S, H), generator=gen, device=dev))
    i = torch.exp(torch.clamp(4.0 * torch.randn((B, S, H), generator=gen,
                                                device=dev), -10.0, 10.0))
    return q, k, v, a, i


def call(so, name, ops, chunk=256, upto=3):
    """One call of candidate ``name`` → (y, final state)."""
    q, k, v, a, i = ops
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    y = torch.empty((B, S, H, dv), device=q.device)
    h = torch.empty((B, H, dk, dv), device=q.device)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), a.data_ptr(),
            i.data_ptr(), None, B, S, H, dk, dv, chunk, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3]]
    stream = torch.cuda.current_stream().cuda_stream
    if name.startswith("first"):
        scores = torch.empty((B, H, S // chunk, chunk, chunk),
                             device=q.device)
        err = so.repro_ssd_scan_wide(*args, scores.data_ptr(), y.data_ptr(),
                                     h.data_ptr(), stream)
    else:
        size = ctypes.c_longlong()
        so.repro_ssd_scan_wide_scratch(B, S, H, dk, dv, chunk,
                                       ctypes.addressof(size))
        nbytes = size.value
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
        tail = [scratch.data_ptr(), nbytes, y.data_ptr(), h.data_ptr(),
                stream]
        # a probed design is called through its probe, whose arguments are
        # its C entry's without the states
        err = (so.probe_upto(upto, *args, *tail) if hasattr(so, "probe_upto")
               else so.repro_ssd_scan_wide(*args, *tail))
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")
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


def ptxas_lines(name: str, log: Path) -> list:
    """ptxas's registers, spills and shared memory of each wide kernel."""
    out, fn = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            continue
        if fn and "ssd_wide" in fn and ("spill" in line or "Used" in line):
            short = re.search(r"ssd_wide_\w+?(?=E|$)", fn)
            out.append(f"{name} {short.group(0) if short else fn}: "
                       f"{line.strip()}")
    return out


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="the first wide design's ssd_scan_wide.cu")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="build/k4_wide_probe")
    args = ap.parse_args(argv)
    libs = build(Path(args.out), Path(args.baseline))
    gen = torch.Generator(device="cuda").manual_seed(0)
    ops = {"f32": inputs(gen, False), "bf16_values": inputs(gen, True)}
    chunk = SERVE["chunk"]
    want = {kind: ssd_scan.ssd_scan_ref(*o, chunk=chunk)
            for kind, o in ops.items()}
    sh = SERVE
    bound = ssd_scan.bound(sh["B"], sh["S"], sh["H"], sh["dk"], sh["dv"],
                           chunk, 4, 3.35e12, 989e12, 67e12,
                           qk_per_head=True)
    fl = ssd_scan.flops(sh["B"], sh["S"], sh["H"], sh["dk"], sh["dv"], chunk)
    rows = []
    for name, (so, _) in libs.items():
        rows.append({"candidate": name, "so": so, "upto": 3})
        if hasattr(so, "probe_upto"):
            rows += [{"candidate": f"{name}_upto1", "so": so, "upto": 1},
                     {"candidate": f"{name}_upto2", "so": so, "upto": 2}]
    for r in rows:
        name = r["candidate"]
        if name in TIMED_ONLY or r["upto"] < 3:
            continue              # no whole result to check
        so = r["so"]
        for kind, o in ops.items():
            got = call(so, name, o)
            again = call(so, name, o)
            torch.cuda.synchronize()
            r[f"excess_y_{kind}"] = ssd_scan.excess(got[0], want[kind][0])
            r[f"excess_state_{kind}"] = ssd_scan.excess(got[1], want[kind][1])
            r[f"bitwise_equal_rerun_{kind}"] = bool(
                torch.equal(got[0], again[0]) and torch.equal(got[1],
                                                              again[1]))
            del got, again
    o = ops["bf16_values"]
    for r in rows:
        r["ms"] = []
    for _ in range(2):                   # in turns: a, b, ..., a, b, ...
        for r in rows:
            r["ms"].append(time_ms(
                lambda: call(r["so"], r["candidate"].split("_upto")[0]
                             if r["upto"] < 3 else r["candidate"], o,
                             upto=r["upto"]), args.reps))
    plain = [time_ms(lambda: ssd_scan.ssd_scan_ref(*o, chunk=chunk), 5)
             for _ in range(2)]
    for r in rows:
        del r["so"]
        ms = statistics.mean(r["ms"])
        r.update({"bound_ms": bound["bound_ms"],
                  "f32_core_bound_ms": bound["f32_core_bound_ms"],
                  "share_of_bound": bound["bound_ms"] / ms,
                  "achieved_tflop_s": fl / ms / 1e9, "plain_ms": plain})
        print(json.dumps(r), flush=True)
    so = libs["a"][0]
    for n, kern in enumerate(("split", "chunks", "y")):
        out = (ctypes.c_int * 3)()
        err = so.probe_occupancy(n, out)
        print(json.dumps({"kernel": f"a ssd_wide_{kern}", "error": err,
                          "registers": out[0], "smem_bytes": out[1],
                          "blocks_per_sm": out[2]}), flush=True)
    for name, (_, log) in libs.items():
        for line in ptxas_lines(name, log):
            print(line, flush=True)
    print(_smi(), flush=True)


if __name__ == "__main__":
    main()
