"""Time K4's wide backward designs side by side on one card.

    python -m repro_torch.tools.k4_wide_bwd_designs --baseline FILE
                                                    [--reps 20] [--out DIR]

(from the checkout root with ``PYTHONPATH=src``). FILE is the first wide
backward, ``csrc/ssd_scan_wide_bwd.cu`` as it was at ``ed094c6`` (``git
show ed094c6:src/repro_torch/csrc/ssd_scan_wide_bwd.cu`` saved under
``build/``): f32 FMAs in 128 x 128 tiles, three launches, every product
computed. Each candidate is built by ``nvcc`` into a library of its own
(all at once) and called through its C entry:

- ``first``: FILE as it is;
- ``first_upto1``, ``first_upto2``: FILE's first one or two launches
  alone (timed only): the launches' shares by difference;
- ``first_skips``: FILE with only the current design's skips of states
  known to be zero: no state term of dk and dv at the last chunk without
  dh_final, and, where dh0 is not asked for (a null dh0: FILE's C entry
  has no flag for the initial state, so this copy reads a null dh0 as "no
  initial state", as autograd calls it), no H_0 dy_t, no <H_0, G_0> and no
  update at chunk 0. It separates what the skips give from what the
  tensor cores give;
- ``new``: the current ``csrc/ssd_scan_wide_bwd.cu``, through a probe that
  also runs its first one to four launches alone (``new_upto1`` ..
  ``new_upto4``), with copies that leave the products or the copies out
  (``VARIANTS``: wrong results, timed only) and copies with other rings
  (``RINGS``: whole results);
- every ``tools/k4_wide_bwd/*.cu``: a whole candidate with the current C
  entry: ``walk_together.cu``, the score and walk blocks in one launch at
  one block an SM (four launches, the first tensor-core build).

At xlstm-1.3b's training shape (B 4, S 512, H 4, dk 1024, dv 1025, chunk
256) with mLSTM's gates, no initial state and no dh_final, dh0 not asked
for (as ``_SSDScan`` calls it), f32 dy, and q, k, v bf16-valued (training's)
or full f32, every candidate that computes the function is held to
``ssd_scan.bwd_margins`` <= 1 around the plain backward's f32 result on the
states the port's wide forward writes, and must give the same bits twice;
then every candidate is timed in turns, twice, on both inputs (CUDA events,
median of ``--reps`` calls queued behind a sleep kernel). Prints one JSON
line per candidate (with the bound, counted as the timed call needs it),
ptxas's registers and spills for each kernel, and the card's ``nvidia-smi``
name and power limit. A candidate that fails to build prints its error and
is left out. Not run by ``chip_smoke.py``.
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

from repro_torch.kernels import _build, ssd_scan
from repro_torch.tools.k4_wide_designs import (_smi, inputs, substitute,
                                               substitute_with_common,
                                               time_ms, write_candidate)

TRAIN = dict(B=4, S=512, H=4, dk=1024, dv=1025, chunk=256)
CANDIDATES = Path(__file__).resolve().parent / "k4_wide_bwd"

PROBE = r"""
#include "ssd_scan_wide_bwd.cu"
// the first `launches` launches of a call (1 to 5)
extern "C" int probe_upto(
    int launches, const float* q, const float* k, const float* v,
    const float* a, const float* i, const float* states, const float* dy,
    const float* dh_final, int B, int S, int H, int dk, int dv, int chunk,
    int has_h0, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, void* scratch, long long scratch_bytes, float* dq,
    float* dk_out, float* dv_out, float* da, float* di, float* dh0,
    void* stream) {
  return launch_wide_bwd(q, k, v, a, i, states, dy, dh_final, B, S, H, dk,
                         dv, chunk, has_h0, qsb, qss, qsh, ksb, kss, ksh,
                         vsb, vss, vsh, scratch, scratch_bytes, dq, dk_out,
                         dv_out, da, di, dh0,
                         static_cast<cudaStream_t>(stream), launches);
}
"""

# FILE's launches 2 and 3 left out (timed only)
_RETURN = "  return cudaGetLastError();\n"
_ROWS = "  ssd_wide_bwd_rows<<<(unsigned)g2, kThreads, 0, st>>>(c, (int)nq);\n"
_GATES = "  ssd_wide_bwd_gates<<<(unsigned)bhn, kThreads, 0, st>>>(c);\n"
FIRST = {
    "upto1": [(_ROWS, _RETURN + _ROWS)],
    "upto2": [(_GATES, _RETURN + _GATES)],
    # the skips of states known to be zero, a null dh0 read as no initial
    # state (see above)
    "skips": [
        ("    float hg = 0.f;\n",
         "    float hg = 0.f;\n"
         "    const bool zero_hg = (n == 0 && !c.dh0) ||\n"
         "                         (n == nc - 1 && !c.dh_final);\n"),
        ("          hg = fmaf(Hn[(int64_t)d * dv + e], acc[i][j], hg);\n",
         "          if (!zero_hg)\n"
         "            hg = fmaf(Hn[(int64_t)d * dv + e], acc[i][j], hg);\n"),
        ("    const float etot = expf(sm.cum[Q - 1]);\n",
         "    if (n == 0 && !c.dh0) break;\n"
         "    const float etot = expf(sm.cum[Q - 1]);\n"),
        ("      if (d < dk && e < dv) c.dh0[(bh * dk + d) * dv + e] = "
         "acc[i][j];\n",
         "      if (c.dh0 && d < dk && e < dv)\n"
         "        c.dh0[(bh * dk + d) * dv + e] = acc[i][j];\n"),
        ("  if (kind == 0)        // H_n dy_t over dv\n",
         "  if (kind == 0 ? n == 0 && !c.dh0 : n == nc - 1 && !c.dh_final) {\n"
         "  } else if (kind == 0)        // H_n dy_t over dv\n"),
    ],
}
# copies of the current source that leave one part of the work out (wrong
# results, timed only): the products, the copies, the walk blocks, the
# score blocks
VARIANTS = {
    "no_walk": [("  walk_block<kWalkStages>(c, blockIdx.x, smem, red);\n",
                 "  return;\n")],
    "no_scores": [("  score_block(c, blockIdx.x, smem, red);\n",
                   "  return;\n")],
    "no_products": [("  const int l7 = lane & 7,",
                     "  if (na > 0) return;\n  const int l7 = lane & 7,")],
    "no_copies": [("    if (g < G) stage(g, g);\n",
                   "    if (g < 0) stage(g, g);\n"),
                  ("    if (next < G) stage(next, next % NS);\n",
                   "    if (next < 0) stage(next, next % NS);\n")],
}
TIMED_ONLY = ("first_upto1", "first_upto2",
              *(f"new_{v}" for v in VARIANTS))
# copies with other rings of slabs (whole results); rows_1sm: launch 3 at
# one block an SM with a ring of four stages (the first tensor-core build)
RINGS = {
    "rows_1sm": [("constexpr int kRowsStages = 2,",
                  "constexpr int kRowsStages = 4,"),
                 ("__global__ void __launch_bounds__(kThreads, 2)\n"
                  "    ssd_wide_bwd_rows(",
                  "__global__ void __launch_bounds__(kThreads, 1)\n"
                  "    ssd_wide_bwd_rows(")],
    "walk3_1sm": [("constexpr int kWalkStages = 2,",
                   "constexpr int kWalkStages = 3,"),
                  ("__global__ void __launch_bounds__(kThreads, 2)\n"
                   "    ssd_wide_bwd_walk(",
                   "__global__ void __launch_bounds__(kThreads, 1)\n"
                   "    ssd_wide_bwd_walk(")],
    "score2": [("constexpr int kScoreStages = 3,",
                "constexpr int kScoreStages = 2,")],
}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_FIRST_ARGS = [_P] * 8 + [_I] * 6 + [_L] * 9 + [_P, _L] + [_P] * 7
_NEW_ARGS = [_P] * 8 + [_I] * 7 + [_L] * 9 + [_P, _L] + [_P] * 7


def build(out_dir: Path, baseline: Path) -> dict:
    """Every candidate's source into out_dir, built in parallel; returns
    name -> (library, ptxas log path)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    base = Path(baseline).read_text()
    sources = {"first": base}
    for v, subs in FIRST.items():
        sources[f"first_{v}"] = substitute(base, subs)
    common = (_build.CSRC / "common.cuh").read_text()
    new = (_build.CSRC / "ssd_scan_wide_bwd.cu").read_text()
    for v, subs in {"": [], **VARIANTS, **RINGS}.items():
        name = f"new_{v}" if v else "new"
        src, com = substitute_with_common(new, common, subs)
        sources[name] = write_candidate(out_dir, name, src, com, PROBE,
                                        "ssd_scan_wide_bwd.cu")
    for path in sorted(CANDIDATES.glob("*.cu")):
        sources[path.stem] = path.read_text()
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
                              text[-3000:]}), flush=True)
            continue
        so = ctypes.CDLL(str(lib))
        first = name.startswith("first")
        so.repro_ssd_scan_wide_bwd.argtypes = _FIRST_ARGS if first else \
            _NEW_ARGS
        so.repro_ssd_scan_wide_bwd.restype = ctypes.c_int
        so.repro_ssd_scan_wide_bwd_scratch.argtypes = \
            [_I] * (6 if first else 8) + [_P]
        so.repro_ssd_scan_wide_bwd_scratch.restype = ctypes.c_int
        if hasattr(so, "probe_upto"):
            so.probe_upto.argtypes = [_I] + _NEW_ARGS
            so.probe_upto.restype = ctypes.c_int
        libs[name] = (so, log)
    return libs


class Call:
    """A candidate's call on fixed operands and outputs: the scratch and
    the outputs are allocated once, outside the timed calls."""

    def __init__(self, so, name, ops, dy, states, chunk, upto=5):
        q, k, v, a, i = ops
        B, S, H, dk = q.shape
        dv = v.shape[-1]
        dev = q.device
        first = name.startswith("first")
        size = ctypes.c_longlong()
        flags = [] if first else [0, 0]          # no h0, no dh_final
        err = so.repro_ssd_scan_wide_bwd_scratch(B, S, H, dk, dv, chunk,
                                                 *flags,
                                                 ctypes.addressof(size))
        if err:
            raise RuntimeError(f"{name}: scratch query failed ({err})")
        self.scratch = torch.empty(size.value, dtype=torch.uint8, device=dev)
        self.outs = [torch.empty(x, device=dev) for x in (
            (B, S, H, dk), (B, S, H, dk), (B, S, H, dv), (B, S, H),
            (B, S, H))]
        # FILE computes dh0 whatever the caller wants; the skips copy and
        # the new design are called as autograd calls them, without
        self.dh0 = torch.empty((B, H, dk, dv), device=dev) \
            if name == "first" or name.startswith("first_upto") else None
        head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), a.data_ptr(),
                i.data_ptr(), states.data_ptr(), dy.data_ptr(), None,
                B, S, H, dk, dv, chunk]
        strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]]
        tail = [self.scratch.data_ptr(), size.value,
                *(x.data_ptr() for x in self.outs),
                None if self.dh0 is None else self.dh0.data_ptr()]
        self.args = head + ([] if first else [0]) + strides + tail
        self.fn = (lambda *a: so.probe_upto(upto, *a)) \
            if hasattr(so, "probe_upto") else so.repro_ssd_scan_wide_bwd
        self.name = name

    def launch(self):
        err = self.fn(*self.args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.name}: CUDA error {err}")

    def __call__(self):
        self.launch()
        return [x.clone() for x in self.outs]


def ptxas_lines(name: str, log: Path) -> list:
    """ptxas's registers, spills and shared memory of each wide backward
    kernel."""
    out, fn = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            continue
        if fn and "ssd_wide_bwd" in fn and ("spill" in line or "Used" in line):
            short = re.search(r"ssd_wide_bwd_\w+?(?=E|P|$)", fn)
            out.append(f"{name} {short.group(0) if short else fn}: "
                       f"{line.strip()}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="the first wide backward's ssd_scan_wide_bwd.cu")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="build/k4_wide_bwd_probe")
    args = ap.parse_args(argv)
    libs = build(Path(args.out), Path(args.baseline))
    sh = TRAIN
    B, S, H, dk, dv, chunk = (sh[x] for x in ("B", "S", "H", "dk", "dv",
                                              "chunk"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    kinds = {}
    for kind, bf16_values in (("bf16_values", True), ("f32", False)):
        ops = inputs(gen, bf16_values, B, S, H, dk, dv)
        dy = torch.randn((B, S, H, dv), generator=gen, device="cuda")
        _, _, states = ssd_scan._launch_fwd(*ops, None, chunk, True)
        want = ssd_scan.ssd_scan_bwd_ref(*ops, dy, None, chunk=chunk,
                                         states=states)
        kinds[kind] = (ops, dy, states, want)
    rows = []
    for name, (so, _) in libs.items():
        rows.append({"candidate": name, "so": so, "upto": 5})
        if hasattr(so, "probe_upto") and name == "new":
            rows += [{"candidate": f"new_upto{u}", "so": so, "upto": u}
                     for u in (1, 2, 3, 4)]
    for r in rows:
        r["calls"] = {kind: Call(r["so"], r["candidate"].split("_upto")[0]
                                 if r["candidate"].startswith("new_upto")
                                 else r["candidate"], ops, dy, states, chunk,
                                 r["upto"])
                      for kind, (ops, dy, states, _) in kinds.items()}
        name = r["candidate"]
        if name in TIMED_ONLY or r["upto"] < 5:
            continue              # no whole result to check
        for kind, (_, _, _, want) in kinds.items():
            call = r["calls"][kind]
            got, again = call(), call()
            torch.cuda.synchronize()
            m = ssd_scan.bwd_margins(got, want[:5])
            r[f"margins_{kind}"] = m
            r[f"max_margin_{kind}"] = max(m.values())
            r[f"bitwise_equal_rerun_{kind}"] = all(
                torch.equal(x, y) for x, y in zip(got, again))
            del got, again
    for r in rows:
        r["ms"] = {kind: [] for kind in kinds}
    for _ in range(2):                   # in turns: a, b, ..., a, b, ...
        for kind in kinds:
            for r in rows:
                r["ms"][kind].append(time_ms(r["calls"][kind].launch,
                                             args.reps))
    ops, dy, states, _ = kinds["bf16_values"]
    plain = [time_ms(lambda: ssd_scan.ssd_scan_bwd_ref(
        *ops, dy, None, chunk=chunk, states=states), 5) for _ in range(2)]
    bound = ssd_scan.bwd_bound(B, S, H, dk, dv, chunk, 4, 3.35e12, 989e12,
                               67e12, qk_per_head=True, dh_final=False,
                               initial_state=False, dh0=False)
    for r in rows:
        for x in ("so", "calls"):
            del r[x]
        ms = statistics.mean(r["ms"]["bf16_values"])
        r.update({"mean_ms": {k: statistics.mean(v)
                              for k, v in r["ms"].items()},
                  "bound_ms": bound["bound_ms"],
                  "bound_by": bound["bound_by"],
                  "f32_core_bound_ms": bound["f32_core_bound_ms"],
                  "share_of_bound": bound["bound_ms"] / ms,
                  "plain_ms": plain})
        print(json.dumps(r), flush=True)
    for name, (_, log) in libs.items():
        for line in ptxas_lines(name, log):
            print(line, flush=True)
    print(_smi(), flush=True)


if __name__ == "__main__":
    main()
