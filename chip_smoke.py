#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SDFL-B (``src/repro_torch``) once on one
NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases, each printing one JSON line ``{"phase": ..., ...}``:

  device          the card (``nvidia-smi`` name and power limit), torch and
                  CUDA versions; fails unless the compute capability is 9.0
  build           builds the CUDA kernels from ``src/repro_torch/csrc`` with
                  nvcc into ``build/repro_torch_kernels/``
  kernels         K1 trust_score, K2 trust_agg, K3 fused_async_agg against
                  their plain PyTorch versions on the card at D = 21840 (the
                  paper CNN) and W in {16, 4096, 10240} f32, plus bf16 at
                  W = 4096: error, CUDA-event times, byte bound; one K2 call
                  must launch exactly one kernel (``one_kernel``)
  parity          one round of ``make_fl_round`` on the card against the same
                  round on the CPU (sync and async, fused path, no dropout)
  protocol_sync   the main path: ``SDFLBProtocol.run_round`` x3 on the paper
                  CNN, W = 16 (4 x 4), per-worker batch 64, chain on, then
                  ``finalize()`` and ``verify_chain(deep=True)``; K1 and K2
                  must each launch once per round
  protocol_async  the same in async mode with random participation masks;
                  K1 and K3 must each launch once per round
  cohort          W = 4096 (64 x 64), per-worker batch 32: one sync and one
                  async round with the chain; round times and peak memory
  profile         a warm sync round at W = 16 and at W = 4096 under
                  torch.profiler: device time by kernel, device busy share
  determinism     ``protocol_sync`` again with the same seed: the block
                  hashes must be identical
  swa_kernel      K5 swa_decode against its plain version on the card at
                  danube's decode shape (B 4, H 32, KV 8, hd 80, window
                  4096, S 5184 = no multiple of the kernel's tile), f32 and
                  bf16, cur below, at and past the window, plus two small
                  ragged cases (G 1 and G 5 over KV 1); times at the serve
                  shape with the caches cold in L2, the byte bound, and one
                  ``scaled_dot_product_attention`` call on pre-sliced
                  windows as the library yardstick; the tolerance must
                  reject K5 run with the window one slot off or its oldest
                  256 slots dropped; one K5 call must launch exactly one
                  kernel (``one_kernel``), and two launches give equal bits
  serve_parity    ``launch.serve.serve`` on the card against the same on the
                  CPU: h2o-danube-1.8b at full width, cut to 2 layers and a
                  256-slot window, batch 2, a 320-token prompt and 4 greedy
                  tokens, in f32 and bf16: prefill logits, decode logits and
                  tokens
  serve           the second main path: h2o-danube-1.8b at full size (24
                  layers, seeded random weights) serving batch 4, a
                  5120-token prompt and 64 tokens, so decode runs past the
                  4096-slot window; K5 must launch 24 x 63 times; a second
                  same-seed run must emit the same tokens; then four decode
                  steps under torch.profiler
  ssd_kernel      K4 ssd_scan against its plain version on the card, f32
                  and bf16: zamba2-7b's prefill shape (B 4, S 4096, H 112,
                  dk = dv = 64, chunk 128, q and k head-stride-0 views) with
                  the model's gates and with gentle ones (a in [-0.02, 0]),
                  the smoke shape, one chunk, an initial state; y and the
                  final state held to ``ssd_scan.excess``, which must reject
                  the five planted faults of ``ssd_scan.FAULTS`` at the
                  gentle gates; two launches bitwise equal and one kernel
                  launch a call (``one_kernel``); times at the serve shape
                  beside the bound (bytes, or flops on the bf16 tensor
                  cores) and the bound on the ordinary f32 cores
  zamba_parity    ``launch.serve.serve`` on the card against the same on the
                  CPU: zamba2-7b at full width cut to 3 layers (one
                  super-layer of 2 Mamba2 layers and the shared block, one
                  tail layer), batch 2, a 256-token prompt, 4 greedy tokens,
                  f32 and bf16; K4 must launch 3 times, no other kernel
  zamba_serve     the third main path: zamba2-7b at full size (81 layers,
                  seeded random weights, bf16) serving batch 4, a 4096-token
                  prompt and 32 tokens; K4 must launch 81 times and no other
                  kernel; a second same-seed run must emit the same tokens;
                  then one prefill and four decode steps under
                  torch.profiler

Then it prints the card's ``nvidia-smi`` line, one ``{"kernels": [...]}``
line (each kernel's launches on its main path, its error against the plain
version, its time, the plain version's time, its bound and the time of a
library call where one computes the same function: ``torch.mv`` for K2,
``scaled_dot_product_attention`` for K5; none for K1, K3 and K4), and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without the last line; so does a machine without CUDA.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

D_PAPER = 21840                  # the paper CNN's parameter count
SWEEP = [(16, "float32"), (4096, "float32"), (4096, "bfloat16"),
         (10240, "float32")]
MAIN_SHAPE = (16, "float32")     # what the main path hands the kernels
REPS = 30                        # timed launches per measurement (median)
# kernel vs plain version: max|kernel - plain| <= RTOL * max(1, max|plain|)
# per output; both read the same inputs and sum in f32 in different orders
RTOL = 1e-4

# published peaks (NVIDIA data sheets): HBM bytes/s, non-tensor f32 FLOP/s,
# dense bf16 tensor-core FLOP/s
PEAKS = [("H200", 4.8e12, 67e12, 989e12), ("H100 NVL", 3.9e12, 60e12, 835e12),
         ("H100 PCIe", 2.0e12, 51e12, 756e12),
         ("H100", 3.35e12, 67e12, 989e12)]

ARCH = "h2o-danube-1.8b"
SERVE = dict(batch=4, prompt_len=5120, gen=64)   # prompt: 5 x kv_chunk 1024
SWA_WINDOW = 4096                # danube's window; its decode shape below
SWA_SHAPE = dict(B=4, H=32, KV=8, hd=80)
SWA_S = SERVE["prompt_len"] + SERVE["gen"]       # the serve's cache length
SWA_MAIN_CUR = SWA_S - 2         # the serve's last decode step
SWA_ROT = 4                      # layers of cache the timing rotates over
# K5 vs its plain version, both f32 inside, held elementwise to the plain
# version's f32 result before any rounding to q's dtype:
# |kernel - plain_f32| <= SWA_ATOL + SWA_RTOL[dtype] * |plain_f32|. In f32
# they differ in summation order only (measured <= 8e-7); in bf16 the kernel
# also rounds its result once, by at most half a bf16 step (2^-8 of the
# value). A window one slot off or without its oldest 256 slots fails it
# (planted_faults).
SWA_ATOL = 1e-5
SWA_RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -8}
# serve on the card vs on the CPU, absolute on logits (|logit| up to ~5):
# f32 sums of 2560-14336 terms in other orders; bf16 rounds activations at
# other places (cuBLAS and the CPU's kernels) through the two (danube) or
# three (zamba2) layers of the parity runs
PARITY_TOL = {"float32": 1e-3, "bfloat16": 0.125}

ZAMBA = "zamba2-7b"
ZSERVE = dict(batch=4, prompt_len=4096, gen=32)  # prompt: 32 SSD chunks
# one super-layer of 2 Mamba2 layers + the shared block, and 1 tail layer
ZPARITY_CUTS = {"num_layers": 3, "shared_attn_every": 2}
# K4 at zamba2-7b's prefill shape; the smoke config's SSD shape (d 256:
# 8 heads, dk 16, chunk 64); one chunk; a run from an initial state; and
# one with q and k of their own for every head (head stride dk)
SSD_SERVE = dict(B=4, S=4096, H=112, dk=64, dv=64, chunk=128)
SSD_CASES = [(SSD_SERVE, "model", False), (SSD_SERVE, "gentle", False),
             (dict(B=4, S=256, H=8, dk=16, dv=64, chunk=64), "gentle", False),
             (dict(SSD_SERVE, S=128), "gentle", False),
             (dict(SSD_SERVE, S=512), "gentle", True),
             (dict(SSD_SERVE, S=512, per_head_qk=True), "gentle", True)]


def check(ok, what="check failed"):
    """Raise unless ``ok`` (an ``assert`` would vanish under ``-O``)."""
    if not ok:
        raise AssertionError(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def peaks(name):
    """(HBM bytes/s, f32 FLOP/s outside the tensor cores) of the card."""
    return _peak_row(name)[1:3]


def tensor_peak(name):
    """Dense bf16 tensor-core FLOP/s of the card."""
    return _peak_row(name)[3]


def _peak_row(name):
    for row in PEAKS:
        if row[0] in name:
            return row
    raise RuntimeError(f"no published peaks for {name!r}")


def time_ms(fn):
    """Median device time of one call of ``fn`` over REPS calls, from CUDA
    events around each call. A sleep kernel in front lets the host queue
    every call before the device starts, so host overhead stays out."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
    torch.cuda._sleep(50_000_000)
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def one_kernel(fn, name, calls=4):
    """Check that ``calls`` calls of ``fn`` ran one device kernel each:
    the profiler recorded ``calls`` runtime calls that put work on the
    card, each a kernel launch (no copy or memset), and every device
    activity it recorded is the kernel whose name holds ``name``. The
    device records alone cannot be counted: the profiler loses some of
    them (``_build.launch_records``)."""
    from repro_torch.kernels import _build
    enqueued, device = _build.launch_records(fn, calls)
    check(len(enqueued) == calls and all("Launch" in n for n in enqueued)
          and all(name in n for n in device),
          f"{name}: {calls} calls enqueued {enqueued} and ran {device}, "
          f"expected one kernel each")
    return {"calls": calls, "launch_calls": len(enqueued),
            "device_records": len(device),
            "name": device[0] if device else None}


# -- phases -----------------------------------------------------------------


def phase_device():
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi_line = smi("name,power.limit")
    emit({"phase": "device", "nvidia_smi": smi_line, "kind": name,
          "count": torch.cuda.device_count(), "capability": list(cap),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "clocks_power_temp": smi(
              "clocks.sm,clocks.max.sm,power.draw,temperature.gpu")})
    if cap != (9, 0):
        raise RuntimeError(f"compute capability {cap}: the kernels are "
                           f"built for sm_90a")
    return name, smi_line


def phase_build():
    from repro_torch.kernels import _build
    lib = _build.build()
    _build.load()
    spills = [ln.strip() for ln in _build.build_log.splitlines()
              if "spill" in ln and not ln.strip().startswith(
                  "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill")]
    (lib.parent / "build.log").write_text(_build.build_log)
    emit({"phase": "build", "seconds": _build.build_seconds,
          "library": os.path.relpath(lib, ROOT),
          "ptxas_log": os.path.relpath(lib.parent / "build.log", ROOT),
          "nonzero_spill_lines": spills})


def kernel_table():
    from repro_torch.kernels import fused_round, trust_agg, trust_score
    # flops per element of the (W, D) matrix, and per column
    return [
        dict(name="trust_score", wrapper=trust_score.trust_score_stats,
             plain=trust_score.trust_score_ref, bytes=trust_score.hbm_bytes,
             flops=lambda W, D: 5 * W * D + 2 * D, nargs=1, library=None,
             source="src/repro_torch/csrc/trust_score.cu",
             replaces="src/repro/kernels/trust_score.py:25"),
        dict(name="trust_agg", wrapper=trust_agg.trust_agg,
             plain=trust_agg.trust_agg_ref, bytes=trust_agg.hbm_bytes,
             flops=lambda W, D: 2 * W * D, nargs=2,
             library=lambda u, w: torch.mv(u.t(), w),
             source="src/repro_torch/csrc/trust_agg.cu",
             replaces="src/repro/kernels/trust_agg.py:21"),
        dict(name="fused_async_agg", wrapper=fused_round.fused_async_agg,
             plain=fused_round.fused_async_agg_ref,
             bytes=fused_round.hbm_bytes,
             flops=lambda W, D: 4 * W * D, nargs=4, library=None,
             source="src/repro_torch/csrc/fused_async_agg.cu",
             replaces="src/repro/kernels/fused_round.py:105"),
    ]


def kernel_case(k, W, dtype, bw, f32_peak, gen):
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    u = torch.randn((W, D_PAPER), generator=gen, device=dev).to(dt)
    pending = torch.randn((W, D_PAPER), generator=gen, device=dev)
    weights = torch.rand((W,), generator=gen, device=dev)
    keep = (torch.rand((W,), generator=gen, device=dev) > 0.5).float()
    args = (u, pending, weights, keep) if k["nargs"] == 4 else \
        (u, weights)[:k["nargs"]]
    got = k["wrapper"](*args)
    torch.cuda.synchronize()
    want = k["plain"](*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err, ok = 0.0, True
    for g, e in zip(got, want):
        check(g.shape == e.shape and g.dtype == torch.float32,
              f"{k['name']}: output {g.shape} {g.dtype}, plain {e.shape}")
        check(torch.isfinite(g).all())
        d = float((g - e).abs().max())
        err = max(err, d)
        ok &= d <= RTOL * max(1.0, float(e.abs().max()))
    if not ok:
        raise AssertionError(f"{k['name']} W={W} {dtype}: max|kernel - "
                             f"plain| = {err} beyond rtol {RTOL}")
    hbm = k["bytes"](W, D_PAPER, u.element_size())
    nbytes = hbm["minimum"]
    flops = k["flops"](W, D_PAPER)
    t_bytes, t_ops = nbytes / bw * 1e3, flops / f32_peak * 1e3
    lib = k["library"]
    row = {"W": W, "D": D_PAPER, "dtype": dtype, "max_abs_err": err,
           "ms": time_ms(lambda: k["wrapper"](*args)),
           "plain_ms": time_ms(lambda: k["plain"](*args)),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "min_bytes": nbytes,
           "streamed_bytes": hbm["total"],
           "library_ms": (time_ms(lambda: lib(*args))
                          if lib is not None and dtype == "float32" else None)}
    if k["name"] == "trust_agg":
        from repro_torch.kernels import trust_agg as K2
        again = k["wrapper"](*args)
        row["bitwise_equal_rerun"] = bool(torch.equal(again, got[0]))
        check(row["bitwise_equal_rerun"], f"two K2 launches differ, W={W}")
        row["device_kernel"] = one_kernel(lambda: k["wrapper"](*args),
                                          "trust_agg")
        row["plan"] = K2.plan(W, D_PAPER, u.element_size())._asdict()
        del again
    del u, pending, args, got, want
    return row


def phase_kernels(name):
    bw, f32_peak = peaks(name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = kernel_table()
    for k in table:
        k["sweep"] = [kernel_case(k, W, dt, bw, f32_peak, gen)
                      for W, dt in SWEEP]
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "rtol": RTOL, "hbm_bytes_per_s": bw,
          "f32_flops_per_s": f32_peak,
          "kernels": [{"name": k["name"], "sweep": k["sweep"]}
                      for k in table]})
    return table


def _configs(clusters=4, per_cluster=4, async_mode=False):
    from repro_torch.configs.base import FederationConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    fed = FederationConfig(num_clusters=clusters,
                           workers_per_cluster=per_cluster,
                           async_mode=async_mode)
    return get_config("paper-net"), fed, TrainConfig()


def phase_parity():
    """make_fl_round on the card against the CPU on the same inputs: the
    tolerances of tests/test_torch_round.py (scores and weights 1e-4,
    params 1e-5 absolute) — TF32 is off on the card's path."""
    from repro_torch.core import fl_step
    from repro_torch.data.datasets import make_federated_mnist
    from repro_torch.models import api
    out = {"phase": "parity"}
    for async_mode in (False, True):
        cfg, fed, tc = _configs(async_mode=async_mode)
        W = fl_step.num_workers(fed)
        data = make_federated_mnist(W, samples=1024, seed=5)
        batch = data.round_batches(8)
        part = (np.random.default_rng(5).random(W) > 0.4).astype(np.int32)
        res = {}
        for dev in ("cuda", "cpu"):
            d = torch.device(dev)
            params = api.init(cfg, torch.Generator().manual_seed(5), d)
            opt = fl_step.init_worker_opt(params, fed, tc)
            b = {k: torch.from_numpy(v).to(d)[:, None]
                 for k, v in batch.items()}
            fn = fl_step.make_fl_round(cfg, fed, tc, device=dev)
            if async_mode:
                st = fl_step.init_async_state_for(cfg, fed, params, W)
                p = torch.from_numpy(part).to(d)
                for _ in range(2):            # pending nonzero in round 2
                    o, st = fn(params, opt, b, None, p, st)
                    params, opt = o.global_params, o.opt_state
            else:
                o = fn(params, opt, b)
            res[dev] = o
        g, c = res["cuda"], res["cpu"]
        diffs = {
            "scores": float((g.scores.cpu() - c.scores).abs().max()),
            "weights": float((g.weights.cpu() - c.weights).abs().max()),
            "params": max(float((g.global_params[k].cpu()
                                 - c.global_params[k]).abs().max())
                          for k in c.global_params)}
        check(all(torch.isfinite(v).all() for v in g.global_params.values()))
        check(diffs["scores"] <= 1e-4 and diffs["weights"] <= 1e-4
              and diffs["params"] <= 1e-5, diffs)
        out["async" if async_mode else "sync"] = diffs
    emit(out)


def counters():
    from repro_torch.kernels import ssd_scan, swa_decode
    out = {k["name"]: k["wrapper"] for k in kernel_table()}
    out["swa_decode"] = swa_decode.swa_decode
    out["ssd_scan"] = ssd_scan.ssd_scan
    return out


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


TRUST_KERNELS = ("split_colsum", "finish_colsum", "row_stats", "trust_agg")


def device_profile(prof, wall_s, ours=TRUST_KERNELS, label="trust_kernels_s"):
    """Device activity (kernels, copies, sets) from a torch.profiler run
    over ``wall_s`` seconds of host time: the busy time (the union of the
    activities' intervals), its share of the window, the time of the
    kernels whose names contain one of ``ours`` (under ``label``) and the
    ten largest activities by name, each as [name, summed microseconds,
    count]. The sum by name can exceed the busy time where cuDNN spreads
    work over its own streams. CUPTI's own bookkeeping entries are left
    out."""
    from torch.autograd import DeviceType
    acts = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and e.name not in ("Activity Buffer Request", "Buffer Flush")]
    spans = sorted((e.time_range.start, e.time_range.end) for e in acts)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = {}
    for e in acts:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    ours_us = sum(t for k, (t, _) in by_name.items()
                  if any(n in k for n in ours))
    top = sorted(by_name.items(), key=lambda r: -r[1][0])[:10]
    return {"wall_s": wall_s, "device_busy_s": busy_us / 1e6,
            "busy_share": busy_us / 1e6 / wall_s,
            label: ours_us / 1e6, "activities": len(acts),
            "top_device_us": [[k[:90], t, n] for k, (t, n) in top]}


def run_protocol(phase, *, async_mode, clusters=4, per_cluster=4, batch=64,
                 rounds=3, seed=0, profile_round=None):
    """SDFLBProtocol on the card: ``rounds`` rounds with the chain, then
    finalize and a deep chain check. Returns the phase record and the
    ledger's block hashes. Round ``profile_round``, if given, runs under
    torch.profiler and its device breakdown goes into the record."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.protocol import SDFLBProtocol
    from repro_torch.data.datasets import make_federated_mnist
    cfg, fed, tc = _configs(clusters, per_cluster, async_mode)
    W = clusters * per_cluster
    t0 = time.monotonic()
    data = make_federated_mnist(W, samples=W * batch, seed=seed)
    batches = [data.round_batches(batch) for _ in range(rounds)]
    rng = np.random.default_rng(seed + 1)
    parts = []
    for _ in range(rounds):
        p = (rng.random(W) > 0.4).astype(np.int32)
        p[0] = 1
        parts.append(p if async_mode else None)
    setup_s = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    proto = SDFLBProtocol(cfg, fed, tc, seed=seed)
    check(proto.node.device.type == "cuda")
    walls, recs, prof = [], [], None
    for i, (b, p) in enumerate(zip(batches, parts)):
        if i == profile_round:
            proto.flush()
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        t = time.monotonic()
        recs.append(proto.run_round(b, participation=p))
        walls.append(time.monotonic() - t)
        if i == profile_round:
            prof.stop()
    payouts = proto.finalize()
    torch.cuda.synchronize()
    total_s = time.monotonic() - t0
    check(proto.ledger.verify_chain(deep=True))
    check(len(proto.ledger.blocks) == rounds + 2)
    check(all(r.settled and r.scores.shape == (W,)
              and np.isfinite(r.scores).all() for r in recs))
    check(all(r.model_cid and proto.ipfs.has(r.model_cid) for r in recs))
    total = fed.requester_deposit + W * fed.worker_stake
    paid = sum(payouts.values()) + proto.contract.requester_balance
    check(abs(paid - total) < 1e-6 * total, (paid, total))
    check(abs(proto.contract.total_value() - total) < 1e-6 * total)
    for r in recs:
        check(not r.penalties[r.scores >= fed.trust_threshold].any())
        if async_mode:
            check(r.weights[r.participation == 0].sum() == 0)
    params = proto.global_params
    check(all(torch.isfinite(v).all() for v in params.values()))
    rec = {"phase": phase, "W": W, "per_worker_batch": batch,
           "rounds": rounds, "setup_s": setup_s,
           "round_wall_s": walls,
           "round_train_s": [r.wall_time - r.chain_time for r in recs],
           "settle_s": [r.settle_time for r in recs],
           "total_s": total_s,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "mean_loss": [float(r.losses.mean()) for r in recs],
           "bad_workers": [int((r.scores < fed.trust_threshold).sum())
                           for r in recs],
           "blocks": len(proto.ledger.blocks)}
    if prof is not None:
        rec["profile"] = device_profile(prof, walls[profile_round])
    return rec, [blk.hash for blk in proto.ledger.blocks]


def main_path(phase, async_mode):
    reset_counts()
    rec, hashes = run_protocol(phase, async_mode=async_mode)
    counts = read_counts()
    rec["launches"] = counts
    want = {"trust_score": 3, "trust_agg": 0 if async_mode else 3,
            "fused_async_agg": 3 if async_mode else 0, "swa_decode": 0,
            "ssd_scan": 0}
    if counts != want:
        raise AssertionError(f"{phase}: kernel launches {counts}, "
                             f"expected {want}")
    emit(rec)
    return counts, hashes


def phase_cohort():
    out = {"phase": "cohort"}
    for mode, async_mode in (("sync", False), ("async", True)):
        reset_counts()
        rec, _ = run_protocol("cohort", async_mode=async_mode, clusters=64,
                              per_cluster=64, batch=32, rounds=1)
        rec["launches"] = read_counts()
        check(rec["launches"]["trust_score"] == 1)
        check(rec["launches"]["fused_async_agg" if async_mode
                              else "trust_agg"] == 1, rec["launches"])
        out[mode] = rec
        torch.cuda.empty_cache()
    emit(out)


def phase_profile():
    """A warm sync round (the second of two) at W = 16 and at W = 4096
    under torch.profiler: where the device time of a round goes and how
    much of the round the device is busy."""
    out = {"phase": "profile"}
    for clusters, per_cluster, batch in ((4, 4, 64), (64, 64, 32)):
        rec, _ = run_protocol("profile", async_mode=False, clusters=clusters,
                              per_cluster=per_cluster, batch=batch,
                              rounds=2, profile_round=1)
        out[f"W{clusters * per_cluster}"] = rec["profile"]
        torch.cuda.empty_cache()
    emit(out)


def _rotating(fn, n):
    """A call that runs ``fn(0)``, ``fn(1)``, ... ``fn(n - 1)``, ``fn(0)``
    ...: timed through it, each launch reads another layer's cache, so the
    window (42 MB in bf16) is cold in the 50 MB L2, as it is in a decode
    step whose other layers ran in between."""
    state = [0]

    def call():
        fn(state[0] % n)
        state[0] += 1
    return call


def swa_excess(got, want32, dtype):
    """Largest amount by which ``got`` lies outside K5's tolerance around
    the plain f32 result: > 0 fails."""
    tol = SWA_ATOL + SWA_RTOL[dtype] * want32.abs()
    return float(((got.float() - want32).abs() - tol).max())


def swa_case(K5, name, B, H, KV, hd, S, window, cur, dtype, gen, timed):
    """K5 on layer 0 of a stacked (SWA_ROT, B, S, KV, hd) cache against its
    plain version; with ``timed``, also the CUDA-event times of the kernel,
    the plain version and SDPA on pre-sliced windows, the bound, and the
    check run on planted faults: K5 called with the window one slot short,
    one slot long, or without its oldest 256 slots must fail it."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    rot = SWA_ROT if timed else 1
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(dt)
    kc, vc = (torch.randn((rot, B, S, KV, hd), generator=gen,
                          device=dev).to(dt) for _ in range(2))
    got = K5.swa_decode(q, kc[0], vc[0], cur, window)
    torch.cuda.synchronize()
    want = K5.swa_decode_ref(q, kc[0], vc[0], cur, window)
    want32 = K5.swa_decode_ref(q.float(), kc[0].float(), vc[0].float(), cur,
                               window)
    check(got.shape == want.shape and got.dtype == q.dtype)
    check(torch.isfinite(got).all())
    err = float((got.float() - want.float()).abs().max())
    excess = swa_excess(got, want32, dtype)
    if excess > 0:
        raise AssertionError(f"swa_decode B={B} H={H} KV={KV} hd={hd} S={S} "
                             f"cur={cur} {dtype}: max|kernel - plain| = "
                             f"{err}, beyond the tolerance by {excess}")
    row = {"B": B, "H": H, "KV": KV, "hd": hd, "S": S, "window": window,
           "cur": cur, "dtype": dtype, "max_abs_err": err,
           "max_err_vs_plain_f32": float((got.float() - want32).abs().max()),
           "plan": K5.plan(cur, window)._asdict()}
    if not timed:
        return row
    again = K5.swa_decode(q, kc[0], vc[0], cur, window)
    row["bitwise_equal_rerun"] = bool(torch.equal(again, got))
    check(row["bitwise_equal_rerun"], f"two K5 launches differ, {dtype}")
    row["device_kernel"] = one_kernel(
        lambda: K5.swa_decode(q, kc[0], vc[0], cur, window), "swa_decode")
    faults = {}
    for fault, w in (("window_minus_1", window - 1),
                     ("window_plus_1", window + 1),
                     ("oldest_256_slots_dropped", window - 256)):
        bad = K5.swa_decode(q, kc[0], vc[0], cur, w)
        faults[fault] = {"max_abs_err": float(
            (bad.float() - want.float()).abs().max()),
            "excess": swa_excess(bad, want32, dtype)}
        check(faults[fault]["excess"] > 0,
              f"K5's tolerance passes a planted fault: {fault} {dtype}")
    row["planted_faults"] = faults
    del want32, bad
    bw, peak = peaks(name)
    hbm = K5.hbm_bytes(B, H, KV, hd, window, cur, q.element_size())
    t_bytes = hbm["minimum"] / bw * 1e3
    t_ops = K5.flops(B, H, hd, window, cur) / peak * 1e3
    lo = max(cur - window + 1, 0)
    kw, vw = ([c[r][:, lo:cur + 1].transpose(1, 2).contiguous()
               for r in range(rot)] for c in (kc, vc))
    q4 = q[:, :, None, :]
    lib = F.scaled_dot_product_attention(q4, kw[0], vw[0], enable_gqa=True)
    row.update({
        "ms": time_ms(_rotating(
            lambda r: K5.swa_decode(q, kc[r], vc[r], cur, window), rot)),
        "plain_ms": time_ms(_rotating(
            lambda r: K5.swa_decode_ref(q, kc[r], vc[r], cur, window), rot)),
        "library_ms": time_ms(_rotating(
            lambda r: F.scaled_dot_product_attention(q4, kw[r], vw[r],
                                                     enable_gqa=True), rot)),
        "library_max_abs_err": float(
            (lib[:, :, 0].float() - want.float()).abs().max()),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "min_bytes": hbm["minimum"], "streamed_bytes": hbm["total"],
        "window_slots": cur - lo + 1})
    return row


def phase_swa_kernel(name):
    """K5 against swa_decode_ref on the card; returns the row at the serve
    shape (bf16, the serve's last decode step) for the kernels line."""
    from repro_torch.kernels import swa_decode as K5
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for dtype in ("float32", "bfloat16"):
        for cur in (100, SWA_WINDOW - 1, SWA_WINDOW, SWA_MAIN_CUR):
            cases.append(swa_case(K5, name, **SWA_SHAPE, S=SWA_S,
                                  window=SWA_WINDOW, cur=cur, dtype=dtype,
                                  gen=gen, timed=cur == SWA_MAIN_CUR))
            torch.cuda.empty_cache()
        for B, H, KV, hd, S, window, cur in ((2, 1, 1, 80, 37, 16, 36),
                                             (3, 5, 1, 32, 300, 64, 0)):
            cases.append(swa_case(K5, name, B, H, KV, hd, S, window, cur,
                                  dtype, gen, timed=False))
    emit({"phase": "swa_kernel", "atol": SWA_ATOL, "rtol": SWA_RTOL,
          "cases": cases})
    return next(c for c in cases if c["dtype"] == "bfloat16"
                and c["cur"] == SWA_MAIN_CUR)


def phase_serve_parity():
    """The port's serve on the card against the same on the CPU, at full
    width with the cuts listed in the phase line."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import api
    cuts = {"num_layers": 2, "window": 256}
    kw = dict(batch=2, prompt_len=320, gen=4, seed=3)
    out = {"phase": "serve_parity", "arch": ARCH, "cuts": cuts, **kw,
           "tol": PARITY_TOL}
    for dtype in ("float32", "bfloat16"):
        cfg = get_config(ARCH).replace(dtype=dtype, **cuts)
        params = api.init(cfg, torch.Generator().manual_seed(3),
                          torch.device("cpu"))
        cpu = serve(cfg, device="cpu", params=params, **kw)
        reset_counts()
        card = serve(cfg, device="cuda",
                     params={k: v.cuda() for k, v in params.items()}, **kw)
        launches = read_counts()["swa_decode"]
        check(launches == cfg.num_layers * (kw["gen"] - 1), launches)
        rec = parity_record(cpu, card, dtype, kw["gen"])
        rec["k5_launches"] = launches
        out[dtype] = rec
        del params, cpu, card
        torch.cuda.empty_cache()
    emit(out)


def parity_record(cpu, card, dtype, gen):
    """Card serve against CPU serve: prefill and decode logits within
    PARITY_TOL, and the greedy tokens."""
    lg_cpu, lg_card = cpu.logits.float(), card.logits.float().cpu()
    check(torch.isfinite(lg_card).all())
    same = (cpu.tokens == card.tokens.cpu()).all(dim=0)
    # greedy tokens may part only at a near tie of the CPU's top two
    # logits; logits are compared up to and including that step
    upto = int(same.float().argmin()) if not same.all() else gen
    if upto < gen:
        top2 = lg_cpu[:, upto].topk(2, dim=-1).values
        margin = float((top2[:, 0] - top2[:, 1]).min())
        check(margin <= 2 * PARITY_TOL[dtype],
              f"{dtype}: tokens part at step {upto}, margin {margin}")
    diff = (lg_card - lg_cpu)[:, :upto + 1].abs()
    rec = {"prefill_logits_err": float(diff[:, 0].max()),
           "decode_logits_err": (float(diff[:, 1:].max())
                                 if diff.shape[1] > 1 else None),
           "tokens_equal": bool(same.all()),
           "first_token_step_apart": None if same.all() else upto,
           "logits_absmax": float(lg_cpu.abs().max())}
    check(rec["prefill_logits_err"] <= PARITY_TOL[dtype], rec)
    check(rec["decode_logits_err"] is None
          or rec["decode_logits_err"] <= PARITY_TOL[dtype], rec)
    return rec


def phase_serve(name):
    """The danube serve path at full size: two same-seed runs, K5 counted
    over the first, then four decode steps under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import api
    cfg = get_config(ARCH)
    B, P, G = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    r = serve(cfg, seed=0, **SERVE)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in counts}
    want["swa_decode"] = cfg.num_layers * (G - 1)
    if counts != want:
        raise AssertionError(f"serve: kernel launches {counts}, expected "
                             f"{want}")
    check(r.tokens.shape == (B, G) and r.logits.shape == (B, G,
                                                          cfg.vocab_size))
    check(torch.isfinite(r.logits).all())
    check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()))
    check(torch.equal(r.tokens, r.logits.float().argmax(-1)))
    again = serve(cfg, seed=0, **SERVE)
    if not torch.equal(again.tokens, r.tokens):
        raise AssertionError("same-seed serve runs emitted different tokens")
    rec = {"phase": "serve", "arch": ARCH, **SERVE,
           "layers": cfg.num_layers, "window": cfg.window,
           "dtype": cfg.dtype,
           "decode_cur": [P, P + G - 2],
           "prefill_ms": r.prefill_s * 1e3,
           "prefill_tok_s": B * P / r.prefill_s,
           "decode_ms_per_step": r.decode_s * 1e3 / (G - 1),
           "decode_tok_s": B * (G - 1) / r.decode_s,
           "rerun_prefill_ms": again.prefill_s * 1e3,
           "rerun_decode_ms_per_step": again.decode_s * 1e3 / (G - 1),
           "max_memory_allocated": peak, "launches": counts,
           "identical_tokens": True,
           "identical_logits": bool(torch.equal(again.logits, r.logits)),
           "sample_tokens": r.tokens[0, :16].tolist()}
    del r, again
    torch.cuda.empty_cache()
    # where a decode step's device time goes: K5 against the rest
    dev = torch.device("cuda")
    params = api.init(cfg, torch.Generator(dev).manual_seed(0), dev)
    cache = api.make_cache(cfg, B, P + G, dev)
    tok = torch.zeros((B, 1), dtype=torch.long, device=dev)
    with torch.inference_mode():
        api.decode_step(params, cfg, cache, tok, P)       # warm
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        t0 = time.monotonic()
        for i in range(4):
            api.decode_step(params, cfg, cache, tok, P + 1 + i)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        prof.stop()
    weights = sum(v.numel() * v.element_size() for v in params.values())
    bw, _ = peaks(name)
    dec = device_profile(prof, wall, ours=("swa_decode",), label="k5_s")
    dec["device_activities_per_step"] = dec["activities"] / 4
    dec["k5_ms_per_step"] = dec["k5_s"] * 1e3 / 4
    rec["decode_profile_4_steps"] = dec
    rec["weight_bytes"] = weights
    rec["weight_stream_bound_ms_per_step"] = weights / bw * 1e3
    del params, cache
    torch.cuda.empty_cache()
    emit(rec)
    return counts


def ssd_inputs(B, S, H, dk, dv, gates, init, dtype, gen, per_head=False):
    """K4's operands as Mamba2 hands them over: q and k head-stride-0 views
    of one (B, S, 2 dk) projection (C and B), or with ``per_head`` their
    own values for every head, v (B, S, H, dv), f32 gates
    i = softplus(N(0, 1)) and a = i * -linspace(1, 16, H) ("model", zamba2's
    A at init: a averages -6.8, a chunk keeps ~e^-870 of the state) or
    a ~ U(-0.02, 0) ("gentle": a chunk keeps >= e^-2.6)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    if per_head:
        k = torch.randn((B, S, H, dk), generator=gen, device=dev).to(dt)
        q = torch.randn((B, S, H, dk), generator=gen, device=dev).to(dt)
    else:
        bc = torch.randn((B, S, 2 * dk), generator=gen, device=dev).to(dt)
        k = bc[..., :dk][:, :, None].expand(B, S, H, dk)
        q = bc[..., dk:][:, :, None].expand(B, S, H, dk)
    v = torch.randn((B, S, H, dv), generator=gen, device=dev).to(dt)
    i = F.softplus(torch.randn((B, S, H), generator=gen, device=dev))
    a = (i * -torch.linspace(1.0, 16.0, H, device=dev) if gates == "model"
         else -0.02 * torch.rand((B, S, H), generator=gen, device=dev))
    h0 = (torch.randn((B, H, dk, dv), generator=gen, device=dev) if init
          else None)
    return q, k, v, a, i, h0


def ssd_case(K4, name, shape, gates, init, dtype, gen):
    """K4 against its plain version's f32 result on the same inputs, y and
    the final state within ``K4.excess``. At the serve shape with gentle
    gates the plain version with each planted fault must fail that check;
    with the model's gates, two launches must give the same bits, 4 calls
    must make 4 kernel launches and nothing else (``one_kernel``), and the
    kernel and the plain version are timed beside the bound."""
    B, S, H, dk, dv, chunk = (shape[x] for x in ("B", "S", "H", "dk", "dv",
                                                 "chunk"))
    q, k, v, a, i, h0 = ssd_inputs(B, S, H, dk, dv, gates, init, dtype, gen,
                                   shape.get("per_head_qk", False))
    y, h = K4.ssd_scan(q, k, v, a, i, chunk=chunk, initial_state=h0)
    torch.cuda.synchronize()
    y32, h32 = K4.ssd_scan_ref(q.float(), k.float(), v.float(), a, i,
                               chunk=chunk, initial_state=h0)
    check(y.shape == v.shape and y.dtype == v.dtype
          and h.shape == (B, H, dk, dv) and h.dtype == torch.float32)
    check(torch.isfinite(y.float()).all() and torch.isfinite(h).all())
    rtol = K4.RTOL[v.dtype]
    excess = {"y": K4.excess(y, y32, rtol), "state": K4.excess(h, h32)}
    row = {**shape, "gates": gates, "initial_state": init, "dtype": dtype,
           "max_abs_err": float((y.float() - y32).abs().max()),
           "state_max_abs_err": float((h - h32).abs().max()),
           "y_absmax": float(y32.abs().max()),
           "state_absmax": float(h32.abs().max()), "excess": excess}
    if max(excess.values()) > 0:
        raise AssertionError(f"ssd_scan {row}: beyond the tolerance")
    serve_shape = shape is SSD_SERVE
    if serve_shape and gates == "gentle":
        faults = {}
        for fault in K4.FAULTS:
            fy, fh = K4.ssd_scan_ref(q, k, v, a, i, chunk=chunk,
                                     initial_state=h0, fault=fault)
            faults[fault] = {"y_excess": K4.excess(fy, y32, rtol),
                             "state_excess": K4.excess(fh, h32)}
            check(max(faults[fault].values()) > 0,
                  f"K4's tolerance passes a planted fault: {fault} {dtype}")
            del fy, fh
        row["planted_faults"] = faults
    if serve_shape and gates == "model":
        y2, h2 = K4.ssd_scan(q, k, v, a, i, chunk=chunk, initial_state=h0)
        row["bitwise_equal_rerun"] = bool(torch.equal(y, y2)
                                          and torch.equal(h, h2))
        check(row["bitwise_equal_rerun"], "two K4 launches differ")
        del y2, h2
        row["device_kernel"] = one_kernel(
            lambda: K4.ssd_scan(q, k, v, a, i, chunk=chunk,
                                initial_state=h0), "ssd_chunk_scan")
        bw, f32_peak = peaks(name)
        nbytes = K4.hbm_bytes(B, S, H, dk, dv, v.element_size())["minimum"]
        fl = K4.flops(B, S, H, dk, dv, chunk)
        row.update(K4.bound(B, S, H, dk, dv, chunk, v.element_size(), bw,
                            tensor_peak(name), f32_peak))
        row.update({
            # v and y alone (>= 235 MB) exceed the 50 MB L2: every launch
            # streams from HBM, as in the prefill, where other layers ran
            # in between
            "ms": time_ms(lambda: K4.ssd_scan(q, k, v, a, i, chunk=chunk)),
            "plain_ms": time_ms(lambda: K4.ssd_scan_ref(q, k, v, a, i,
                                                        chunk=chunk)),
            "library_ms": None, "min_bytes": nbytes, "flops": fl})
        row["achieved_tflop_s"] = fl / row["ms"] / 1e9
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
    del q, k, v, a, i, h0, y, h, y32, h32
    torch.cuda.empty_cache()
    return row


def phase_ssd_kernel(name):
    """K4 against ssd_scan_ref on the card; returns the row at the serve
    shape (bf16, the model's gates) for the kernels line."""
    from repro_torch.kernels import ssd_scan as K4
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [ssd_case(K4, name, shape, gates, init, dtype, gen)
             for dtype in ("float32", "bfloat16")
             for shape, gates, init in SSD_CASES]
    emit({"phase": "ssd_kernel", "atol_rel": K4.ATOL_REL,
          "rtol_bf16": K4.RTOL[torch.bfloat16],
          "tolerance": "|kernel - plain_f32| <= atol_rel * max|plain_f32| "
                       "+ rtol * |plain_f32|, rtol 0 in f32 and for the "
                       "state", "cases": cases})
    return next(c for c in cases if c["dtype"] == "bfloat16"
                and "ms" in c)


def phase_zamba_parity():
    """The zamba2 serve on the card against the same on the CPU, at full
    width with the cuts listed in the phase line."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import api
    kw = dict(batch=2, prompt_len=256, gen=4, seed=3)
    out = {"phase": "zamba_parity", "arch": ZAMBA, "cuts": ZPARITY_CUTS,
           **kw, "tol": PARITY_TOL}
    for dtype in ("float32", "bfloat16"):
        cfg = get_config(ZAMBA).replace(dtype=dtype, **ZPARITY_CUTS)
        params = api.init(cfg, torch.Generator().manual_seed(3),
                          torch.device("cpu"))
        t0 = time.monotonic()
        cpu = serve(cfg, device="cpu", params=params, **kw)
        cpu_s = time.monotonic() - t0
        reset_counts()
        card = serve(cfg, device="cuda",
                     params={k: v.cuda() for k, v in params.items()}, **kw)
        launches = read_counts()
        want = {k: 0 for k in launches}
        want["ssd_scan"] = cfg.num_layers
        if launches != want:
            raise AssertionError(f"zamba_parity: kernel launches {launches}, "
                                 f"expected {want}")
        rec = parity_record(cpu, card, dtype, kw["gen"])
        rec.update({"launches": launches, "cpu_serve_s": cpu_s})
        out[dtype] = rec
        del params, cpu, card
        torch.cuda.empty_cache()
    emit(out)


def phase_zamba_serve(name):
    """The zamba2 serve path at full size: two same-seed runs, K4 counted
    over the first, then one prefill and four decode steps under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import api, hybrid
    cfg = get_config(ZAMBA)
    B, P, G = ZSERVE["batch"], ZSERVE["prompt_len"], ZSERVE["gen"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    r = serve(cfg, seed=0, **ZSERVE)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in counts}
    want["ssd_scan"] = cfg.num_layers
    if counts != want:
        raise AssertionError(f"zamba_serve: kernel launches {counts}, "
                             f"expected {want}")
    check(r.tokens.shape == (B, G) and r.logits.shape == (B, G,
                                                          cfg.vocab_size))
    check(torch.isfinite(r.logits).all())
    check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()))
    check(torch.equal(r.tokens, r.logits.float().argmax(-1)))
    again = serve(cfg, seed=0, **ZSERVE)
    if not torch.equal(again.tokens, r.tokens):
        raise AssertionError("same-seed zamba2 serves emitted different "
                             "tokens")
    k, n_super, n_tail = hybrid._split_layers(cfg)
    rec = {"phase": "zamba_serve", "arch": ZAMBA, **ZSERVE,
           "layers": cfg.num_layers, "super_layers": n_super,
           "mamba_per_super": k, "tail_layers": n_tail, "dtype": cfg.dtype,
           "prefill_ms": r.prefill_s * 1e3,
           "prefill_tok_s": B * P / r.prefill_s,
           "decode_ms_per_step": r.decode_s * 1e3 / (G - 1),
           "decode_tok_s": B * (G - 1) / r.decode_s,
           "rerun_prefill_ms": again.prefill_s * 1e3,
           "rerun_decode_ms_per_step": again.decode_s * 1e3 / (G - 1),
           "max_memory_allocated": peak, "launches": counts,
           "identical_tokens": True,
           "identical_logits": bool(torch.equal(again.logits, r.logits)),
           "sample_tokens": r.tokens[0, :16].tolist()}
    del r, again
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    params = api.init(cfg, torch.Generator(dev).manual_seed(0), dev)
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(1)
                            ).to(dev)
    acts = (ProfilerActivity.CPU, ProfilerActivity.CUDA)
    with torch.inference_mode():
        # where the prefill's device time goes: K4 against the rest
        torch.cuda.synchronize()
        prof = profile(activities=acts)
        prof.start()
        t0 = time.monotonic()
        logits, cache = api.prefill(params, cfg, {"tokens": prompts}, P + G)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        prof.stop()
        pre = device_profile(prof, wall, ours=("ssd_chunk_scan",),
                             label="k4_s")
        check(pre["device_busy_s"] > 0, "the profiler saw no device work")
        pre["k4_share_of_busy"] = pre["k4_s"] / pre["device_busy_s"]
        rec["prefill_profile"] = pre
        tok = logits[:, -1].float().argmax(-1, keepdim=True)
        api.decode_step(params, cfg, cache, tok, P)       # warm
        torch.cuda.synchronize()
        prof = profile(activities=acts)
        prof.start()
        t0 = time.monotonic()
        for i in range(4):
            api.decode_step(params, cfg, cache, tok, P + 1 + i)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        prof.stop()
    dec = device_profile(prof, wall, ours=("ssd_chunk_scan",), label="k4_s")
    dec["device_activities_per_step"] = dec["activities"] / 4
    rec["decode_profile_4_steps"] = dec
    nbytes = {key: v.numel() * v.element_size() for key, v in params.items()}
    shared = sum(n for key, n in nbytes.items()
                 if key.startswith(hybrid.SHARED))
    # a decode step reads every weight once, the shared block once per
    # super-layer, and of the embedding only the B rows it looks up
    per_step = (sum(nbytes.values()) - nbytes["embed"]
                + B * cfg.d_model * params["embed"].element_size()
                + (n_super - 1) * shared)
    bw, _ = peaks(name)
    rec.update({
        "param_count": sum(v.numel() for v in params.values()),
        "param_bytes": sum(nbytes.values()), "shared_block_bytes": shared,
        "weight_bytes_per_decode_step": per_step,
        "weight_stream_bound_ms_per_step": per_step / bw * 1e3,
        "cache_bytes": {g: sum(t.numel() * t.element_size()
                               for t in leaves.values())
                        for g, leaves in cache.items()}})
    del params, cache, logits
    torch.cuda.empty_cache()
    emit(rec)
    return counts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's path needs one",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  fails where the checkout lacks src/
    name, smi_line = phase_device()
    phase_build()
    table = phase_kernels(name)
    phase_parity()
    launches = {k: 0 for k in counters()}
    sync_counts, sync_hashes = main_path("protocol_sync", False)
    async_counts, _ = main_path("protocol_async", True)
    for c in (sync_counts, async_counts):
        for k, n in c.items():
            launches[k] += n
    phase_cohort()
    phase_profile()
    reset_counts()
    _, again = run_protocol("determinism", async_mode=False)
    if again != sync_hashes:
        raise AssertionError("same-seed runs sealed different blocks")
    emit({"phase": "determinism", "blocks": len(again),
          "identical": True, "head": again[-1]})
    swa_row = phase_swa_kernel(name)
    phase_serve_parity()
    serve_counts = phase_serve(name)
    ssd_row = phase_ssd_kernel(name)
    phase_zamba_parity()
    zamba_counts = phase_zamba_serve(name)

    summary = []
    for k in table:
        main = next(r for r in k["sweep"]
                    if (r["W"], r["dtype"]) == MAIN_SHAPE)
        if launches[k["name"]] < 1:
            raise AssertionError(f"{k['name']} never launched on the main "
                                 f"path")
        summary.append({
            "name": k["name"], "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "launches": launches[k["name"]],
            "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shape": {"W": main["W"], "D": main["D"],
                      "dtype": main["dtype"]}})
    if serve_counts["swa_decode"] < 1:
        raise AssertionError("swa_decode never launched on the serve path")
    summary.append({
        "name": "swa_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/swa_decode.cu",
        "replaces": "src/repro/kernels/swa_decode.py:26",
        "launches": serve_counts["swa_decode"],
        "max_abs_err": swa_row["max_abs_err"], "ms": swa_row["ms"],
        "plain_ms": swa_row["plain_ms"], "bound_ms": swa_row["bound_ms"],
        "bound_by": swa_row["bound_by"], "library_ms": swa_row["library_ms"],
        "shape": {k: swa_row[k] for k in ("B", "H", "KV", "hd", "S",
                                           "window", "cur", "dtype")}})
    if zamba_counts["ssd_scan"] < 1:
        raise AssertionError("ssd_scan never launched on the zamba2 serve "
                             "path")
    summary.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:29",
        "launches": zamba_counts["ssd_scan"],
        "max_abs_err": ssd_row["max_abs_err"], "ms": ssd_row["ms"],
        "plain_ms": ssd_row["plain_ms"], "bound_ms": ssd_row["bound_ms"],
        "bound_by": ssd_row["bound_by"], "library_ms": ssd_row["library_ms"],
        "shape": {k: ssd_row[k] for k in ("B", "S", "H", "dk", "dv", "chunk",
                                           "gates", "dtype")}})
    print(smi_line, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
