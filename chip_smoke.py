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
                  W = 4096: error, CUDA-event times, byte bound
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

Then it prints the card's ``nvidia-smi`` line, one ``{"kernels": [...]}``
line (each kernel's launches on the main path, its error against the plain
version, its time, the plain version's time, its bound and, for K2, the
time of ``torch.mv`` as the library yardstick), and last
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

# published peaks (NVIDIA data sheets): HBM bytes/s and non-tensor f32 FLOP/s
PEAKS = [("H200", 4.8e12, 67e12), ("H100 NVL", 3.9e12, 60e12),
         ("H100 PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12)]


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
    for key, bw, f32 in PEAKS:
        if key in name:
            return bw, f32
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
    return {k["name"]: k["wrapper"] for k in kernel_table()}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def device_profile(prof, wall_s):
    """Device activity (kernels, copies, sets) from a torch.profiler run
    over ``wall_s`` seconds of host time: the busy time (the union of the
    activities' intervals), its share of the round, the trust kernels'
    time and the ten largest activities by name, each as [name, summed
    microseconds, count]. The sum by name can exceed the busy time where
    cuDNN spreads work over its own streams. CUPTI's own bookkeeping
    entries are left out."""
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
    trust_us = sum(t for k, (t, _) in by_name.items()
                   if any(n in k for n in ("split_colsum", "finish_colsum",
                                           "row_stats")))
    top = sorted(by_name.items(), key=lambda r: -r[1][0])[:10]
    return {"round_wall_s": wall_s, "device_busy_s": busy_us / 1e6,
            "busy_share": busy_us / 1e6 / wall_s,
            "trust_kernels_s": trust_us / 1e6, "activities": len(acts),
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
            "fused_async_agg": 3 if async_mode else 0}
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
    print(smi_line, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
