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
                  W = 4096: error, CUDA-event times, byte bound; one K1,
                  K2 or K3 call must launch exactly one kernel
                  (``one_kernel``) and two launches give equal bits; K1's
                  and K3's checks must reject the planted faults of
                  ``trust_score.FAULTS`` and ``fused_round.FAULTS``
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
  ssd_bwd_kernel  K4's backward (``ssd_scan_bwd``) against the plain
                  backward ``ssd_scan_bwd_ref`` and against autograd
                  through the plain forward, on the states K4's forward
                  wrote, f32 and bf16: zamba2's training shape (B 4, S
                  512, H 112, dk = dv = 64, chunk 128) with the model's
                  and gentle gates, the smoke shape, one chunk, an initial
                  state with a nonzero dh_final, per-head q and k; each of
                  ``ssd_scan.BWD_FAULTS`` must fail by a margin > 1; two
                  launches bitwise equal and one kernel a call; times
                  beside ``ssd_scan.bwd_bound`` and the plain backward's;
                  each case names the instantiation it took
                  (``ssd_scan.bwd_design``)
  zamba_grad_parity  zamba2-7b at full width cut to 3 layers: loss and
                  every leaf's gradient on the card against the CPU from
                  the same weights, f32 and bf16, batch 1, seq 256, remat
                  off and on; one K4 forward (two with remat in the
                  super-layer; the tail is not checkpointed) and one K4
                  backward a Mamba2 layer
  zamba_round     zamba2-7b at full width cut to one super-layer (D =
                  590,849,184) through ``SDFLBProtocol`` as
                  ``launch/train.py`` builds it (AdamW, remat, no chain):
                  3 sync rounds at W = 4 (2 clusters, batch 4, seq 512)
                  and 3 async rounds at the W the async state leaves room
                  for; the held-out loss (the next 512 positions of the
                  first round's streams) must fall in each run, K4's
                  forward and backward launch every round; round walls,
                  tokens/s, peak memory; a same-seed one-round rerun with
                  bitwise-equal params and scores; one worker's backward
                  under deterministic algorithms flags no op
  multi_task      one ``ChainNode`` on the card with two paper-CNN tasks:
                  ``big`` W = 4096 (64 x 64) sync, 8 settlement shards
                  through a ``ShardWorkerPool``, and ``small`` W = 16
                  async with random participation; four ticks (``big`` on
                  ticks 0 and 2, ``small`` on each), ``verify_chain(deep=
                  True)``, ``finalize()``; K1 once a round, K2 once a sync
                  round, K3 once an async round; tick walls, settle times,
                  peak memory; a same-seed rerun seals the same blocks
  multi_task_parity  the same two tasks at W = 16 each, no dropout, on the
                  card and on the CPU: scores within 1e-4, and equal
                  penalised workers, penalties, balances and payouts
  events          ``ChainNode.run_events`` at W = 4096 under churn
                  (stragglers, lost updates), sparse settlement: K3 once a
                  round; every event's delta-commit block proves a late and
                  an absent worker; deep chain check
  read_path       a reader thread holds a ``LightClient`` on a live W =
                  4096 node while it seals: header sync, batched proofs for
                  all 4096 workers of the last settled round (proofs/s),
                  that round's model blob streamed (MB/s); then a
                  checkpoint of the params and the events task's 4096 x
                  21840 f32 pending buffer saved with the ledger, restored
                  on the card bit for bit, its cid verified
  network         a card leader's seal listener feeds a follower replica
                  (``ingest_peer_blocks``); light clients of both audit the
                  same records; then ``repro_torch.examples.
                  decentralized_network`` at its defaults (host only)
  examples        ``quickstart``, ``async_federation``,
                  ``multi_task_federation`` and ``poisoning_defense``
                  (worker-level and ``--head``) on the card at their
                  defaults, K1-K3 once a round; the attackers end with
                  less stake than every honest worker; defended and
                  undefended accuracies; ``federated_llm`` (smollm-135m's
                  smoke config, 5 rounds, per-leaf: no kernel launches)
  f4              fault F4: zamba2 at full width cut to 2 Mamba2 layers
                  and the shared block, ``api.forward`` with params that
                  require grad launches K4 twice and a backward through it
                  the K4 backward kernel twice, every gradient finite;
                  under ``torch.no_grad()`` K4 twice and no backward; K1,
                  K2, K3 and K5 (no backward) refuse an input that
                  requires grad, launching nothing
  llm_parity      smollm-135m's smoke config (2 layers, d 288, V 512,
                  bf16), W = 4 (2 x 2), AdamW, 3 rounds of
                  ``SDFLBProtocol`` on the card and on the CPU, sync and
                  async, per-leaf and flat-pack: scores within 1e-3,
                  losses 2e-3, params two bf16 steps plus 8 lr, the same
                  penalties and payouts (T = 0.47 splits the workers; the
                  margins are checked); K1 with K2 or K3 once a flat-pack
                  round
  llm_round       smollm-135m at full size (30 layers, d 576, V 49,152,
                  bf16, D = 134,515,008) through ``launch/train.py
                  --full``: W = 8 in 2 clusters, batch 32, seq 128, AdamW,
                  remat; 3 sync per-leaf rounds with the chain (round
                  walls, tokens/s, settle times, each IPFS put of the 269
                  MB model, peak memory) and 3 async ones without it (the
                  puts set a chained round's pace); the held-out loss
                  must fall in each run; one sync and one async flat-pack
                  round from the same state as a per-leaf one, both timed
                  (scores within 1e-3, the same decisions, K1 with K2 or
                  K3 once; K1-K3 against their plain versions at (8,
                  134,515,008) bf16 (K3 also one kernel a call, a bitwise
                  rerun and its planted faults) and K1 against the per-leaf
                  statistics within 1e-3 of the sums of |terms|, with
                  times and bounds); a same-seed one-round rerun must seal
                  the same genesis and round blocks; one worker's backward
                  under ``torch.use_deterministic_algorithms(warn_only=
                  True)`` may flag no op; one worker's step profiled
  dense_serve     smollm-135m and yi-6b: card against CPU at full width
                  cut to 2 layers (f32 and bf16; batch 2, prompt 160, 4
                  tokens), then at full size (bf16, batch 4, prompt 1024,
                  32 tokens) twice with the same tokens; no kernel (both
                  have window 0)
  moe_parity      qwen2-moe-a2.7b and olmoe-1b-7b: card against CPU at
                  full width cut to 2 layers (f32 and bf16; batch 2,
                  prompt 160, 4 tokens); one MoE layer at qwen2's full
                  width (d 2048, 60 experts top-4, 4 shared) on tied
                  tokens with capacity drops, forward and backward, card
                  against CPU: the same capacity plan, outputs and
                  gradients within 1e-4 (f32) or top_k + 2 half bf16
                  steps of max; in bf16 the serve's logits within the
                  tolerance plus the CPU's own bf16-vs-f32 gap where a
                  routing choice flipped
  moe_serve       both MoE configs at full size (bf16; 14.3 B and 6.9 B
                  parameters), batch 4, prompt 1024, 32 tokens, twice with
                  the same tokens; decode ms a step beside the weight
                  floor (every expert runs at C >= 1); no kernel
  moe_round       olmoe-1b-7b at full width cut to one layer (D =
                  625,612,800) through ``SDFLBProtocol`` as
                  ``launch/train.py --full`` builds it, without the chain:
                  3 sync rounds at W = 4 (2 clusters, batch 4, seq 512)
                  and 3 async rounds at the W the async state leaves room
                  for, each with a falling held-out loss and no kernel;
                  the MoE layer's forward and backward at (4, 512, 2048)
                  three times without the deterministic flag, bitwise
                  equal; a same-seed one-round rerun with bitwise-equal
                  params and scores

Then it prints the run's total wall with each phase's wall seconds, the
card's ``nvidia-smi`` line, one
``{"kernels": [...]}``
line (each kernel's launches on its paths, its error against the plain
version, its time, the plain version's time, its bound and the time of a
library call where one computes the same function: ``torch.mv`` for K2,
``scaled_dot_product_attention`` for K5; none for K1, K3, K4 and K4's
backward, ``ssd_scan_bwd``), and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without the last line; so does a machine without CUDA.
"""
import dataclasses
import gc
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
# K4's backward at zamba2-7b's training shape (batch 4, seq 512: 4 chunks),
# the smoke shape, one chunk, a run from an initial state with a nonzero
# dh_final, and per-head q and k; the tolerance is ssd_scan.BWD_ATOL_REL
SSD_TRAIN = dict(B=4, S=512, H=112, dk=64, dv=64, chunk=128)
SSD_BWD_CASES = [(SSD_TRAIN, "model", False), (SSD_TRAIN, "gentle", False),
                 (dict(B=4, S=256, H=8, dk=16, dv=64, chunk=64), "gentle",
                  False),
                 (dict(SSD_TRAIN, S=128), "gentle", False),
                 (dict(SSD_TRAIN, B=2), "gentle", True),
                 (dict(SSD_TRAIN, B=2, per_head_qk=True), "model", True)]


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
             device="trust_stats",
             replaces="src/repro/kernels/trust_score.py:25"),
        dict(name="trust_agg", wrapper=trust_agg.trust_agg,
             plain=trust_agg.trust_agg_ref, bytes=trust_agg.hbm_bytes,
             flops=lambda W, D: 2 * W * D, nargs=2,
             library=lambda u, w: torch.mv(u.t(), w),
             source="src/repro_torch/csrc/trust_agg.cu",
             device="trust_agg_tiles",
             replaces="src/repro/kernels/trust_agg.py:21"),
        dict(name="fused_async_agg", wrapper=fused_round.fused_async_agg,
             plain=fused_round.fused_async_agg_ref,
             bytes=fused_round.hbm_bytes,
             flops=lambda W, D: 4 * W * D, nargs=4, library=None,
             source="src/repro_torch/csrc/fused_async_agg.cu",
             device="fused_async_agg_tiles",
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
    if k["name"] == "trust_score":
        from repro_torch.kernels import trust_score as K1
        again = k["wrapper"](*args)
        row["bitwise_equal_rerun"] = all(torch.equal(a, b)
                                         for a, b in zip(again, got))
        check(row["bitwise_equal_rerun"], f"two K1 launches differ, W={W}")
        row["device_kernel"] = one_kernel(lambda: k["wrapper"](*args),
                                          "trust_stats")
        row["plan"] = K1.plan(W, D_PAPER, u.element_size())._asdict()
        # each planted fault of the plain version against the plain
        # version: its largest distance over the tolerance (> 1 rejects)
        row["fault_margins"] = {}
        for fault in K1.FAULTS:
            bad = K1.trust_score_ref(*args, fault=fault)
            row["fault_margins"][fault] = max(
                float((b - e).abs().max()) / (RTOL * max(1.0, float(
                    e.abs().max()))) for b, e in zip(bad, want))
            check(row["fault_margins"][fault] > 1,
                  f"K1's check misses the fault {fault}, W={W} {dtype}")
        del again
    if k["name"] == "trust_agg":
        from repro_torch.kernels import trust_agg as K2
        again = k["wrapper"](*args)
        row["bitwise_equal_rerun"] = bool(torch.equal(again, got[0]))
        check(row["bitwise_equal_rerun"], f"two K2 launches differ, W={W}")
        row["device_kernel"] = one_kernel(lambda: k["wrapper"](*args),
                                          "trust_agg")
        row["plan"] = K2.plan(W, D_PAPER, u.element_size())._asdict()
        del again
    if k["name"] == "fused_async_agg":
        row.update(k3_checks(args, want, floor=1.0))
    del u, pending, args, got, want
    return row


def k3_checks(args, want, floor):
    """K3 beyond its error against ``want`` (the plain version on
    ``args``): two launches give the same bits, one call is one device
    kernel, the plan, and each planted fault of ``fused_round.FAULTS``
    fails the check, RTOL of the largest plain value of each output (at
    least ``floor``): its margin, distance over tolerance, is > 1."""
    from repro_torch.kernels import fused_round as K3
    u = args[0]
    a, b = K3.fused_async_agg(*args), K3.fused_async_agg(*args)
    out = {"bitwise_equal_rerun": all(torch.equal(x, y)
                                      for x, y in zip(a, b)),
           "plain_max": [float(e.abs().max()) for e in want]}
    del a, b
    check(out["bitwise_equal_rerun"], f"two K3 launches differ, "
          f"W={u.shape[0]} D={u.shape[1]}")
    out["device_kernel"] = one_kernel(lambda: K3.fused_async_agg(*args),
                                      "fused_async_agg")
    out["plan"] = K3.plan(*u.shape, u.element_size())._asdict()
    out["fault_margins"] = {}
    for fault in K3.FAULTS:
        bad = K3.fused_async_agg_ref(*args, fault=fault)
        out["fault_margins"][fault] = max(
            float((x - e).abs().max())
            / (RTOL * max(floor, float(e.abs().max())))
            for x, e in zip(bad, want))
        del bad
        check(out["fault_margins"][fault] > 1, f"K3's check misses the "
              f"fault {fault}, W={u.shape[0]} D={u.shape[1]}")
    return out


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


def _configs(clusters=4, per_cluster=4, async_mode=False, **fed_kw):
    from repro_torch.configs.base import FederationConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    fed = FederationConfig(num_clusters=clusters,
                           workers_per_cluster=per_cluster,
                           async_mode=async_mode, **fed_kw)
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
    """Each kernel's launch count: the wrapper and the attribute it counts
    in (K4's backward counts on ``ssd_scan`` itself)."""
    from repro_torch.kernels import ssd_scan, swa_decode
    out = {k["name"]: (k["wrapper"], "launches") for k in kernel_table()}
    out["swa_decode"] = (swa_decode.swa_decode, "launches")
    out["ssd_scan"] = (ssd_scan.ssd_scan, "launches")
    out["ssd_scan_bwd"] = (ssd_scan.ssd_scan, "bwd_launches")
    return out


def reset_counts():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def device_profile(prof, wall_s, ours, label, expect=()):
    """Device activity (kernels, copies, sets) from a torch.profiler run
    over ``wall_s`` seconds of host time: the busy time (the union of the
    activities' intervals), its share of the window, the time of the
    kernels whose names contain one of ``ours`` (under ``label``) and the
    ten largest activities by name, each as [name, summed microseconds,
    count]. The sum by name can exceed the busy time where cuDNN spreads
    work over its own streams. CUPTI's own bookkeeping entries are left
    out. Each name in ``expect`` must match a recorded kernel, so a
    renamed kernel cannot drop out of ``label`` unseen."""
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
    missing = [n for n in expect if not any(n in k for k in by_name)]
    check(not missing, f"{label}: no device record of {missing}")
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
            # the round returns with its last kernels (K2 or K3) still on
            # the card; stopped before they finish, the profiler loses
            # their device records
            torch.cuda.synchronize()
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
        # K1-K3 by their device names; the profiled round ran K1 and K2
        # or K3
        dev = {k["name"]: k["device"] for k in kernel_table()}
        rec["profile"] = device_profile(
            prof, walls[profile_round], ours=tuple(dev.values()),
            label="trust_kernels_s",
            expect=(dev["trust_score"],
                    dev["fused_async_agg" if async_mode else "trust_agg"]))
    return rec, [blk.hash for blk in proto.ledger.blocks]


def main_path(phase, async_mode):
    reset_counts()
    rec, hashes = run_protocol(phase, async_mode=async_mode)
    counts = read_counts()
    rec["launches"] = counts
    want = {"trust_score": 3, "trust_agg": 0 if async_mode else 3,
            "fused_async_agg": 3 if async_mode else 0, "swa_decode": 0,
            "ssd_scan": 0, "ssd_scan_bwd": 0}
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


def parity_record(cpu, card, dtype, gen, tol=None):
    """Card serve against CPU serve: prefill and decode logits within
    ``tol`` (PARITY_TOL by default), and the greedy tokens."""
    tol = PARITY_TOL[dtype] if tol is None else tol
    lg_cpu, lg_card = cpu.logits.float(), card.logits.float().cpu()
    check(torch.isfinite(lg_card).all())
    same = (cpu.tokens == card.tokens.cpu()).all(dim=0)
    # greedy tokens may part only at a near tie of the CPU's top two
    # logits; logits are compared up to and including that step
    upto = int(same.float().argmin()) if not same.all() else gen
    if upto < gen:
        top2 = lg_cpu[:, upto].topk(2, dim=-1).values
        margin = float((top2[:, 0] - top2[:, 1]).min())
        check(margin <= 2 * tol,
              f"{dtype}: tokens part at step {upto}, margin {margin}")
    diff = (lg_card - lg_cpu)[:, :upto + 1].abs()
    rec = {"prefill_logits_err": float(diff[:, 0].max()),
           "decode_logits_err": (float(diff[:, 1:].max())
                                 if diff.shape[1] > 1 else None),
           "tokens_equal": bool(same.all()),
           "first_token_step_apart": None if same.all() else upto,
           "logits_absmax": float(lg_cpu.abs().max())}
    check(rec["prefill_logits_err"] <= tol, rec)
    check(rec["decode_logits_err"] is None
          or rec["decode_logits_err"] <= tol, rec)
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


# -- the rest of the SDFL-B system on the card -------------------------------

# multi_task: ``big`` fires on ticks 0 and 2, ``small`` on every tick
MT_TICKS = [("big", "small"), ("small",), ("big", "small"), ("small",)]
MT_BIG = (64, 64, 32)          # clusters, workers a cluster, batch a worker
MT_SMALL = (4, 4, 64)
EV_SHAPE = (64, 64, 32)        # events phase: W = 4096
EVENTS = 4                     # arrival events
READ_TICKS = 3                 # read_path: W = 4096 ticks while reading
PROOF_BATCH = 1024             # workers a proof batch in read_path
# card vs CPU on the multi-task node: scores absolute (the tolerance of
# the parity phase); every settlement decision must be equal
MT_SCORE_TOL = 1e-4
# thresholds that split the parity run's cohorts (its scores lie in
# 0.50-0.75 and 0.63-0.85; the nearest is 1e-3 away)
MT_PARITY_T = {"big": 0.65, "small": 0.73}


def _without_dropout(round_fn):
    """A task's round with no dropout: its masks come from each device's
    own generator, so the card and the CPU would draw different ones."""
    def call(params, opt, batch, rng, *rest):
        return round_fn(params, opt, batch, None, *rest)
    return call


def run_multi_task(big, *, device=None, seed=0, dropout=True,
                   thresholds=None):
    """One ChainNode with two tasks: ``big`` (``big`` = (clusters, workers
    a cluster, batch a worker), sync, 8 settlement shards through a shard
    pool) and ``small`` (4 x 4, async, random participation), driven
    through MT_TICKS, then flushed and deep-verified. ``thresholds``:
    trust thresholds by task (default the federation's). Returns the node
    (not finalized) and each tick's wall seconds."""
    from repro_torch.core.node import ChainNode
    from repro_torch.data.datasets import make_federated_mnist
    cfg, big_fed, tc = _configs(*big[:2], task_id="big",
                                settlement_shards=8)
    small_fed = _configs(*MT_SMALL[:2], True, task_id="small")[1]
    feds = {"big": big_fed, "small": small_fed}
    for tid, t in (thresholds or {}).items():
        feds[tid] = dataclasses.replace(feds[tid], trust_threshold=t)
    shapes = {"big": big, "small": MT_SMALL}
    data = {tid: make_federated_mnist(c * p, samples=c * p * b,
                                      seed=seed + i)
            for i, (tid, (c, p, b)) in enumerate(sorted(shapes.items()))}
    rng = np.random.default_rng(seed + 7)
    ticks = []
    for fire in MT_TICKS:
        mask = (rng.random(MT_SMALL[0] * MT_SMALL[1]) > 0.4).astype(np.int32)
        mask[0] = 1
        ticks.append(({tid: data[tid].round_batches(shapes[tid][2])
                       for tid in fire}, {"small": mask}))
    node = ChainNode(pipeline_depth=2, settler_pool_size=8, device=device)
    for i, tid in enumerate(sorted(feds)):
        task = node.create_task(tid, cfg, feds[tid], tc, seed=seed + i)
        if not dropout:
            task._round_fn = _without_dropout(task._round_fn)
    check(node._shard_pool is not None, "multi_task: no ShardWorkerPool")
    walls = []
    for batches, part in ticks:
        t = time.monotonic()
        node.run_tick(batches, participation=part)
        walls.append(time.monotonic() - t)
    node.flush()
    check(node.ledger.verify_chain(deep=True), "multi_task: deep verify")
    return node, walls


def _trust_launches(sync_rounds, async_rounds):
    """K1 once a round, K2 once a sync round, K3 once an async round."""
    return {"trust_score": sync_rounds + async_rounds,
            "trust_agg": sync_rounds, "fused_async_agg": async_rounds,
            "swa_decode": 0, "ssd_scan": 0, "ssd_scan_bwd": 0}


def _expect(phase, counts, want):
    if counts != want:
        raise AssertionError(f"{phase}: kernel launches {counts}, "
                             f"expected {want}")


def phase_multi_task():
    """Two tasks on one card node (W = 4096 sync through the shard pool,
    W = 16 async), four ticks at two cadences; a same-seed rerun must
    seal the same blocks."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    node, walls = run_multi_task(MT_BIG)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    big, small = node.tasks["big"], node.tasks["small"]
    check(len(big.history) == 2 and len(small.history) == 4)
    _expect("multi_task", counts, _trust_launches(2, 4))
    multi = [b.index for b in node.ledger.blocks if b.task_roots]
    check(len(multi) == 2, f"multi_task: multi-task blocks {multi}")
    for t in (big, small):
        check(all(r.settled and np.isfinite(r.scores).all()
                  for r in t.history))
        check(all(torch.isfinite(v).all() for v in t.global_params.values()))
    hashes = [b.hash for b in node.ledger.blocks]
    rec = {"phase": "multi_task",
           "tasks": {tid: {"W": t.W, "async": t.fed.async_mode,
                           "settlement_shards": t.fed.settlement_shards,
                           "rounds": len(t.history),
                           "settle_s": [r.settle_time for r in t.history],
                           "penalised": [int((r.penalties > 0).sum())
                                         for r in t.history]}
                     for tid, t in sorted(node.tasks.items())},
           "ticks": [list(f) for f in MT_TICKS], "tick_wall_s": walls,
           "shard_pool_threads": node._shard_pool.num_threads,
           "blocks": len(hashes), "multi_task_blocks": multi,
           "max_memory_allocated": peak, "launches": counts}
    payouts = node.finalize()
    check(set(payouts) == {"big", "small"})
    del node, big, small
    torch.cuda.empty_cache()
    again, _ = run_multi_task(MT_BIG)
    same = [b.hash for b in again.ledger.blocks[:len(hashes)]] == hashes
    again.finalize()
    del again
    torch.cuda.empty_cache()
    check(same, "multi_task: same-seed runs sealed different blocks")
    rec["identical_rerun"] = True
    emit(rec)
    return counts


def phase_multi_task_parity():
    """The multi-task node at W = 16 + 16 on the card and on the CPU, no
    dropout: scores within MT_SCORE_TOL, every decision equal."""
    reset_counts()
    card, _ = run_multi_task(MT_SMALL, device="cuda", dropout=False,
                             thresholds=MT_PARITY_T)
    counts = read_counts()
    _expect("multi_task_parity", counts, _trust_launches(2, 4))
    cpu, _ = run_multi_task(MT_SMALL, device="cpu", dropout=False,
                            thresholds=MT_PARITY_T)
    out = {"phase": "multi_task_parity", "score_tol": MT_SCORE_TOL,
           "launches": counts}
    for tid in sorted(card.tasks):
        g, c = card.tasks[tid], cpu.tasks[tid]
        gs = np.stack([r.scores for r in g.history])
        cs = np.stack([r.scores for r in c.history])
        diff = float(np.abs(gs - cs).max())
        check(diff <= MT_SCORE_TOL, f"{tid}: scores off by {diff}")
        T = g.fed.trust_threshold
        check(np.array_equal(gs < T, cs < T), f"{tid}: penalised workers")
        for a, b in zip(g.history, c.history):
            check(np.array_equal(a.penalties, b.penalties),
                  f"{tid}: penalties of round {a.round_index}")
        check(np.array_equal(g.contract.stake, c.contract.stake)
              and np.array_equal(g.contract.balance, c.contract.balance)
              and g.contract.requester_balance
              == c.contract.requester_balance, f"{tid}: balances")
        out[tid] = {"max_score_diff": diff, "rounds": len(g.history),
                    "penalised": int((gs < T).sum())}
    pay_card, pay_cpu = card.finalize(), cpu.finalize()
    check(pay_card == pay_cpu, f"payouts {pay_card} vs {pay_cpu}")
    out["payouts_equal"] = True
    emit(out)
    return counts


def phase_events():
    """``ChainNode.run_events`` at W = 4096 (64 x 64) under churn: each
    event seals its arrived cohort as a delta commit that still proves
    the late and the absent workers. Returns the launch counts and the
    task (its pending buffer goes into read_path's checkpoint)."""
    from repro_torch.core import async_sim
    from repro_torch.core.node import ChainNode
    from repro_torch.data.datasets import make_federated_mnist
    clusters, per_cluster, batch = EV_SHAPE
    W = clusters * per_cluster
    cfg, fed, tc = _configs(clusters, per_cluster, True, task_id="events",
                            staleness_alpha=0.5, buffer_size=W // 2,
                            sparse_settlement=True)
    profiles = async_sim.heterogeneous_profiles(
        W, straggler_frac=0.25, straggler_slowdown=6.0, failure_prob=0.05,
        seed=0)
    data = make_federated_mnist(W, samples=W * batch, seed=3)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    node = ChainNode(pipeline_depth=2)
    task = node.create_task("events", cfg, fed, tc, seed=0,
                            profiles=profiles)
    reset_counts()
    t0 = time.monotonic()
    recs = node.run_events({"events": lambda r: data.round_batches(batch)},
                           events=EVENTS)["events"]
    node.flush()
    wall = time.monotonic() - t0
    counts = read_counts()
    check(len(recs) >= 2, f"events: {len(recs)} rounds")
    _expect("events", counts, _trust_launches(0, len(recs)))
    check(node.ledger.verify_chain(deep=True), "events: deep verify")
    c = task.contract
    proved = []
    for rec in recs[1:]:
        part = rec.participation
        late = np.flatnonzero((part > 0) & (rec.staleness > 0))
        absent = np.flatnonzero(part == 0)
        check(len(late) and len(absent), "events: no late or absent worker")
        for kind, w in (("late", int(late[0])), ("absent", int(absent[0]))):
            p = c.settlement_proof(rec.round_index, w)
            check(c.verify_settlement(p) and p["record"]["worker"] == w)
            if kind == "late":
                check(p["record"]["round"] == rec.round_index
                      and p["record"]["staleness"] == int(rec.staleness[w]))
            else:
                check(p["record"]["round"] < rec.round_index)
            proved.append([rec.round_index, kind, w])
        check((rec.penalties[part == 0] == 0).all())
    pending = task.async_state.pending
    check(tuple(pending.shape) == (W, D_PAPER) and bool(
        torch.isfinite(pending).all()))
    emit({"phase": "events", "W": W, "events": EVENTS, "rounds": len(recs),
          "cohorts": [int(r.participation.sum()) for r in recs],
          "sim_time": [r.sim_time for r in recs],
          "max_staleness": [int(r.staleness.max()) for r in recs],
          "settle_s": [r.settle_time for r in recs], "wall_s": wall,
          "round_wall_s": [r.wall_time for r in recs],
          "proved": proved, "max_memory_allocated":
          torch.cuda.max_memory_allocated(), "launches": counts})
    node.finalize()
    return counts, task


def phase_read_path(events_task):
    """A reader thread holds a LightClient on a live W = 4096 node while
    the main thread keeps sealing: it syncs headers, fetches and verifies
    proofs for all 4096 workers of the last settled round, and streams
    that round's model blob. Then a checkpoint of ``big``'s params and the
    events task's pending buffer is saved with the ledger, restored on the
    card bit for bit, and its cid verified."""
    import threading
    from repro_torch.checkpoint import store
    from repro_torch.core.node import ChainNode
    from repro_torch.data.datasets import make_federated_mnist
    from repro_torch.serve import LightClient, StaleProofError
    c_, p_, b_ = MT_BIG
    W = c_ * p_
    cfg, fed, tc = _configs(c_, p_, task_id="big", settlement_shards=8)
    data = make_federated_mnist(W, samples=W * b_, seed=0)
    node = ChainNode(pipeline_depth=2, settler_pool_size=8)
    task = node.create_task("big", cfg, fed, tc)
    reset_counts()
    node.run_tick({"big": data.round_batches(b_)})
    node.flush()
    server = node.read_server()
    got, errors = {}, []
    sealing = threading.Event()

    def reader():
        try:
            lc = LightClient(server, client_id="auditor")
            lc.sync()
            got["height_at_start"] = lc.height
            r = server.latest_settled_round("big")
            t0 = time.monotonic()
            n = 0
            for lo in range(0, W, PROOF_BATCH):
                batch = lc.fetch_proofs("big", list(range(lo, lo
                                                          + PROOF_BATCH)),
                                        round_index=r)
                try:
                    ok = lc.verify_batch(batch)
                except StaleProofError:
                    lc.sync()
                    ok = lc.verify_batch(batch)
                check(ok, f"read_path: proofs {lo}.. failed")
                n += len(batch)
            got["proofs_s"] = time.monotonic() - t0
            got["proofs"] = n
            blk = node.ledger.blocks[task.contract._round_blocks[r]]
            cid = next(tx["cid"] for tx in blk.transactions
                       if isinstance(tx, dict) and tx.get("type") == "model"
                       and tx["round"] == r)
            t0 = time.monotonic()
            leaves = lc.fetch_checkpoint(cid)
            got["stream_s"] = time.monotonic() - t0
            got["stream_bytes"] = server.checkpoint_manifest(cid).size
            check(len(leaves) == len(task.global_params))
            got["round"] = r
            while not sealing.wait(0.05):   # follow the head to the end
                lc.sync()
            lc.sync()
            got["height_at_end"] = lc.height
        except BaseException as e:          # re-raised on the main thread
            errors.append(e)

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    for _ in range(READ_TICKS - 1):
        node.run_tick({"big": data.round_batches(b_)})
    node.flush()
    sealing.set()
    th.join()
    if errors:
        raise errors[0]
    counts = read_counts()
    _expect("read_path", counts, _trust_launches(READ_TICKS, 0))
    check(got["proofs"] == W)
    tree = {"big": task.global_params,
            "events_pending": events_task.async_state.pending}
    nbytes = sum(v.numel() * v.element_size()
                 for v in (*tree["big"].values(), tree["events_pending"]))
    path = os.path.join(ROOT, "build", "chip_smoke", "checkpoint.msgpack")
    t0 = time.monotonic()
    cid = store.save(path, tree, step=len(task.history), ledger=node.ledger)
    save_s = time.monotonic() - t0
    check(node.ledger.head.transactions[0]["cid"] == cid)
    t0 = time.monotonic()
    back, step = store.restore(path, tree)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    check(step == len(task.history))
    check(back["events_pending"].device.type == "cuda")
    check(torch.equal(back["events_pending"], tree["events_pending"]),
          "read_path: pending buffer restored with other bits")
    check(all(torch.equal(back["big"][k], v)
              for k, v in tree["big"].items()), "read_path: params")
    check(store.verify(path, cid), "read_path: checkpoint cid")
    file_bytes = os.path.getsize(path)
    os.remove(path)
    check(node.ledger.verify_chain(deep=True))
    node.finalize()
    emit({"phase": "read_path", "W": W, "ticks": READ_TICKS,
          "proof_batch": PROOF_BATCH, "round": got["round"],
          "headers_at_start": got["height_at_start"],
          "headers_at_end": got["height_at_end"],
          "proofs": got["proofs"], "proofs_s": got["proofs_s"],
          "proofs_per_s": got["proofs"] / got["proofs_s"],
          "stream_bytes": got["stream_bytes"], "stream_s": got["stream_s"],
          "stream_mb_per_s": got["stream_bytes"] / 1e6 / got["stream_s"],
          "checkpoint": {"tensor_bytes": nbytes, "file_bytes": file_bytes,
                         "save_s": save_s, "restore_s": restore_s,
                         "bitwise_equal": True, "cid_verified": True},
          "server": {"proof_batches": server.proof_batches,
                     "digests_shipped": server.digests_shipped,
                     "chunks_streamed": server.chunks_streamed},
          "launches": counts})
    del back, tree
    torch.cuda.empty_cache()
    return counts


def phase_network():
    """A card leader whose seal listener feeds a follower replica; light
    clients of both audit the same records. Then the settlement network
    example at its defaults (host only)."""
    import contextlib
    import io
    from repro_torch.core.node import ChainNode
    from repro_torch.data.datasets import make_federated_mnist
    from repro_torch.examples import decentralized_network
    from repro_torch.serve import ChainReadServer, LightClient
    cfg, fed, tc = _configs(task_id="net")
    leader = ChainNode(pipeline_depth=2)
    follower = ChainNode(pipeline_depth=0)
    adopted = []
    leader.add_seal_listener(lambda blk, commit: adopted.append(
        follower.ingest_peer_blocks([blk], {blk.index: commit})))
    task = leader.create_task("net", cfg, fed, tc, seed=0)
    data = make_federated_mnist(16, samples=16 * 64, seed=4)
    reset_counts()
    for _ in range(3):
        leader.run_tick({"net": data.round_batches(64)})
    leader.flush()
    counts = read_counts()
    _expect("network", counts, _trust_launches(3, 0))
    check(sum(adopted) == len(leader.ledger.blocks) - 1)
    check([b.hash for b in follower.ledger.blocks]
          == [b.hash for b in leader.ledger.blocks], "network: replica")
    check(follower.ledger.verify_chain(deep=True))
    lc_leader = LightClient(leader.read_server())
    lc_follower = LightClient(ChainReadServer(
        ledger=follower.ledger, contracts={"net": task.contract}))
    audits = 0
    for lc in (lc_leader, lc_follower):
        lc.sync()
    for r in range(3):
        for w in range(task.W):
            check(lc_follower.audit("net", w, round_index=r)
                  == lc_leader.audit("net", w, round_index=r))
            audits += 1
    leader.finalize()
    follower.close()
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        decentralized_network.main()
    lines = buf.getvalue().splitlines()
    check(lines[-1] == "all scenarios converged.")
    emit({"phase": "network", "replica_blocks": len(follower.ledger.blocks),
          "audits_equal": audits, "launches": counts,
          "harness_s": time.monotonic() - t0,
          "harness_lines": [ln.strip() for ln in lines if ln.strip()]})
    return counts


def phase_examples():
    """The port's examples on the card at their defaults; each one's K1-K3
    launches once a round."""
    import contextlib
    import io
    from repro_torch.examples import (async_federation, federated_llm,
                                      multi_task_federation,
                                      poisoning_defense, quickstart)
    out = {"phase": "examples"}
    total = {k: 0 for k in counters()}

    def run(name, fn, launches):
        reset_counts()
        buf = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            res = fn()
        counts = read_counts()
        _expect(name, counts, launches(res))
        for k, n in counts.items():
            total[k] += n
        out[name] = {"seconds": time.monotonic() - t0, "launches": counts,
                     "last_lines": buf.getvalue().splitlines()[-2:]}
        return res

    q = run("quickstart", quickstart.main, lambda r: _trust_launches(30, 0))
    check(q["verified"] and q["record"]["worker"] == 0)
    a = run("async_federation", async_federation.main,
            lambda r: _trust_launches(0, sum(map(len,
                                                 r["records"].values()))))
    check(a["speedup"] > 1.0)
    m = run("multi_task_federation", multi_task_federation.main,
            lambda r: _trust_launches(sum(r["rounds"].values()), 0))
    check(m["verified"] and m["proof_ok"])
    for head in (False, True):
        name = "poisoning_defense" + ("_head" if head else "")
        p = run(name, lambda: poisoning_defense.main(head),
                lambda r: _trust_launches(80, 0))
        stakes = p["defended"]["stakes"]
        honest = [w for w in range(8) if w not in p["attackers"]]
        check(max(stakes[w] for w in p["attackers"])
              < min(stakes[w] for w in honest),
              f"{name}: attacker stakes {stakes}")
        check(all(stakes[w] < 10.0 for w in p["attackers"]))
        out[name].update({"acc_defended": p["defended"]["acc"],
                          "acc_undefended": p["undefended"]["acc"],
                          "stakes": stakes,
                          "attackers": sorted(p["attackers"])})
    f = run("federated_llm", federated_llm.main,
            lambda r: _trust_launches(0, 0))
    check(f["verified"] and f["blocks"] == 7
          and np.isfinite(f["losses"]).all())
    out["federated_llm"]["mean_loss"] = f["losses"]
    emit(out)
    return total


# -- the LLM slice: fault F4, federated smollm-135m, dense serves ------------

LLM = "smollm-135m"
# ``launch/train.py --arch smollm-135m --full``: W = 8 in 2 clusters, batch
# 32, seq 128 (its defaults), AdamW lr 3e-4, clip 1.0, remat; 3 rounds a
# run. Each round with the chain puts the 269 MB model to IPFS (as 538 MB
# of f32, zlib on one host core: 105-128 s a put beside an NVIDIA H100
# 80GB HBM3 at 700.00 W, PERF.md section 5), and a round waits for the
# last one's block, so only the sync run and a one-round same-seed rerun
# settle on the chain; the async run trains without it.
LLM_TRAIN = ["--arch", LLM, "--full", "--workers", "8", "--clusters", "2",
             "--batch", "32", "--seq", "128", "--rounds", "3"]
LLM_ASYNC = ["--async", "--no-blockchain"]
LLM_RERUN = ["--rounds", "1"]
LLM_HELDOUT_SEED = 1000          # a batch no round trains on
# flat-pack (K1 over the (8, 134,515,008) bf16 pack) against the per-leaf
# statistics: f32 sums over 1.3e8 terms in two orders. K1's longest chain
# of f32 additions at that shape is ~8.1e3 (a thread walks ~7,962 strips of
# the 132 clusters, then its pieces, the warp and the clusters' partials);
# the per-leaf path's reductions are not longer. With the standard bound
# gamma_n = n * 2^-24 for each, |difference| <= 2 * 8.1e3 * 2^-24 *
# sum|terms| < 1e-3 * sum|terms| (sum|u_w c| for dot, sq_u itself for
# sq_u, sq_c itself for sq_c).
LLM_STATS_RTOL = 1e-3
# the scores take the statistics through the cosine and norm terms
# (weights 0.5 and 0.3): absolute on scores in [0, 1], flat-pack against
# per-leaf on the card, and card against CPU at smoke size (bf16 rounds at
# other places there; tests/test_torch_train.py measured 1.6e-4 against
# the reference)
LLM_SCORE_TOL = 1e-3
# card vs CPU at smoke size (2 x 2 workers, 3 rounds): losses absolute;
# params within two bf16 steps plus the 2.6 lr a round a worker's AdamW
# step (~lr sign(g)) can take the other way where a gradient is near 0
LLM_LOSS_TOL = 2e-3
LLM_PARITY_T, LLM_PARITY_TOPK = 0.47, 2      # splits the smoke run's workers
LLM_MASKS = [[1, 0, 1, 1], [0, 1, 1, 1], [1, 1, 0, 1]]
LLM_FLAT_MASK = [1, 1, 0, 1, 1, 0, 1, 1]     # the async flat-pack round
DENSE = ("smollm-135m", "yi-6b")
DENSE_SERVE = dict(batch=4, prompt_len=1024, gen=32)
DENSE_PARITY = dict(batch=2, prompt_len=160, gen=4, seed=3)


def phase_f4():
    """Fault F4, now that K4 has a backward: zamba2 at full width cut to 2
    Mamba2 layers and the shared block, ``api.forward`` with params that
    require grad launches K4 once a Mamba2 layer (keeping the states before
    each chunk), and a backward through it launches the K4 backward kernel
    once a layer, every leaf's gradient finite; under ``torch.no_grad()``
    the forward launches K4 twice and no backward. K1, K2, K3 and K5, which
    have no backward, refuse an input that requires grad, launching
    nothing."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import fused_round, swa_decode, trust_agg, \
        trust_score
    from repro_torch.models import api
    dev = torch.device("cuda")
    cfg = get_config(ZAMBA).replace(num_layers=2, shared_attn_every=2)
    params = api.init(cfg, torch.Generator(dev).manual_seed(0), dev)
    for p in params.values():
        p.requires_grad_(True)
    tokens = torch.zeros((1, cfg.ssm.chunk_size), dtype=torch.long,
                         device=dev)
    reset_counts()
    logits, _ = api.forward(params, cfg, {"tokens": tokens})
    fwd = read_counts()
    grads = torch.autograd.grad(logits.float().square().mean(),
                                list(params.values()))
    torch.cuda.synchronize()
    counts = read_counts()
    check(fwd["ssd_scan"] == 2 and fwd["ssd_scan_bwd"] == 0
          and counts["ssd_scan"] == 2 and counts["ssd_scan_bwd"] == 2,
          f"f4: launches {fwd} then {counts}")
    check(all(torch.isfinite(g).all() for g in grads), "f4: gradients")
    del grads, logits
    reset_counts()
    with torch.no_grad():
        logits, _ = api.forward(params, cfg, {"tokens": tokens})
    torch.cuda.synchronize()
    no_grad = read_counts()
    check(no_grad["ssd_scan"] == 2 and no_grad["ssd_scan_bwd"] == 0
          and torch.isfinite(logits).all(), no_grad)
    del params, logits
    g = torch.Generator(dev).manual_seed(1)
    u = torch.randn((8, 4096), generator=g, device=dev)
    w = torch.rand((8,), generator=g, device=dev)
    q = torch.randn((2, 8, 64), generator=g, device=dev)
    kv = torch.randn((2, 300, 2, 64), generator=g, device=dev)
    refused = {}
    for name, fn, args in (
            ("trust_score", trust_score.trust_score_stats, lambda x: (x,)),
            ("trust_agg", trust_agg.trust_agg, lambda x: (x, w)),
            ("fused_async_agg", fused_round.fused_async_agg,
             lambda x: (x, u, w, w)),
            ("swa_decode", swa_decode.swa_decode,
             lambda x: (q, kv, x, 299, 128))):
        x = (kv if name == "swa_decode" else u).clone().requires_grad_(True)
        before = fn.launches
        try:
            fn(*args(x))
            refused[name] = False
        except RuntimeError as e:
            refused[name] = "no backward" in str(e)
        check(refused[name] and fn.launches == before, f"f4: {name}")
    torch.cuda.empty_cache()
    emit({"phase": "f4", "arch": ZAMBA, "layers": cfg.num_layers,
          "grad_k4_launches": counts["ssd_scan"],
          "grad_k4_bwd_launches": counts["ssd_scan_bwd"],
          "no_grad_k4_launches": no_grad["ssd_scan"],
          "no_grad_k4_bwd_launches": no_grad["ssd_scan_bwd"],
          "refused": refused})


# -- the zamba2 training slice: K4's backward, gradients, federated rounds ---

# zamba_grad_parity: loss and gradients on the card against the CPU from
# the same weights (ZPARITY_CUTS at full width), batch 1, seq 256 (two
# chunks). Absolute on the loss, each leaf's gradient relative to its
# largest CPU value. f32: cuBLAS and the CPU's GEMMs, K4 and its backward
# against their plain versions, all sum in other orders; the K4 checks
# alone allow 1e-4 of max a layer, and the gate leaves' gradients (A_log,
# dt_bias) sum every position's share: 2e-4 (measured 5.3e-5, tail A_log;
# loss 9.5e-7). bf16: the card and the CPU round activations to bf16 at
# other places: the dense decoders' bf16 bounds, loss 2e-3 and gradients
# 5e-2 of max (measured 2.1e-4 and 1.4e-2, the embedding; NVIDIA H100
# 80GB HBM3 at 700.00 W, PERF.md section 6).
ZGRAD = dict(batch=1, seq=256, seed=5)
ZGRAD_TOL = {"float32": {"loss": 1e-4, "grad": 2e-4},
             "bfloat16": {"loss": 2e-3, "grad": 5e-2}}
# zamba_round: zamba2-7b at full width cut to one super-layer (2 Mamba2
# layers and the shared block), bf16, through SDFLBProtocol as
# launch/train.py builds it (AdamW lr 3e-4, clip 1.0, remat), no chain: a
# round would put ~2.4 GB of f32 to IPFS, ~9 min at the ~4.4 MB/s of zlib
# on one core (PERF.md section 5). 3 sync rounds at W = 4, then 3 async
# rounds at the W that the async state leaves room for.
ZROUND_CUTS = {"num_layers": 2, "shared_attn_every": 2}
ZROUND = dict(workers=4, clusters=2, batch=4, seq=512, rounds=3)
# The held-out loss that must fall is taken on the next `seq` positions of
# the first round's streams (each worker's own generator, fresh noise),
# which no round trains on. A batch of an unrelated seed shares nothing
# with the training streams but their periods (``synthetic_tokens``): its
# loss is reported, not held to falling. After 3 sync rounds at full width
# it rose on one set of training streams (10.6966 -> 10.7155) and fell on
# another (10.6966 -> 10.6757; NVIDIA H100 80GB HBM3 at 700.00 W, PERF.md
# section 6).
ZROUND_FRESH_SEED = 1000
# device bytes a parameter a worker (params, AdamW m and v, gradients,
# updates; async adds f32 pending, total and new pending): smollm-135m's
# federated runs, NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 5)
ZROUND_BYTES_PER_PARAM = {"sync": 27, "async": 43}
ZROUND_FREE = 5e9


def ssd_bwd_case(K4, name, shape, gates, init, dtype, gen):
    """K4's backward kernel against the plain backward's f32 result and
    against ``torch.autograd`` through the plain forward on the same card
    inputs (``K4.bwd_margins`` <= 1), both reading the states K4's forward
    wrote.
    At the training shape: each planted fault must fail by a margin > 1;
    with the model's gates two launches must give the same bits, 4 calls
    make 4 kernel launches and nothing else, and the kernel and the plain
    backward are timed beside the bound."""
    B, S, H, dk, dv, chunk = (shape[x] for x in ("B", "S", "H", "dk", "dv",
                                                 "chunk"))
    dev = torch.device("cuda")
    q, k, v, a, i, h0 = ssd_inputs(B, S, H, dk, dv, gates, init, dtype, gen,
                                   shape.get("per_head_qk", False))
    dy = torch.randn(v.shape, generator=gen, device=dev).to(v.dtype)
    dh = torch.randn((B, H, dk, dv), generator=gen, device=dev) \
        if init else None
    _, _, states = K4._launch_fwd(q, k, v, a, i, h0, chunk, True)
    K4.ssd_scan.bwd_launches = 0
    got = K4.ssd_scan_bwd(q, k, v, a, i, dy, dh, chunk=chunk,
                          initial_state=h0, states=states)
    torch.cuda.synchronize()
    check(K4.ssd_scan.bwd_launches == 1, "one backward launch a call")
    check([g.dtype for g in got] == [v.dtype] * 3 + [torch.float32] * 3)
    check(all(torch.isfinite(g.float()).all() for g in got))
    plain = K4.ssd_scan_bwd_ref(q.float(), k.float(), v.float(), a, i, dy, dh,
                                chunk=chunk, initial_state=h0, states=states)
    # autograd through the plain forward: q and k as the per-head views the
    # kernel's dq and dk answer to
    leaves = [x.detach().float().requires_grad_(True) for x in (q, k, v)] + \
        [x.detach().clone().requires_grad_(True) for x in (a, i)] + \
        ([h0.detach().clone().requires_grad_(True)] if init else [])
    y, h = K4.ssd_scan_ref(*leaves[:5], chunk=chunk,
                           initial_state=leaves[5] if init else None)
    auto = torch.autograd.grad(
        [y, h], leaves, [dy.float(), dh if init else torch.zeros_like(h)])
    del y, h, leaves
    margins = {"plain": K4.bwd_margins(got, plain),
               "autograd": K4.bwd_margins(got, auto)}
    row = {**shape, "gates": gates, "initial_state": init, "dtype": dtype,
           "design": K4.BWD_DESIGNS[K4.bwd_design(v.dtype, dk, dv, chunk)],
           "max_abs_err": max(float((g.float() - w).abs().max())
                              for g, w in zip(got, plain)),
           "plain_absmax": {n: float(w.abs().max())
                            for n, w in zip(K4.BWD_NAMES, plain)},
           "margins": margins}
    if max(max(m.values()) for m in margins.values()) > 1:
        raise AssertionError(f"ssd_scan_bwd {row}: beyond the tolerance")
    del auto
    train_shape = shape is SSD_TRAIN
    if train_shape:
        faults = {}
        for fault in K4.BWD_FAULTS:
            fg = K4.ssd_scan_bwd_ref(q.float(), k.float(), v.float(), a, i,
                                     dy, dh, chunk=chunk, initial_state=h0,
                                     states=states, fault=fault)
            faults[fault] = max(K4.bwd_margins(fg, plain).values())
            check(faults[fault] > 1, f"K4 backward's tolerance passes a "
                  f"planted fault: {fault} {dtype} {gates}")
            del fg
        row["fault_margins"] = faults
    if train_shape and gates == "model":
        again = K4.ssd_scan_bwd(q, k, v, a, i, dy, dh, chunk=chunk,
                                initial_state=h0, states=states)
        row["bitwise_equal_rerun"] = all(torch.equal(x, y)
                                         for x, y in zip(got, again))
        check(row["bitwise_equal_rerun"], "two K4 backward launches differ")
        del again
        row["device_kernel"] = one_kernel(
            lambda: K4.ssd_scan_bwd(q, k, v, a, i, dy, dh, chunk=chunk,
                                    initial_state=h0, states=states),
            "ssd_chunk_scan_bwd")
        bw, f32_peak = peaks(name)
        row.update(K4.bwd_bound(B, S, H, dk, dv, chunk, v.element_size(), bw,
                                tensor_peak(name), f32_peak))
        row.update({
            "ms": time_ms(lambda: K4.ssd_scan_bwd(
                q, k, v, a, i, dy, dh, chunk=chunk, initial_state=h0,
                states=states)),
            "plain_ms": time_ms(lambda: K4.ssd_scan_bwd_ref(
                q, k, v, a, i, dy, dh, chunk=chunk, initial_state=h0,
                states=states)),
            "library_ms": None,
            "min_bytes": K4.bwd_hbm_bytes(B, S, H, dk, dv, chunk,
                                          v.element_size())["minimum"],
            "flops": K4.bwd_flops(B, S, H, dk, dv, chunk)})
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["share_of_f32_core_bound"] = row["f32_core_bound_ms"] / row["ms"]
    del q, k, v, a, i, h0, dy, dh, states, got, plain
    torch.cuda.empty_cache()
    return row


def phase_ssd_bwd_kernel(name):
    """K4's backward kernel against ssd_scan_bwd_ref and autograd on the
    card; returns the row at the training shape (bf16, the model's gates)
    for the kernels line."""
    from repro_torch.kernels import ssd_scan as K4
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [ssd_bwd_case(K4, name, shape, gates, init, dtype, gen)
             for dtype in ("float32", "bfloat16")
             for shape, gates, init in SSD_BWD_CASES]
    emit({"phase": "ssd_bwd_kernel", "atol_rel": K4.BWD_ATOL_REL,
          "rtol_bf16": K4.RTOL[torch.bfloat16],
          "tolerance": "|kernel - plain_f32| <= atol_rel * max|plain_f32| "
                       "+ rtol * |plain_f32| for each of dq, dk, dv, da, "
                       "di, dh0; rtol 0 in f32 and for da, di, dh0",
          "cases": cases})
    return next(c for c in cases if c["dtype"] == "bfloat16"
                and "ms" in c)


def _lm_grads(cfg, params, batch, remat):
    """One model's loss and every leaf's gradient (float32, on the CPU)."""
    from repro_torch.models import api
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, _ = api.lm_loss_fn(cfg, remat=remat, kv_chunk=512)(p, batch)
    g = torch.autograd.grad(loss, list(p.values()))
    return float(loss), {k: x.float().cpu() for k, x in zip(p, g)}


def phase_zamba_grad_parity():
    """zamba2-7b's loss and gradients on the card against the CPU, at full
    width cut to ZPARITY_CUTS, from the same weights, in f32 and bf16, with
    remat off and on: the loss and each leaf's gradient within ZGRAD_TOL;
    one K4 forward (two with remat in the super-layer, which backward
    recomputes; the tail layer is not checkpointed) and one K4 backward a
    Mamba2 layer a call, and no other kernel."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.datasets import synthetic_tokens
    from repro_torch.models import api, hybrid
    dev = torch.device("cuda")
    out = {"phase": "zamba_grad_parity", "arch": ZAMBA, "cuts": ZPARITY_CUTS,
           **ZGRAD, "tol": ZGRAD_TOL}
    for dtype in ("float32", "bfloat16"):
        cfg = get_config(ZAMBA).replace(dtype=dtype, **ZPARITY_CUTS)
        params = api.init(cfg, torch.Generator().manual_seed(3),
                          torch.device("cpu"))
        data = synthetic_tokens(1, ZGRAD["batch"], ZGRAD["seq"],
                                cfg.vocab_size, seed=ZGRAD["seed"])
        batch = {k: torch.from_numpy(v[0]) for k, v in data.items()}
        t0 = time.monotonic()
        cpu_loss, cpu_g = _lm_grads(cfg, params, batch, False)
        cpu_s = time.monotonic() - t0
        card_params = {k: v.to(dev) for k, v in params.items()}
        card_batch = {k: v.to(dev) for k, v in batch.items()}
        rec = {"cpu_s": cpu_s, "cpu_loss": cpu_loss}
        for remat in (False, True):
            reset_counts()
            loss, g = _lm_grads(cfg, card_params, card_batch, remat)
            counts = read_counts()
            # remat recomputes the super-layers; the tail layer is not
            # checkpointed, as in the reference
            k, n_super, n_tail = hybrid._split_layers(cfg)
            want = {name: 0 for name in counts}
            want["ssd_scan"] = k * n_super * (2 if remat else 1) + n_tail
            want["ssd_scan_bwd"] = cfg.num_layers
            _expect(f"zamba_grad_parity {dtype} remat={remat}", counts, want)
            rel = {k: float((g[k] - cpu_g[k]).abs().max()
                            / cpu_g[k].abs().max().clamp_min(1e-30))
                   for k in g}
            worst = max(rel, key=rel.get)
            r = {"loss": loss, "loss_err": abs(loss - cpu_loss),
                 "worst_leaf": worst, "worst_rel_err": rel[worst],
                 "gate_leaves_rel_err": {k: v for k, v in rel.items()
                                         if "A_log" in k or "dt_bias" in k},
                 "launches": counts}
            rec["remat" if remat else "plain"] = r
            tol = ZGRAD_TOL[dtype]
            check(r["loss_err"] <= tol["loss"] and rel[worst] <= tol["grad"]
                  and np.isfinite(loss), f"zamba_grad_parity {dtype}: {r}")
            del g
        out[dtype] = rec
        del params, card_params, cpu_g
        torch.cuda.empty_cache()
    emit(out)


def _release():
    """Free what finished protocols hold: a node and its tasks refer to each
    other, so their device memory waits for the cycle collector."""
    gc.collect()
    torch.cuda.empty_cache()


def _round_run(cfg, fresh, workers, async_mode, rounds, seed=0,
               kernels=("ssd_scan", "ssd_scan_bwd"), phase="zamba_round"):
    """``rounds`` rounds of SDFLBProtocol over ``cfg`` on the card, built as
    launch/train.py builds it (no chain): each round's wall, tokens/s, K4's
    forward and backward launches, scores; the peak memory; before (the
    same seeded init) and after, the held-out loss on the continuation of
    the first round's streams (``ZROUND``), which must fall, and the loss
    on ``fresh``, a batch of an unrelated seed. Each of ``kernels`` must
    launch every round and no other kernel at all."""
    from repro_torch.configs.base import FederationConfig, TrainConfig
    from repro_torch.core import async_sim
    from repro_torch.core.protocol import SDFLBProtocol
    from repro_torch.data.datasets import synthetic_tokens
    from repro_torch.models import api
    dev = torch.device("cuda")
    fed = FederationConfig(num_clusters=ZROUND["clusters"],
                           workers_per_cluster=workers // ZROUND["clusters"],
                           async_mode=async_mode, trust_threshold=0.3,
                           mode="allreduce")
    tc = TrainConfig(optimizer="adamw", lr=3e-4, remat=True, grad_clip=1.0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    proto = SDFLBProtocol(cfg, fed, tc, use_blockchain=False, seed=seed,
                          device=dev)
    B, S = ZROUND["batch"], ZROUND["seq"]
    # each round's streams at twice the length: the first half trains, the
    # second half of the first round's is the held-out set
    streams = [synthetic_tokens(workers, B, 2 * S, cfg.vocab_size,
                                seed=seed + r) for r in range(rounds)]
    heldout = {k: v[..., S:].reshape(workers * B, S)
               for k, v in streams[0].items()}
    before = (_heldout_loss(cfg, proto.global_params, heldout, dev),
              _heldout_loss(cfg, proto.global_params, fresh, dev))
    torch.cuda.empty_cache()
    scheduler = async_sim.AsyncScheduler(
        async_sim.heterogeneous_profiles(workers, seed=seed), seed=seed,
        buffer_size=max(2, workers // 2)) if async_mode else None
    tokens = workers * ZROUND["batch"] * ZROUND["seq"]
    rec = {"workers": workers, "round_wall_s": [], "tokens_per_s": [],
           "k4_launches": [], "k4_bwd_launches": [], "mean_loss": [],
           "mean_score": [], "participation": []}
    first = None
    for r in range(rounds):
        part = scheduler.next_aggregation()[1] if scheduler else None
        data = {k: np.ascontiguousarray(v[..., :S])
                for k, v in streams[r].items()}
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = proto.run_round(data, participation=part)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = read_counts()
        check(all(counts[k] >= 1 for k in kernels)
              and all(counts[k] == 0 for k in counts if k not in kernels),
              f"{phase}: launches {counts}")
        check(np.isfinite(out.scores).all() and np.isfinite(out.losses).all())
        rec["round_wall_s"].append(wall)
        rec["tokens_per_s"].append(tokens / wall)
        rec["k4_launches"].append(counts["ssd_scan"])
        rec["k4_bwd_launches"].append(counts["ssd_scan_bwd"])
        rec["mean_loss"].append(float(np.mean(out.losses)))
        rec["mean_score"].append(float(np.mean(out.scores)))
        rec["participation"].append(None if part is None else
                                    [int(x) for x in part])
        if r == 0:
            first = ({k: v.cpu() for k, v in proto.global_params.items()},
                     np.array(out.scores))
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    after = (_heldout_loss(cfg, proto.global_params, heldout, dev),
             _heldout_loss(cfg, proto.global_params, fresh, dev))
    rec["heldout_loss"] = [before[0], after[0]]
    rec["fresh_seed_loss"] = [before[1], after[1]]
    check(all(torch.isfinite(v).all() for v in proto.global_params.values()))
    check(after[0] < before[0], f"{phase}: held-out loss {before[0]} "
          f"-> {after[0]}")
    proto.finalize()
    return proto, rec, first


def phase_zamba_round(name):
    """zamba2-7b at full width (one super-layer) federated on the card:
    3 sync rounds at W = 4 and 3 async rounds, each run with a falling
    held-out loss (``_round_run``) and K4's forward and backward on
    every round; a same-seed
    one-round rerun with bitwise-equal global params and scores; one
    worker's backward under ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` flags no op. Returns the launches of the rounds."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.datasets import synthetic_tokens
    from repro_torch.models import api
    dev = torch.device("cuda")
    cfg = get_config(ZAMBA).replace(**ZROUND_CUTS)
    fresh = {k: v[0] for k, v in synthetic_tokens(
        1, ZROUND["batch"], ZROUND["seq"], cfg.vocab_size,
        seed=ZROUND_FRESH_SEED).items()}
    _release()
    held = torch.cuda.memory_allocated()
    free, total = torch.cuda.mem_get_info()
    out = {"phase": "zamba_round", "arch": ZAMBA, "cuts": ZROUND_CUTS,
           **ZROUND, "dtype": cfg.dtype, "chain": False,
           "d_model": cfg.d_model, "ssd_heads": cfg.d_model * cfg.ssm.expand
           // 64, "memory_held_at_start": held, "device_free_at_start": free}
    reset_counts()
    W = ZROUND["workers"]
    proto, out["sync"], (p1, s1) = _round_run(cfg, fresh, W, False,
                                                    ZROUND["rounds"])
    D = api.param_count(proto.global_params)
    out["D"] = D
    out["sync"]["bytes_per_param_per_worker"] = \
        (out["sync"]["max_memory_allocated"] - held) / (D * W)
    step = _worker_step(cfg, proto.global_params, {
        k: torch.from_numpy(v).to(dev) for k, v in fresh.items()})
    del proto
    flagged, cublas = _deterministic_probe(step)
    out["nondeterministic_ops_flagged"] = flagged
    out["cublas_notes"] = cublas
    check(not flagged, f"zamba_round: nondeterministic ops {flagged}")
    del step
    _release()
    # a same-seed rerun of the first round
    again, rerun, (p2, s2) = _round_run(cfg, fresh, W, False, 1)
    identical = all(torch.equal(p1[k], p2[k]) for k in p1) and \
        np.array_equal(s1, s2)
    check(identical, "zamba_round: same-seed rounds differ")
    out["rerun"] = {"identical_params_and_scores": identical,
                    "round_wall_s": rerun["round_wall_s"]}
    del again, p1, p2
    _release()
    # async: the largest W of 4 and 2 whose state leaves ZROUND_FREE free
    free, _ = torch.cuda.mem_get_info()
    need = {w: ZROUND_BYTES_PER_PARAM["async"] * D * w for w in (4, 2)}
    Wa = next((w for w in (4, 2) if need[w] <= free - ZROUND_FREE), 2)
    out["async_reckoning"] = {"bytes_needed": need, "device_free": free,
                              "workers": Wa}
    proto, out["async"], _ = _round_run(cfg, fresh, Wa, True,
                                              ZROUND["rounds"])
    out["async"]["bytes_per_param_per_worker"] = \
        (out["async"]["max_memory_allocated"] - held) / (D * Wa)
    del proto
    _release()
    launches = {k: 0 for k in counters()}
    launches["ssd_scan"] = sum(out["sync"]["k4_launches"]) + \
        sum(out["async"]["k4_launches"])
    launches["ssd_scan_bwd"] = sum(out["sync"]["k4_bwd_launches"]) + \
        sum(out["async"]["k4_bwd_launches"])
    out["launches"] = launches
    emit(out)
    return launches


def _settle_decisions(fed, rounds_scores, W):
    """Penalties of each round, stakes, balances and payouts when a fresh
    contract settles these scores."""
    from repro_torch.chain.contract import TrustContract
    from repro_torch.chain.ledger import Ledger
    c = TrustContract(Ledger(), requester_deposit=fed.requester_deposit,
                      worker_stake=fed.worker_stake,
                      penalty_pct=fed.penalty_pct,
                      trust_threshold=fed.trust_threshold,
                      top_k=fed.top_k_rewarded)
    c.join_batch(W)
    pens = [c.settle_round_batch(r, np.asarray(s, np.float64),
                                 timestamp=float(r + 1)).tolist()
            for r, s in enumerate(rounds_scores)]
    return {"penalties": pens, "stake": c.stake.tolist(),
            "balance": c.balance.tolist(),
            "payouts": c.finalize(timestamp=float(len(rounds_scores) + 1))}


def phase_llm_parity():
    """smollm-135m's smoke config (2 layers, d 288, V 512, bf16), W = 4
    (2 x 2), AdamW, 3 rounds through ``SDFLBProtocol`` on the card and on
    the CPU from the same seeded weights: sync and async, per-leaf and
    flat-pack. Scores within LLM_SCORE_TOL, losses within LLM_LOSS_TOL,
    params within two bf16 steps plus 8 lr, and the same decisions
    (penalties, stakes, balances, payouts; T splits the workers, and the
    margins are checked); K1 with K2 or K3 once a flat-pack round."""
    from repro_torch.configs.base import FederationConfig, TrainConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core.protocol import SDFLBProtocol
    from repro_torch.data.datasets import synthetic_tokens
    cfg = get_smoke_config(LLM)
    tc = TrainConfig(optimizer="adamw", lr=3e-4, grad_clip=1.0, remat=False)
    out = {"phase": "llm_parity", "arch": LLM, "W": 4, "rounds": 3,
           "score_tol": LLM_SCORE_TOL, "loss_tol": LLM_LOSS_TOL,
           "T": LLM_PARITY_T, "top_k": LLM_PARITY_TOPK}
    total = {k: 0 for k in counters()}
    for fused in (False, True):
        for async_mode in (False, True):
            fed = FederationConfig(
                num_clusters=2, workers_per_cluster=2,
                trust_threshold=LLM_PARITY_T,
                top_k_rewarded=LLM_PARITY_TOPK, async_mode=async_mode,
                fused_trust_path="on" if fused else "off")
            res = {}
            for dev in ("cuda", "cpu"):
                reset_counts()
                proto = SDFLBProtocol(cfg, fed, tc, seed=0, device=dev)
                recs = [proto.run_round(
                    synthetic_tokens(4, 2, 128, cfg.vocab_size, seed=r),
                    participation=(np.array(LLM_MASKS[r], np.int32)
                                   if async_mode else None))
                    for r in range(3)]
                proto.flush()
                res[dev] = (proto, recs, read_counts(),
                            {k: v.float().cpu()
                             for k, v in proto.global_params.items()},
                            proto.finalize())
            (_, g, counts, gp, gpay), (_, c, _, cp, cpay) = \
                res["cuda"], res["cpu"]
            n = 3 if fused else 0
            _expect("llm_parity", counts, _trust_launches(
                0 if async_mode else n, n if async_mode else 0))
            for k, v in counts.items():
                total[k] += v
            gs = np.stack([r.scores for r in g])
            cs = np.stack([r.scores for r in c])
            diff = {"scores": float(np.abs(gs - cs).max()),
                    "losses": float(max(np.abs(a.losses - b.losses).max()
                                        for a, b in zip(g, c))),
                    "params_over_bf16_steps": 0.0}
            for k in cp:
                d = (gp[k] - cp[k]).abs() - 2.0 ** -7 * cp[k].abs()
                diff["params_over_bf16_steps"] = max(
                    diff["params_over_bf16_steps"], float(d.max()))
            mean = np.sort(cs.mean(axis=0))[::-1]
            margins = {"T": float(np.abs(cs - LLM_PARITY_T).min()),
                       "top_k": float(mean[LLM_PARITY_TOPK - 1]
                                      - mean[LLM_PARITY_TOPK])}
            case = "_".join(("flat" if fused else "per_leaf",
                             "async" if async_mode else "sync"))
            check(diff["scores"] <= LLM_SCORE_TOL
                  and diff["losses"] <= LLM_LOSS_TOL
                  and diff["params_over_bf16_steps"] <= 8 * tc.lr,
                  f"llm_parity {case}: {diff}")
            check(min(margins.values()) > LLM_SCORE_TOL,
                  f"llm_parity {case}: margins {margins}")
            check((cs < LLM_PARITY_T).any() and (cs > LLM_PARITY_T).any())
            check(all(np.array_equal(a.penalties, b.penalties)
                      for a, b in zip(g, c)), f"{case}: penalties")
            check(gpay == cpay, f"{case}: payouts {gpay} vs {cpay}")
            out[case] = {**diff, "margins": margins,
                         "penalised": int((cs < LLM_PARITY_T).sum()),
                         "launches": counts}
            del res, g, c, gp, cp
            torch.cuda.empty_cache()
    emit(out)
    return total


def _heldout_loss(cfg, params, batch, dev):
    """The mean loss of one model (``params``) on a (B, S) batch."""
    from repro_torch.models import api
    with torch.no_grad():
        b = {k: torch.from_numpy(v).to(dev)[None] for k, v in batch.items()}
        return float(api.loss_fn(cfg)(api.stack(params), b)[0][0])


def _llm_run(extra, heldout):
    """One ``launch.train`` run (LLM_TRAIN + ``extra``): its records, the
    wall of each IPFS put of the global model (timed around
    ``IPFSStore.put_tree`` on the settler thread), the peak memory, and
    its held-out loss before (the same seeded init) and after, which must
    fall. Returns the protocol, the record and the block hashes."""
    import contextlib
    import io
    from repro_torch.chain.ipfs import IPFSStore
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train
    from repro_torch.models import api
    dev = torch.device("cuda")
    cfg = get_config(LLM)
    init = api.init(cfg, torch.Generator().manual_seed(0), dev)
    before = _heldout_loss(cfg, init, heldout, dev)
    del init
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    puts, put_tree = [], IPFSStore.put_tree

    def timed_put(self, *a, **kw):
        t = time.monotonic()
        out = put_tree(self, *a, **kw)
        puts.append(time.monotonic() - t)
        return out
    IPFSStore.put_tree = timed_put
    buf = io.StringIO()
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(buf):
            res = train.main(LLM_TRAIN + extra)
    finally:
        IPFSStore.put_tree = put_tree
    wall = time.monotonic() - t0
    proto = res["proto"]
    peak = torch.cuda.max_memory_allocated()
    after = _heldout_loss(cfg, proto.global_params, heldout, dev)
    recs = proto.history
    chain = proto.ledger is not None
    check(proto.node.device.type == "cuda" and len(recs) >= 1)
    check(all(r.settled and np.isfinite(r.scores).all()
              and np.isfinite(r.losses).all() for r in recs))
    check(not chain or (proto.ledger.verify_chain(deep=True)
                        and len(puts) == len(recs)))
    check(all(torch.isfinite(v).all() for v in proto.global_params.values()))
    tokens = proto.W * 32 * 128
    rec = {"chain": chain, "run_s": wall,
           "round_wall_s": res["round_wall_s"],
           "tokens_per_s": [tokens / w for w in res["round_wall_s"]],
           "settle_s": [r.settle_time for r in recs],
           "ipfs_put_s": puts,
           "max_memory_allocated": peak,
           "mean_loss": [float(r.losses.mean()) for r in recs],
           "mean_score": [float(r.scores.mean()) for r in recs],
           "heldout_loss": [before, after],
           "eval_lines": [json.loads(ln) for ln in buf.getvalue().splitlines()
                          if ln.startswith("{")]}
    check(after < before, f"llm_round: held-out loss {before} -> {after}")
    return proto, rec, [b.hash for b in proto.ledger.blocks] if chain \
        else []


def _capture_flat(fn, *args):
    """Run the round ``fn(*args)`` and keep the (W, D) pack that its
    flat-pack path hands to K1 (``trust.update_stats_flat``)."""
    from repro_torch.core import trust
    seen = []
    orig = trust.update_stats_flat

    def spy(upd, *rest):
        seen.append(upd)
        return orig(upd, *rest)
    trust.update_stats_flat = spy
    try:
        out = fn(*args)
    finally:
        trust.update_stats_flat = orig
    check(len(seen) == 1)
    return out, seen[0]


def _stats_check(upd, spec, losses):
    """K1 over the pack against its plain version (RTOL, the kernels
    phase's) and against the per-leaf statistics of the same updates
    (LLM_STATS_RTOL of the sums of |terms|)."""
    from repro_torch.core import trust
    from repro_torch.kernels import pack, trust_score
    flat = trust.update_stats_flat(upd, losses, losses)
    plain = trust_score.trust_score_ref(upd)
    leaf = trust.update_stats(pack.unpack_stack(upd, spec), losses, losses)
    c = plain[2].new_zeros(upd.shape[1])
    for w in range(upd.shape[0]):
        c += upd[w].float()
    c /= upd.shape[0]
    abs_dot = torch.stack([(upd[w].float() * c).abs().sum()
                           for w in range(upd.shape[0])])
    out = {"k1_vs_plain": max(float((a - b).abs().max()) / (RTOL * max(
        1.0, float(b.abs().max()))) for a, b in zip(flat[:3], plain))}
    scale = {"dot": abs_dot, "sq_u": leaf.sq_u, "sq_c": leaf.sq_c}
    for name in scale:
        a, b = getattr(flat, name), getattr(leaf, name)
        out[f"{name}_rel_to_abs_sum"] = float(
            ((a - b).abs() / scale[name]).max())
    check(out["k1_vs_plain"] <= 1, f"K1 vs plain at the LLM shape: {out}")
    check(max(v for k, v in out.items() if k.endswith("abs_sum"))
          <= LLM_STATS_RTOL, f"K1 vs per-leaf statistics: {out}")
    return out


def _kernel_row(name, fn, plain, args, nbytes, flops, bw, f32_peak,
                floor=1.0, checks=None):
    """One kernel at the LLM round's shape: error against its plain
    version, each output held to RTOL of its largest plain value (at least
    ``floor``), times and bound; ``checks(args, want, floor)`` adds its
    own fields."""
    got = fn(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = [float((g - e).abs().max()) for g, e in zip(got, want)]
    check(all(d <= RTOL * max(floor, float(e.abs().max()))
              for d, e in zip(errs, want)), f"{name} at the LLM shape: "
          f"{errs}")
    del got
    extra = checks(args, want, floor) if checks else {}
    del want
    t_bytes, t_ops = nbytes / bw * 1e3, flops / f32_peak * 1e3
    return {"max_abs_err": max(errs), "ms": time_ms(lambda: fn(*args)),
            "plain_ms": time_ms(lambda: plain(*args)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            **extra}


def _worker_step(cfg, params, batch):
    """One worker's loss and gradient at full size, as the round runs it
    (remat, ``tc.kv_chunk``)."""
    from repro_torch.models import api
    lm = api.lm_loss_fn(cfg, remat=True, kv_chunk=512)

    def step():
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss, _ = lm(p, batch)
        torch.autograd.grad(loss, list(p.values()))
        torch.cuda.synchronize()
    return step


def _deterministic_probe(step):
    """``step`` under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``: the ops of the LLM backward that PyTorch knows to be
    nondeterministic on CUDA warn. cuBLAS's note on its workspace (a
    concern across streams; the round runs on one) is kept apart."""
    import warnings
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step()
    finally:
        torch.use_deterministic_algorithms(False)
    msgs = sorted({str(w.message).split("\n")[0][:160] for w in caught
                   if "determinis" in str(w.message)})
    return ([m for m in msgs if "CuBLAS" not in m],
            [m for m in msgs if "CuBLAS" in m])


def _step_profile(step):
    """A warm ``step`` under torch.profiler: where its device time goes."""
    from torch.profiler import ProfilerActivity, profile
    step()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    t0 = time.monotonic()
    step()
    wall = time.monotonic() - t0
    prof.stop()
    return device_profile(prof, wall, ours=("gemm", "nvjet", "xmma"),
                          label="gemm_s")


def phase_llm_round(name):
    """smollm-135m at full size through ``launch/train.py --full``: 3 sync
    rounds with the chain and 3 async rounds without it, per-leaf (no
    trust kernel on that path): each round's wall, tokens/s, settle time,
    the IPFS puts of the global model, peak memory and the held-out loss;
    one sync and one async flat-pack round from the same state as a
    per-leaf one, each timed against the per-leaf round (the same scores
    within LLM_SCORE_TOL and decisions; K1 with K2 or K3 once each,
    checked against their plain versions and K1 against the per-leaf
    statistics at W = 8, D = 134,515,008); a same-seed one-round rerun
    seals the first run's first blocks; the deterministic-algorithms probe
    of the backward and one worker's step profiled."""
    import dataclasses as dc
    from repro_torch.configs.registry import get_config
    from repro_torch.core import async_agg, fl_step
    from repro_torch.data.datasets import synthetic_tokens
    from repro_torch.kernels import fused_round, pack, trust_agg, \
        trust_score
    from repro_torch.models import api
    dev = torch.device("cuda")
    cfg = get_config(LLM)
    bw, f32_peak = peaks(name)
    heldout = {k: v[0] for k, v in synthetic_tokens(
        8, 32, 128, cfg.vocab_size, seed=LLM_HELDOUT_SEED).items()}
    out = {"phase": "llm_round", "arch": LLM, "args": LLM_TRAIN,
           "async_args": LLM_ASYNC, "rerun_args": LLM_RERUN,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "dtype": cfg.dtype}
    reset_counts()
    proto, out["sync"], hashes = _llm_run([], heldout)
    out["sync"]["launches"] = read_counts()
    _expect("llm_round sync", out["sync"]["launches"], _trust_launches(0, 0))
    D = api.param_count(proto.global_params)
    out.update(W=proto.W, D=D, ipfs_model_bytes=sum(
        v.numel() * v.element_size() for v in proto.global_params.values()))

    # the flat-pack sync round from the state the per-leaf run reached
    task, fed = proto.task, proto.fed
    tc = task.tc
    batch = {k: torch.from_numpy(v).to(dev)[:, None] for k, v in
             synthetic_tokens(8, 32, 128, cfg.vocab_size, seed=3).items()}
    gp, opt = task.global_params, task.opt_state
    leaf_fn = fl_step.make_fl_round(cfg, dc.replace(fed,
                                                    fused_trust_path="off"),
                                    tc, device=dev)
    flat_fn = fl_step.make_fl_round(cfg, dc.replace(fed,
                                                    fused_trust_path="on"),
                                    tc, device=dev)
    spec = pack.pack_spec(gp)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.monotonic()
    leaf = leaf_fn(gp, opt, batch)
    leaf_scores, leaf_w = leaf.scores.cpu().numpy(), leaf.weights.cpu()
    leaf_s = time.monotonic() - t0
    del leaf
    t0 = time.monotonic()
    flat, upd = _capture_flat(flat_fn, gp, opt, batch)
    torch.cuda.synchronize()
    flat_s = time.monotonic() - t0
    flat_counts = read_counts()
    _expect("llm_round flat sync", flat_counts, _trust_launches(1, 0))
    flat_scores = flat.scores.cpu().numpy()
    sync_flat = {
        "leaf_round_s": leaf_s, "flat_round_s": flat_s,
        "round_max_memory_allocated": torch.cuda.max_memory_allocated(),
        "score_diff": float(np.abs(flat_scores - leaf_scores).max()),
        "weight_diff": float((flat.weights.cpu() - leaf_w).abs().max()),
        "decisions_equal": _settle_decisions(fed, [flat_scores], 8)
        == _settle_decisions(fed, [leaf_scores], 8),
        "stats": _stats_check(upd, spec, flat.losses)}
    check(sync_flat["score_diff"] <= LLM_SCORE_TOL
          and sync_flat["weight_diff"] <= LLM_SCORE_TOL
          and sync_flat["decisions_equal"], f"flat sync: {sync_flat}")
    K1 = trust_score.hbm_bytes(8, D, 2)["minimum"]
    w = flat.weights
    kernels = {"trust_score": _kernel_row(
        "trust_score", trust_score.trust_score_stats,
        trust_score.trust_score_ref, (upd,), K1, 5 * 8 * D + 2 * D, bw,
        f32_peak)}
    kernels["trust_agg"] = _kernel_row(
        "trust_agg", trust_agg.trust_agg, trust_agg.trust_agg_ref,
        (upd, w), trust_agg.hbm_bytes(8, D, 2)["minimum"], 2 * 8 * D, bw,
        f32_peak)
    del flat, upd, gp, opt, task
    proto = None
    torch.cuda.empty_cache()

    # async: per-leaf run, then a flat-pack round from its state
    reset_counts()
    proto, out["async"], _ = _llm_run(LLM_ASYNC, heldout)
    out["async"]["launches"] = read_counts()
    _expect("llm_round async", out["async"]["launches"],
            _trust_launches(0, 0))
    task, fed = proto.task, proto.fed
    gp, opt, st = task.global_params, task.opt_state, task.async_state
    part = torch.tensor(LLM_FLAT_MASK, dtype=torch.int32, device=dev)
    leaf_fn = fl_step.make_fl_round(cfg, dc.replace(fed,
                                                    fused_trust_path="off"),
                                    tc, device=dev)
    flat_fn = fl_step.make_fl_round(cfg, dc.replace(fed,
                                                    fused_trust_path="on"),
                                    tc, device=dev)
    flat_st = async_agg.AsyncState(st.staleness, pack.pack_stack(
        st.pending, spec, torch.float32))
    reset_counts()
    t0 = time.monotonic()
    leaf, leaf_new = leaf_fn(gp, opt, batch, None, part, st)
    leaf_scores = leaf.scores.cpu().numpy()
    leaf_s = time.monotonic() - t0
    leaf_pending = pack.pack_stack(leaf_new.pending, spec, torch.float32)
    del leaf, leaf_new, st
    task.async_state = None
    t0 = time.monotonic()
    (flat, flat_new), upd = _capture_flat(flat_fn, gp, opt, batch, None,
                                          part, flat_st)
    torch.cuda.synchronize()
    flat_s = time.monotonic() - t0
    counts = read_counts()
    _expect("llm_round flat async", counts, _trust_launches(0, 1))
    for k in counts:
        flat_counts[k] += counts[k]
    flat_scores = flat.scores.cpu().numpy()
    async_flat = {
        "leaf_round_s": leaf_s, "flat_round_s": flat_s,
        "score_diff": float(np.abs(flat_scores - leaf_scores).max()),
        "pending_diff": float((flat_new.pending - leaf_pending).abs().max()),
        "decisions_equal": _settle_decisions(fed, [flat_scores], 8)
        == _settle_decisions(fed, [leaf_scores], 8),
        "stats": _stats_check(upd, spec, flat.losses)}
    check(async_flat["score_diff"] <= LLM_SCORE_TOL
          and async_flat["decisions_equal"]
          and async_flat["pending_diff"] <= RTOL * max(1.0, float(
              leaf_pending.abs().max())), f"flat async: {async_flat}")
    keep = 1.0 - part.float()
    w = flat.weights
    del leaf_pending, flat, flat_new
    # K3's outputs here are sums of AdamW steps at lr 3e-4, far below 1
    # (``plain_max``): against a floor of 1, RTOL would let errors of a
    # large share of them through, so each is held to RTOL of its own
    # largest plain value
    kernels["fused_async_agg"] = _kernel_row(
        "fused_async_agg", fused_round.fused_async_agg,
        fused_round.fused_async_agg_ref, (upd, flat_st.pending, w, keep),
        fused_round.hbm_bytes(8, D, 2)["minimum"], 4 * 8 * D, bw, f32_peak,
        floor=0.0, checks=k3_checks)
    del upd, flat_st, gp, opt, task
    proto = None
    torch.cuda.empty_cache()
    out["flat_sync"], out["flat_async"] = sync_flat, async_flat
    out["kernels_at_llm_shape"] = kernels
    out["flat_launches"] = flat_counts

    # a same-seed rerun of the sync run's first round seals the same
    # genesis and round block (the finalize block's timestamp differs)
    again, rerun, again_hashes = _llm_run(LLM_RERUN, heldout)
    check(again_hashes[:2] == hashes[:2], "llm_round: same-seed runs "
          "sealed different blocks")
    out["rerun"] = {"identical_blocks": 2, "round_wall_s":
                    rerun["round_wall_s"], "settle_s": rerun["settle_s"],
                    "ipfs_put_s": rerun["ipfs_put_s"]}
    step = _worker_step(cfg, again.global_params, {
        k: torch.from_numpy(v).to(dev) for k, v in heldout.items()})
    flagged, cublas = _deterministic_probe(step)
    out["nondeterministic_ops_flagged"] = flagged
    out["cublas_notes"] = cublas
    check(not flagged, f"llm_round: nondeterministic ops {flagged}")
    out["worker_step_profile"] = _step_profile(step)
    del again, step
    torch.cuda.empty_cache()
    emit(out)
    return flat_counts


def phase_dense_serve(name):
    """smollm-135m and yi-6b: card against CPU at full width cut to 2
    layers (f32 and bf16), then at full size twice (bf16, seeded weights):
    the same tokens both times, prefill and decode times, peak memory.
    Both have ``window == 0``: decode takes the plain ``decode_attention``,
    and no kernel may launch."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import api
    bw, _ = peaks(name)
    out = {"phase": "dense_serve", "parity": DENSE_PARITY,
           "serve": DENSE_SERVE, "tol": PARITY_TOL}
    for arch in DENSE:
        rec = {}
        for dtype in ("float32", "bfloat16"):
            cfg = get_config(arch).replace(dtype=dtype, num_layers=2)
            params = api.init(cfg, torch.Generator().manual_seed(3),
                              torch.device("cpu"))
            t0 = time.monotonic()
            cpu = serve(cfg, device="cpu", params=params, **DENSE_PARITY)
            cpu_s = time.monotonic() - t0
            reset_counts()
            card = serve(cfg, device="cuda",
                         params={k: v.cuda() for k, v in params.items()},
                         **DENSE_PARITY)
            _expect(f"dense parity {arch}", read_counts(),
                    _trust_launches(0, 0))
            rec[dtype] = parity_record(cpu, card, dtype, DENSE_PARITY["gen"])
            rec[dtype]["cpu_serve_s"] = cpu_s
            del params, cpu, card
            torch.cuda.empty_cache()
        cfg = get_config(arch)
        B, P, G = DENSE_SERVE["batch"], DENSE_SERVE["prompt_len"], \
            DENSE_SERVE["gen"]
        dev = torch.device("cuda")
        params = api.init(cfg, torch.Generator(dev).manual_seed(0), dev)
        n_params = api.param_count(params)
        weight_bytes = sum(v.numel() * v.element_size()
                           for v in params.values())
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        r = serve(cfg, seed=0, **DENSE_SERVE)
        peak = torch.cuda.max_memory_allocated()
        _expect(f"dense serve {arch}", read_counts(), _trust_launches(0, 0))
        check(r.tokens.shape == (B, G) and torch.isfinite(r.logits).all())
        check(torch.equal(r.tokens, r.logits.float().argmax(-1)))
        again = serve(cfg, seed=0, **DENSE_SERVE)
        check(torch.equal(again.tokens, r.tokens),
              f"{arch}: same-seed serve runs emitted different tokens")
        rec["full"] = {
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "params": n_params, "weight_bytes": weight_bytes,
            "prefill_ms": r.prefill_s * 1e3,
            "prefill_tok_s": B * P / r.prefill_s,
            "decode_ms_per_step": r.decode_s * 1e3 / (G - 1),
            "decode_tok_s": B * (G - 1) / r.decode_s,
            "rerun_prefill_ms": again.prefill_s * 1e3,
            "rerun_decode_ms_per_step": again.decode_s * 1e3 / (G - 1),
            "weight_stream_bound_ms_per_step": weight_bytes / bw * 1e3,
            "max_memory_allocated": peak, "identical_tokens": True,
            "sample_tokens": r.tokens[0, :16].tolist()}
        out[arch] = rec
        del r, again
        torch.cuda.empty_cache()
    emit(out)


# MoE: qwen2-moe-a2.7b (60 routed experts top-4, d_ff 1408, 4 shared
# experts, V 151,936) and olmoe-1b-7b (64 experts top-8, d_ff 1024, V
# 50,304), both d 2048. moe_parity cuts both to 2 layers at full width as
# dense_serve does and holds one MoE layer at qwen2's full width to its CPU
# result: 2 rows of 256 tokens whose last 128 positions repeat the row's
# first token, so equal routing weights meet at the capacity boundary and
# tokens drop. Tolerances of that layer against the CPU, of each tensor's
# largest value: f32 products in other orders; in bf16 half a bf16 step for
# each of the top_k + 2 terms a token's gradient adds after rounding each
# to bf16 (its k experts', the shared experts' and the router's), 0.0117
# for qwen2 (measured 0.00763 on x's gradient, NVIDIA H100 80GB HBM3 at
# 700.00 W; PERF.md section 6).
MOE = ("qwen2-moe-a2.7b", "olmoe-1b-7b")
MOE_LAYER = dict(batch=2, seq=256, tied_from=128, seed=7)
MOE_LAYER_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -9}   # bf16: a term
# moe_round: olmoe-1b-7b at full width cut to one layer (D = 625,612,800),
# bf16, through SDFLBProtocol as launch/train.py --full builds it, at
# ZROUND's shape (W = 4 in 2 clusters, batch 4, seq 512; 3 sync rounds, 3
# async at the W the async state leaves room for), no chain; no kernel on
# this path (the mixed bf16/f32 tree takes the per-leaf trust statistics).
# Then the MoE layer at the round's shape (B 4, S 512), its forward and
# backward three times without the deterministic flag: the same bits.
MOE_ROUND_ARCH = "olmoe-1b-7b"
MOE_ROUND_CUTS = {"num_layers": 1}
MOE_RERUNS = 3


def _moe_fwd_bwd(moe_cfg, lp, x, dout):
    """One MoE layer's (gather path) output, aux loss and the gradients of
    sum(out · dout) + aux with respect to x and every param."""
    from repro_torch.models import moe
    lp = {k: v.detach().clone().requires_grad_(True) for k, v in lp.items()}
    x = x.detach().clone().requires_grad_(True)
    out, aux = moe.apply_moe(lp, x, moe_cfg)
    grads = torch.autograd.grad((out.float() * dout).sum() + aux,
                                [x, *lp.values()])
    return [out.detach(), aux.detach(), *grads]


def _moe_plan(moe_cfg, router, x):
    """The capacity plan (``moe._routes``) of x's tokens, on the CPU."""
    from repro_torch.models import moe
    xf = x.reshape(-1, x.shape[-1])
    probs, _ = moe._router_probs({"router": router}, xf, moe_cfg)
    w, idx = moe._topk_weights(probs, moe_cfg.top_k)
    C = moe.capacity(moe_cfg, xf.shape[0], moe_cfg.capacity_factor)
    return [t.cpu() for t in moe._routes(w, idx, C)]


class _RoutePlans:
    """While entered, records each MoE layer call's routes: every token's
    experts and which of them kept the token (``moe._routes``), on the
    CPU."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig, self.plans = moe, moe._routes, []

        def spy(*args, **kwargs):
            out = self.orig(*args, **kwargs)
            self.plans.append((out[1].cpu(), out[3].cpu()))
            return out
        moe._routes = spy
        return self

    def __exit__(self, *exc):
        self.moe._routes = self.orig


def _plans_differ(a, b):
    """Of two runs' routes, call by call: the (token, j) routes that go to
    another expert or are kept in one run and dropped in the other."""
    routes = sum(int(((ea != eb) | (ka != kb)).sum())
                 for (ea, ka), (eb, kb) in zip(a, b))
    return {"calls": len(a), "routes": routes,
            "routes_total": sum(k.numel() for _, k in a)}


def _steps_gap(a, b):
    """Max |logits a - logits b| over the steps up to and including the
    first at which the two runs' greedy tokens part."""
    same = (a.tokens.cpu() == b.tokens.cpu()).all(dim=0)
    upto = int(same.float().argmin()) if not same.all() else same.numel()
    return float((a.logits.float().cpu() - b.logits.float().cpu())
                 [:, :upto + 1].abs().max())


def phase_moe_parity():
    """qwen2-moe-a2.7b and olmoe-1b-7b at full width cut to 2 layers:
    ``serve`` on the card against the CPU (f32 and bf16, DENSE_PARITY),
    no kernel launch, each MoE call's capacity plan compared; then one MoE
    layer at qwen2's full width with tied tokens and capacity drops,
    forward and backward, against the CPU: the same capacity plan,
    outputs and gradients within MOE_LAYER_TOL's bounds. Every number is
    emitted before the checks fail the phase.

    A bf16 rounding can flip a routing choice (a near tie among a token's
    top-k experts, or at an expert's capacity), and a flipped token moves
    the logits by far more than a rounding. Where the card's plans differ
    from the CPU's, bf16 logits are held within PARITY_TOL plus what bf16
    alone moves the CPU's (the same weights in f32), as the CPU tests
    hold bf16 gradients to the reference."""
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import api, moe
    cpu_dev, dev = torch.device("cpu"), torch.device("cuda")
    out = {"phase": "moe_parity", "parity": DENSE_PARITY,
           "tol": PARITY_TOL, "layer": MOE_LAYER,
           "layer_tol": MOE_LAYER_TOL}
    failures = []
    for arch in MOE:
        rec = {}
        cfg32 = get_config(arch).replace(dtype="float32", num_layers=2)
        t0 = time.monotonic()
        p32 = api.init(cfg32, torch.Generator().manual_seed(3), cpu_dev)
        rec["cpu_init_s"] = time.monotonic() - t0
        # a bf16 init is the f32 one rounded (dense_init draws in f32), the
        # router and shared gate kept in f32: the smoke config's dtypes
        dts = {k: v.dtype for k, v in api.init(
            get_smoke_config(arch), torch.Generator().manual_seed(0),
            cpu_dev).items()}
        cpu32 = None
        for dtype in ("float32", "bfloat16"):
            cfg = cfg32.replace(dtype=dtype)
            params = p32 if dtype == "float32" else \
                {k: v.to(dts[k]) for k, v in p32.items()}
            t0 = time.monotonic()
            with _RoutePlans() as cpu_plans:
                cpu = serve(cfg, device="cpu", params=params, **DENSE_PARITY)
            cpu_s = time.monotonic() - t0
            reset_counts()
            with _RoutePlans() as card_plans:
                card = serve(cfg, device="cuda",
                             params={k: v.cuda() for k, v in params.items()},
                             **DENSE_PARITY)
            _expect(f"moe parity {arch}", read_counts(),
                    _trust_launches(0, 0))
            differ = _plans_differ(cpu_plans.plans, card_plans.plans)
            tol, gap = PARITY_TOL[dtype], None
            if dtype == "bfloat16" and differ["routes"]:
                gap = _steps_gap(cpu, cpu32)
                tol += gap
            try:
                r = parity_record(cpu, card, dtype, DENSE_PARITY["gen"],
                                  tol=tol)
            except AssertionError as e:
                failures.append(f"{arch} {dtype}: {e}")
                r = {"failed": str(e)[:500]}
            rec[dtype] = {**r, "plans_differ": differ, "tol": tol,
                          "cpu_bf16_vs_f32_gap": gap, "cpu_serve_s": cpu_s}
            if dtype == "float32":
                cpu32 = cpu
            del params, card
            torch.cuda.empty_cache()
        out[arch] = rec
        del p32, cpu, cpu32
    lcfg = get_config(MOE[0]).moe
    B, S, tied = MOE_LAYER["batch"], MOE_LAYER["seq"], MOE_LAYER["tied_from"]
    layer_tol = {"float32": MOE_LAYER_TOL["float32"],
                 "bfloat16": MOE_LAYER_TOL["bfloat16"] * (lcfg.top_k + 2)}
    out["layer_tol"] = layer_tol
    layer = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        gen = torch.Generator().manual_seed(MOE_LAYER["seed"])
        lp = moe.init_moe(gen, 2048, lcfg, dt, cpu_dev)
        x = torch.randn((B, S, 2048), generator=gen).to(dt)
        x[:, tied:] = x[:, :1]
        dout = torch.randn((B, S, 2048), generator=gen)
        plans = [_moe_plan(lcfg, lp["router"].to(d), x.to(d))
                 for d in (dev, cpu_dev)]
        same_plan = all(torch.equal(a, b) for a, b in zip(*plans))
        kept = plans[1][3]
        reset_counts()
        got = _moe_fwd_bwd(lcfg, {k: v.cuda() for k, v in lp.items()},
                           x.cuda(), dout.cuda())
        torch.cuda.synchronize()
        _expect("moe parity layer", read_counts(), _trust_launches(0, 0))
        want = _moe_fwd_bwd(lcfg, lp, x, dout)
        names = ["out", "aux", "x", *lp]
        rel = {n: float((a.cpu().float() - b.float()).abs().max()
                        / b.float().abs().max().clamp_min(1e-30))
               for n, a, b in zip(names, got, want)}
        layer[dtype] = {"capacity": int(moe.capacity(lcfg, B * S,
                                                     lcfg.capacity_factor)),
                        "dropped_routes": int((~kept).sum()),
                        "routes": int(kept.numel()), "same_plan": same_plan,
                        "finite": all(bool(torch.isfinite(a).all())
                                      for a in got),
                        "rel_err": rel}
        if not (same_plan and not kept.all() and layer[dtype]["finite"]
                and max(rel.values()) <= layer_tol[dtype]):
            failures.append(f"layer {dtype}: {layer[dtype]}")
        del lp, got, want
    out["layer"] = {**MOE_LAYER, **layer}
    torch.cuda.empty_cache()
    emit(out)
    check(not failures, f"moe_parity: {failures}")


def phase_moe_serve(name):
    """qwen2-moe-a2.7b and olmoe-1b-7b at full size (bf16, seeded weights)
    serving DENSE_SERVE twice: the same tokens both times, prefill and
    decode times, peak memory; the gather path runs every expert at C >= 1,
    so a decode step reads every weight (the floor: the weights' bytes over
    the card's memory rate). No kernel may launch (window 0)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import api, moe
    bw, _ = peaks(name)
    out = {"phase": "moe_serve", "serve": DENSE_SERVE, "hbm_bytes_s": bw}
    B, P, G = DENSE_SERVE["batch"], DENSE_SERVE["prompt_len"], \
        DENSE_SERVE["gen"]
    dev = torch.device("cuda")
    for arch in MOE:
        cfg = get_config(arch)
        params = api.init(cfg, torch.Generator(dev).manual_seed(0), dev)
        n_params = api.param_count(params)
        weight_bytes = sum(v.numel() * v.element_size()
                           for v in params.values())
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_counts()
        r = serve(cfg, seed=0, **DENSE_SERVE)
        peak = torch.cuda.max_memory_allocated()
        _expect(f"moe serve {arch}", read_counts(), _trust_launches(0, 0))
        check(r.tokens.shape == (B, G) and torch.isfinite(r.logits).all())
        check(torch.equal(r.tokens, r.logits.float().argmax(-1)))
        again = serve(cfg, seed=0, **DENSE_SERVE)
        check(torch.equal(again.tokens, r.tokens),
              f"{arch}: same-seed serve runs emitted different tokens")
        floor_ms = weight_bytes / bw * 1e3
        out[arch] = {
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
            "params": n_params, "weight_bytes": weight_bytes,
            "prefill_capacity": moe.capacity(cfg.moe, B * P,
                                              cfg.moe.capacity_factor),
            "decode_capacity": moe.capacity(cfg.moe, B,
                                            2 * cfg.moe.capacity_factor),
            "prefill_ms": r.prefill_s * 1e3,
            "prefill_tok_s": B * P / r.prefill_s,
            "decode_ms_per_step": r.decode_s * 1e3 / (G - 1),
            "decode_tok_s": B * (G - 1) / r.decode_s,
            "rerun_prefill_ms": again.prefill_s * 1e3,
            "rerun_decode_ms_per_step": again.decode_s * 1e3 / (G - 1),
            "weight_stream_bound_ms_per_step": floor_ms,
            "decode_over_floor": r.decode_s * 1e3 / (G - 1) / floor_ms,
            "memory_held_at_start": held,
            "max_memory_allocated": peak, "identical_tokens": True,
            "sample_tokens": r.tokens[0, :16].tolist()}
        del r, again
        torch.cuda.empty_cache()
    emit(out)


def phase_moe_round(name):
    """olmoe-1b-7b at full width cut to one layer federated on the card:
    3 sync rounds at W = 4 and 3 async rounds, each with a falling
    held-out loss (``_round_run``) and no kernel launch; the MoE layer's
    forward and backward at the round's shape three times without the
    deterministic flag, bitwise equal; a same-seed one-round rerun with
    bitwise-equal global params and scores."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.datasets import synthetic_tokens
    from repro_torch.models import api
    dev = torch.device("cuda")
    cfg = get_config(MOE_ROUND_ARCH).replace(**MOE_ROUND_CUTS)
    fresh = {k: v[0] for k, v in synthetic_tokens(
        1, ZROUND["batch"], ZROUND["seq"], cfg.vocab_size,
        seed=ZROUND_FRESH_SEED).items()}
    _release()
    held = torch.cuda.memory_allocated()
    free, _ = torch.cuda.mem_get_info()
    out = {"phase": "moe_round", "arch": MOE_ROUND_ARCH,
           "cuts": MOE_ROUND_CUTS, **ZROUND, "dtype": cfg.dtype,
           "chain": False, "experts": cfg.moe.num_experts,
           "top_k": cfg.moe.top_k, "memory_held_at_start": held,
           "device_free_at_start": free}
    W = ZROUND["workers"]
    proto, out["sync"], (p1, s1) = _round_run(
        cfg, fresh, W, False, ZROUND["rounds"], kernels=(),
        phase="moe_round")
    D = api.param_count(proto.global_params)
    out["D"] = D
    out["sync"]["bytes_per_param_per_worker"] = \
        (out["sync"]["max_memory_allocated"] - held) / (D * W)
    # the MoE layer at the round's shape, from the trained params: the
    # last quarter of every row is one token (ties and drops)
    check(not torch.are_deterministic_algorithms_enabled())
    pre = "layers.moe."
    lp = {k[len(pre):]: v[0] for k, v in proto.global_params.items()
          if k.startswith(pre)}
    del proto
    _release()
    B, S = ZROUND["batch"], ZROUND["seq"]
    gen = torch.Generator(dev).manual_seed(11)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev
                    ).to(torch.bfloat16)
    x[:, 3 * S // 4:] = x[:1, :1]
    dout = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    plan = _moe_plan(cfg.moe, lp["router"], x)
    runs, walls = [], []
    for _ in range(MOE_RERUNS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        runs.append(_moe_fwd_bwd(cfg.moe, lp, x, dout))
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    same = all(torch.equal(a, b) for again in runs[1:]
               for a, b in zip(runs[0], again))
    out["layer_reruns"] = {
        "runs": MOE_RERUNS, "bitwise_equal": same, "wall_s": walls,
        "dropped_routes": int((~plan[3]).sum()), "routes": plan[3].numel(),
        "deterministic_algorithms": False}
    check(same, "moe_round: the MoE layer's reruns differ")
    check(not plan[3].all(), "moe_round: the layer's input drops nothing")
    del runs, lp, x, dout
    _release()
    # a same-seed rerun of the first round
    again, rerun, (p2, s2) = _round_run(cfg, fresh, W, False, 1, kernels=(),
                                        phase="moe_round")
    identical = all(torch.equal(p1[k], p2[k]) for k in p1) and \
        np.array_equal(s1, s2)
    check(identical, "moe_round: same-seed rounds differ")
    out["rerun"] = {"identical_params_and_scores": identical,
                    "round_wall_s": rerun["round_wall_s"]}
    del again, p1, p2
    _release()
    free, _ = torch.cuda.mem_get_info()
    need = {w: ZROUND_BYTES_PER_PARAM["async"] * D * w for w in (4, 2)}
    Wa = next((w for w in (4, 2) if need[w] <= free - ZROUND_FREE), 2)
    out["async_reckoning"] = {"bytes_needed": need, "device_free": free,
                              "workers": Wa}
    proto, out["async"], _ = _round_run(cfg, fresh, Wa, True,
                                        ZROUND["rounds"], kernels=(),
                                        phase="moe_round")
    out["async"]["bytes_per_param_per_worker"] = \
        (out["async"]["max_memory_allocated"] - held) / (D * Wa)
    del proto
    _release()
    emit(out)


def _timed(walls, phase, fn, *args):
    """``fn(*args)``, its wall seconds kept in ``walls[phase]``."""
    t0 = time.monotonic()
    try:
        return fn(*args)
    finally:
        walls[phase] = time.monotonic() - t0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's path needs one",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  fails where the checkout lacks src/
    t_start = time.monotonic()
    walls = {}

    def run(phase, fn, *args):
        return _timed(walls, phase, fn, *args)
    name, smi_line = run("device", phase_device)
    run("build", phase_build)
    table = run("kernels", phase_kernels, name)
    run("parity", phase_parity)
    launches = {k: 0 for k in counters()}
    sync_counts, sync_hashes = run("protocol_sync", main_path,
                                   "protocol_sync", False)
    async_counts, _ = run("protocol_async", main_path, "protocol_async",
                          True)
    for c in (sync_counts, async_counts):
        for k, n in c.items():
            launches[k] += n
    run("cohort", phase_cohort)
    run("profile", phase_profile)

    def determinism():
        reset_counts()
        _, again = run_protocol("determinism", async_mode=False)
        if again != sync_hashes:
            raise AssertionError("same-seed runs sealed different blocks")
        emit({"phase": "determinism", "blocks": len(again),
              "identical": True, "head": again[-1]})
    run("determinism", determinism)
    swa_row = run("swa_kernel", phase_swa_kernel, name)
    run("serve_parity", phase_serve_parity)
    serve_counts = run("serve", phase_serve, name)
    ssd_row = run("ssd_kernel", phase_ssd_kernel, name)
    run("zamba_parity", phase_zamba_parity)
    zamba_counts = run("zamba_serve", phase_zamba_serve, name)
    ssd_bwd_row = run("ssd_bwd_kernel", phase_ssd_bwd_kernel, name)
    run("zamba_grad_parity", phase_zamba_grad_parity)
    round_counts = run("zamba_round", phase_zamba_round, name)
    new_paths = [run("multi_task", phase_multi_task),
                 run("multi_task_parity", phase_multi_task_parity)]
    events_counts, events_task = run("events", phase_events)
    new_paths += [events_counts,
                  run("read_path", phase_read_path, events_task)]
    del events_task
    new_paths += [run("network", phase_network),
                  run("examples", phase_examples)]
    run("f4", phase_f4)
    new_paths += [run("llm_parity", phase_llm_parity),
                  run("llm_round", phase_llm_round, name)]
    run("dense_serve", phase_dense_serve, name)
    run("moe_parity", phase_moe_parity)
    run("moe_serve", phase_moe_serve, name)
    run("moe_round", phase_moe_round, name)
    for counts in new_paths:
        for k in ("trust_score", "trust_agg", "fused_async_agg"):
            launches[k] += counts[k]

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
    if round_counts["ssd_scan_bwd"] < 1:
        raise AssertionError("ssd_scan_bwd never launched on the zamba2 "
                             "round path")
    summary.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:29",
        "launches": zamba_counts["ssd_scan"] + round_counts["ssd_scan"],
        "max_abs_err": ssd_row["max_abs_err"], "ms": ssd_row["ms"],
        "plain_ms": ssd_row["plain_ms"], "bound_ms": ssd_row["bound_ms"],
        "bound_by": ssd_row["bound_by"], "library_ms": ssd_row["library_ms"],
        "shape": {k: ssd_row[k] for k in ("B", "S", "H", "dk", "dv", "chunk",
                                           "gates", "dtype")}})
    # K4's backward: no TPU kernel; the reference takes the VJP of its jnp
    # scan under autodiff
    summary.append({
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/models/ssm.py:45",
        "launches": round_counts["ssd_scan_bwd"],
        "max_abs_err": ssd_bwd_row["max_abs_err"], "ms": ssd_bwd_row["ms"],
        "plain_ms": ssd_bwd_row["plain_ms"],
        "bound_ms": ssd_bwd_row["bound_ms"],
        "bound_by": ssd_bwd_row["bound_by"],
        "library_ms": ssd_bwd_row["library_ms"],
        "shape": {k: ssd_bwd_row[k] for k in ("B", "S", "H", "dk", "dv",
                                               "chunk", "gates", "dtype")}})
    emit({"phase": "total", "wall_s": time.monotonic() - t_start,
          "phase_wall_s": walls})
    print(smi_line, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
