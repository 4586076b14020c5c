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
                  torch.profiler: device time by kernel, device busy share;
                  a round whose profile lost K1's or K2's device record
                  runs again under a fresh profiler, up to 5 runs
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
                  cores) and the bound on the ordinary f32 cores. Then K4's
                  wide path (f32, on the tensor cores): xlstm-1.3b's
                  prefill shape (B 4, S 1024, H 4, dk 1024, dv 1025, chunk
                  256, per-head q and k, v's last column ones) with
                  mLSTM's gates (forget bias 3, input gate up to e^10) and
                  gentle ones, the smoke config's (dk 128, dv 129, chunk
                  64), an initial state, sizes off the kernels' tiles; the
                  five planted faults must fail at the serve and smoke
                  shapes; two calls bitwise equal, 4 calls 4 x
                  ``WIDE_LAUNCHES`` kernel launches; the serve's
                  bf16-valued q, k, v within the tolerance too; times on
                  those (and on f32 values) beside ``ssd_scan.bound`` with
                  q and k per head
  zamba_parity    ``launch.serve.serve`` on the card against the same on the
                  CPU: zamba2-7b at full width cut to 3 layers (one
                  super-layer of 2 Mamba2 layers and the shared block, one
                  tail layer), batch 2, a 256-token prompt, 4 greedy tokens,
                  f32 and bf16; K4 must launch 3 times, no other kernel
  zamba_serve     the third main path: zamba2-7b at full width cut to 15
                  of its 81 layers (2 super-layers and the 3 tail layers;
                  seeded random weights, bf16) serving batch 4, a
                  4096-token prompt and 32 tokens; K4 must launch 15 times
                  and no other kernel; a second same-seed run must emit the
                  same tokens; then one prefill and four decode steps under
                  torch.profiler. The cut keeps every check; the full
                  depth's times are in PERF.md section 5
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
                  under deterministic algorithms flags no op; a warm
                  worker step under torch.profiler (device activity: the
                  busy share and K4's time, reported)
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
                  remat; 1 sync per-leaf round with the chain (round
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
                  times and bounds); a same-seed one-round rerun without
                  the chain must reach the sync round's global params and
                  scores bit for bit (what its block records: the scores
                  and the cid of the params); one worker's backward
                  under ``torch.use_deterministic_algorithms(warn_only=
                  True)`` may flag no op; one worker's step profiled
  dense_serve     smollm-135m and yi-6b: card against CPU at full width
                  cut to 2 layers (f32 and bf16; batch 2, prompt 160, 4
                  tokens), then at full size (bf16, batch 4, prompt 1024,
                  32 tokens) twice with the same tokens; no kernel (both
                  have window 0); starts with earlier phases' garbage
                  collected
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
                  floor (every expert runs at C >= 1); no kernel; starts
                  with earlier phases' garbage collected
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
  xlstm_parity    ``launch.serve.serve`` on the card against the CPU:
                  xlstm-1.3b at full width cut to one super-layer (7
                  mLSTM blocks and the sLSTM block), batch 2, a 512-token
                  prompt (two chunks), 4 greedy tokens, f32 and bf16 (bf16
                  within PARITY_TOL plus the CPU's own bf16-vs-f32 gap);
                  K4 must launch 7 times (its wide path), no other kernel
  xlstm_serve     the fourth serve path: xlstm-1.3b at full width cut to
                  8 of its 48 layers (one super-layer; seeded random
                  weights, bf16) serving batch 4, a 1024-token prompt and
                  32 tokens; K4 must launch 7 times and no other kernel; a
                  second same-seed run must emit the same tokens; prefill
                  ms, decode ms a step against the floor (weights read and
                  mLSTM states read and written once a step), peak memory;
                  then one prefill and four decode steps under
                  torch.profiler. The cut keeps every check; the full
                  depth's times are in PERF.md section 5
  ssd_wide_bwd_kernel  K4's wide backward (``ssd_scan_bwd`` at mLSTM's
                  heads, ``csrc/ssd_scan_wide_bwd.cu``) against the plain
                  backward and against autograd through the plain forward,
                  on the f32 states the wide forward wrote (held to the
                  forward's check of the plain states): xlstm-1.3b's
                  training shape (B 4, S 512, H 4, dk 1024, dv 1025, chunk
                  256) with mLSTM's and gentle gates, the smoke config's
                  from an initial state with a nonzero dh_final, sizes off
                  the tiles; each of ``ssd_scan.BWD_FAULTS`` must fail by
                  a margin > 1 at the training and smoke shapes; two calls
                  bitwise equal and 4 calls 4 x ``WIDE_BWD_LAUNCHES``
                  kernel launches; times beside ``ssd_scan.bwd_bound`` (q
                  and k per head), the plain backward's, and the wide
                  forward's with and without its states
  xlstm_grad_parity  xlstm-1.3b at full width cut to one super-layer: the
                  loss on the card against the CPU's from the same
                  weights, and every leaf's gradient, each block's output
                  and the gradient it hands back against the CPU's block
                  by block on the card's own trajectory, f32 and bf16,
                  batch 1, seq 512 (two chunks), remat off and on; K4's
                  wide forward once an mLSTM block (twice with remat) and
                  its wide backward once, no other kernel.
                  ``--xlstm-grad-control p_one_part`` runs this phase alone
                  with K4 replaced by its plain version rounding the gated
                  scores to one bf16 part, which it must reject
  xlstm_round     xlstm-1.3b at full width cut to one super-layer (D =
                  508,960,796) through ``SDFLBProtocol`` as
                  ``launch/train.py`` builds it (AdamW, remat, no chain),
                  as ``zamba_round`` but 1 round a run: 1 sync round at
                  W = 4 (batch 4, seq 512) and 1 async round, the held-out
                  loss falling, only
                  K4's wide forward and wide backward launching, a bitwise
                  same-seed rerun, the deterministic-algorithms probe, a
                  profiled worker step
  mla_serve       minicpm3-4b (Multi-head Latent Attention): card against
                  CPU at full width cut to 2 layers (f32 and bf16; batch 2,
                  prompt 160, 4 greedy tokens: prefill logits, the
                  absorbed decode's logits and tokens within PARITY_TOL),
                  and the loss and every leaf's gradient at batch 1, seq
                  256 within ZGRAD_TOL; then at full size (62 layers,
                  bf16) serving batch 4, a 2048-token prompt (two KV
                  chunks: the chunked online softmax) and 32 tokens twice
                  with the same tokens: prefill ms, decode ms a step
                  against the floor (weights and the latent cache read
                  once a step), the latent cache's bytes a token against
                  expanded K/V, peak memory, four decode steps under
                  torch.profiler; no kernel launches
  mla_round       minicpm3-4b at full width cut to 2 layers (D =
                  501,406,208) as ``zamba_round`` with no kernel: 3 sync
                  rounds at W = 4, async rounds at the W the memory
                  reckoning allows, the held-out loss falling, a bitwise
                  same-seed rerun, the deterministic-algorithms probe, a
                  profiled worker step
  whisper_serve   whisper-base (the encoder-decoder, 1500 frames of the
                  stub frontend): card against CPU at full size (f32 and
                  bf16; batch 2, prompt 64, 4 greedy tokens within
                  PARITY_TOL) and the loss and every leaf's gradient
                  (batch 1, 64 tokens) within ZGRAD_TOL; then serving batch
                  4, a 64-token prompt and 64 tokens twice with the same
                  tokens: prefill ms, decode ms a step against the floor
                  (the decoder's weights, the tied head and the self and
                  cross caches read once a step), peak memory; no kernel
  whisper_round   whisper-base at full size (D = 71,426,560) through
                  ``SDFLBProtocol`` (AdamW, remat, no chain), 1500 frames a
                  sample from a seeded numpy generator: 3 sync rounds at W
                  = 8 (2 clusters, batch 4, 256 tokens) and 3 async, the
                  held-out loss falling, no kernel, a bitwise same-seed
                  rerun, the deterministic-algorithms probe, a profiled
                  worker step
  vlm_serve       chameleon-34b (the VLM family: 256 patch embeddings of
                  the stub VQ frontend before the text): starts with at
                  most 1 GB allocated; card against CPU at full width cut
                  to one layer (f32 and bf16; batch 2, the 256 patches and
                  a 64-token prompt, 4 greedy tokens within PARITY_TOL) and
                  the loss (patch positions masked) and every leaf's
                  gradient (batch 1, 64 tokens) within ZGRAD_TOL; then at
                  full size (48 layers, bf16, 34,293,424,128 parameters)
                  serving batch 4, the patches and a 1792-token prompt
                  (2048 fused positions, two KV chunks) and 32 tokens
                  twice with the same tokens:
                  prefill ms and text tokens/s, decode ms a step against
                  the floor (the weights and the whole K/V cache read once
                  a step), peak memory, four decode steps under
                  torch.profiler; no kernel launches
  vlm_round       chameleon-34b federated: full width cut to one layer (D =
                  1,765,826,560 bf16), W = 2 (2 clusters x 1 worker), batch
                  4 of 256 patches (seeded normal from numpy) and 256 text
                  tokens, ``SDFLBProtocol`` without the chain, the
                  TrainConfig ``specs.train_config_for`` gives the full
                  config (SGD lr 0.01, momentum 0.5, bf16 momentum, remat),
                  the flat pack: 3 sync rounds (exactly K1 and K2 each), a
                  bitwise same-seed rerun of the first, 2 async rounds
                  (exactly K1 and K3 each; each worker sits one out);
                  every update nonzero (its share that bf16 did not round
                  away reported), every score finite, the held-out loss not
                  higher after than before; K1 over each captured pack
                  against its plain version in column slices, each async
                  round's new pending buffer against K3's plain version bit
                  for bit, the settlement decisions from the card's scores
                  equal to those from the plain statistics'; K1, K2 and K3
                  at the round's pack timed beside their bounds
  dryrun          the dry run (``repro_torch.launch.dryrun``) held to the
                  card: ``HBM_BYTES`` within 1 % of the card's memory;
                  each kernel case on fake tensors gives its launch's
                  output shapes, dtypes and strides and launches nothing,
                  the wide path's scratch layouts equal the library's;
                  eight steps earlier phases measured (``dryrun_setups``:
                  the chameleon prefill and decode, ``llm_round``'s flat
                  sync and async rounds, ``moe_round``'s and
                  ``xlstm_round``'s first sync round, ``vlm_round``'s
                  first sync and async rounds), traced from the
                  build on in a niced background process with the card
                  hidden (``--dryrun-traces``; meta tensors), two of them
                  again here on fake CUDA tensors with equal counts; each
                  predicted peak plus what the card held beside the step's
                  arguments within max(5 %, 0.5 GiB) of the step's
                  ``max_memory_allocated`` (``vlm_round``'s within 64
                  MiB), each measured wall at least
                  its trace's max(compute_s, memory_s), the ratio printed
The last five, ``dense_serve`` and ``moe_serve`` report the device memory
held when they start, before and after the cycle collector runs
(``memory_before_release``, ``memory_held_at_start``).

Then it prints the run's total wall with each phase's wall seconds, the
card's ``nvidia-smi`` line, one
``{"kernels": [...]}``
line (each kernel's launches on its paths, its error against the plain
version, its time, the plain version's time, its bound and the time of a
library call where one computes the same function: ``torch.mv`` for K2,
``scaled_dot_product_attention`` for K5; none for K1, K3, K4 and K4's
backward, ``ssd_scan_bwd``; K4's entry and its backward's count their
calls on the zamba2 and xLSTM paths and carry the wide path's numbers
under ``wide``), and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without the last line; so does a machine without CUDA.
"""
import contextlib
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
PROFILE_RUNS = 5                 # runs a profiled round may take (lost records)

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
# zamba_serve's depth: 2 super-layers (6 Mamba2 layers and the shared block
# each) and the 3 tail layers of the full 13 + 3, at full width; the full
# depth's figures are in PERF.md section 5
ZSERVE_CUTS = {"num_layers": 15}
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
# K4's wide path (mLSTM's heads: dk = dh, dv = dh + 1, f32) at xlstm-1.3b's
# prefill shape (its last 16-column tile holds one column), the smoke
# config's (dh 128, chunk 64), a run from an initial state, and sizes that
# are no multiple of the kernels' tiles; gates "mlstm" (a = log
# sigmoid(3 + N(0, 1)), i = exp(clip(4 N(0, 1), -10, 10))) or "gentle"
SSD_WIDE_SERVE = dict(B=4, S=1024, H=4, dk=1024, dv=1025, chunk=256)
SSD_WIDE_SMOKE = dict(B=2, S=128, H=4, dk=128, dv=129, chunk=64)
SSD_WIDE_CASES = [(SSD_WIDE_SERVE, "mlstm", False),
                  (SSD_WIDE_SERVE, "gentle", False),
                  (SSD_WIDE_SMOKE, "mlstm", False),
                  (SSD_WIDE_SMOKE, "gentle", True),
                  (dict(SSD_WIDE_SERVE, B=1, S=512), "mlstm", True),
                  (dict(B=2, S=192, H=3, dk=200, dv=77, chunk=96), "gentle",
                   True)]
XLSTM = "xlstm-1.3b"
XSERVE = dict(batch=4, prompt_len=1024, gen=32)   # prompt: 4 mLSTM chunks
# xlstm_serve's depth: one super-layer (7 mLSTM blocks and the sLSTM
# block) of the full 6, at full width; the full depth's figures are in
# PERF.md section 5
XSERVE_CUTS = {"num_layers": 8}
# one super-layer: 7 mLSTM blocks and the sLSTM block, at full width
XPARITY_CUTS = {"num_layers": 8}
XPARITY = dict(batch=2, prompt_len=512, gen=4, seed=3)
# xlstm_round's sync and async rounds (zamba_round's 3 each; the rounds are
# ~5.4 s and ~2.8 s, the sLSTM loop on the host, PERF.md section 5): one
# each, to leave vlm_round room in the script's time limit
XROUNDS = 1
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


def time_ms(fn, reps=REPS):
    """Median device time of one call of ``fn`` over ``reps`` calls, from
    CUDA events around each call. A sleep kernel in front lets the host
    queue every call before the device starts, so host overhead stays
    out."""
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


def one_kernel(fn, name, calls=4, per_call=1):
    """Check that ``calls`` calls of ``fn`` ran ``per_call`` device kernels
    each: the profiler recorded ``calls * per_call`` runtime calls that put
    work on the card, each a kernel launch (no copy or memset), and every
    device activity it recorded is a kernel whose name holds ``name``. The
    device records alone cannot be counted: the profiler loses some of
    them (``_build.launch_records``)."""
    from repro_torch.kernels import _build
    enqueued, device = _build.launch_records(fn, calls)
    check(len(enqueued) == calls * per_call
          and all("Launch" in n for n in enqueued)
          and all(name in n for n in device),
          f"{name}: {calls} calls enqueued {enqueued} and ran {device}, "
          f"expected {per_call} kernel(s) each")
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
             library=lambda u, w: torch.mv(u.t(), w.to(u.dtype)),
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
                          if lib is not None else None)}
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
    out. With ``expect``, the record lists under ``missing`` each of its
    names that matches no recorded kernel, beside the kernel launches
    recorded on the host and the kernels recorded on the device (fewer
    where the profiler lost records), so that the caller can tell a
    renamed kernel from a lost record."""
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
    rec = {"wall_s": wall_s, "device_busy_s": busy_us / 1e6,
           "busy_share": busy_us / 1e6 / wall_s,
           label: ours_us / 1e6, "activities": len(acts),
           "top_device_us": [[k[:90], t, n] for k, (t, n) in top]}
    if expect:
        rec["missing"] = [n for n in expect
                          if not any(n in k for k in by_name)]
        rec["host_launches"] = sum(
            "LaunchKernel" in e.name for e in prof.events()
            if e.device_type == DeviceType.CPU)
        rec["device_kernels"] = sum(
            not any(w in e.name for w in ("Memcpy", "Memset"))
            for e in acts)
    return rec


def run_protocol(phase, *, async_mode, clusters=4, per_cluster=4, batch=64,
                 rounds=3, seed=0, profile_round=None):
    """SDFLBProtocol on the card: ``rounds`` rounds with the chain, then
    finalize and a deep chain check. Returns the phase record and the
    ledger's block hashes. Round ``profile_round``, if given, runs under
    torch.profiler and its device breakdown goes into the record. The
    profiler now and then loses device records (PERF.md section 7), K1's
    and K2's or K3's among them: a profiled round whose record lacks one
    of them runs again on the same batch under a fresh profiler, up to
    PROFILE_RUNS times in all (each run a round of its own on the chain),
    and the record keeps what the runs before it missed."""
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
    # K1-K3 by their device names; a profiled round runs K1 and K2 or K3
    dev = {k["name"]: k["device"] for k in kernel_table()}
    expect = (dev["trust_score"],
              dev["fused_async_agg" if async_mode else "trust_agg"])
    walls, recs, profiled = [], [], []
    for i, (b, p) in enumerate(zip(batches, parts)):
        for _ in range(PROFILE_RUNS if i == profile_round else 1):
            if i == profile_round:
                proto.flush()
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.start()
            t = time.monotonic()
            recs.append(proto.run_round(b, participation=p))
            walls.append(time.monotonic() - t)
            if i != profile_round:
                continue
            # the round returns with its last kernels (K2 or K3) still on
            # the card; stopped before they finish, the profiler loses
            # their device records
            torch.cuda.synchronize()
            prof.stop()
            profiled.append(device_profile(
                prof, walls[-1], ours=tuple(dev.values()),
                label="trust_kernels_s", expect=expect))
            del prof
            if not profiled[-1]["missing"]:
                break
    payouts = proto.finalize()
    torch.cuda.synchronize()
    total_s = time.monotonic() - t0
    check(proto.ledger.verify_chain(deep=True))
    check(len(proto.ledger.blocks) == len(recs) + 2)
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
           "rounds": len(recs), "setup_s": setup_s,
           "round_wall_s": walls,
           "round_train_s": [r.wall_time - r.chain_time for r in recs],
           "settle_s": [r.settle_time for r in recs],
           "total_s": total_s,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "mean_loss": [float(r.losses.mean()) for r in recs],
           "bad_workers": [int((r.scores < fed.trust_threshold).sum())
                           for r in recs],
           "blocks": len(proto.ledger.blocks)}
    if profiled:
        rec["profile"] = profiled[-1]
        rec["profile"]["runs_with_lost_records"] = [
            {k: r[k] for k in ("missing", "host_launches", "device_kernels")}
            for r in profiled[:-1]]
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
    much of the round the device is busy. A profile that lacks K1's or
    K2's device record after PROFILE_RUNS runs of the round fails."""
    out = {"phase": "profile"}
    for clusters, per_cluster, batch in ((4, 4, 64), (64, 64, 32)):
        rec, _ = run_protocol("profile", async_mode=False, clusters=clusters,
                              per_cluster=per_cluster, batch=batch,
                              rounds=2, profile_round=1)
        prof = rec["profile"]
        check(not prof["missing"], f"trust_kernels_s: no device record of "
              f"{prof['missing']} in {PROFILE_RUNS} profiled runs of the "
              f"round: {prof['runs_with_lost_records']}")
        out[f"W{clusters * per_cluster}"] = prof
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
    cuts = {"num_layers": 2, "window": 256}
    kw = dict(batch=2, prompt_len=320, gen=4, seed=3)
    out = {"phase": "serve_parity", "arch": ARCH, "cuts": cuts, **kw,
           "tol": PARITY_TOL}
    for dtype in ("float32", "bfloat16"):
        cfg = get_config(ARCH).replace(dtype=dtype, **cuts)
        params = _drawn_on_card(cfg, 3)
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


def wide_inputs(B, S, H, dk, dv, gates, init, gen):
    """mLSTM's operands for K4's wide path: per-head f32 q, k ~ N(0, 1/dk),
    v (B, S, H, dv) whose last column is ones (the normalizer's), gates
    "mlstm" (a = log sigmoid(3 + N(0, 1)): the forget gate's bias 3;
    i = exp(clip(4 N(0, 1), -10, 10)): the input gate up to e^10) or
    "gentle" (a ~ U(-0.02, 0), i = softplus(N(0, 1)))."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    q = torch.randn((B, S, H, dk), generator=gen, device=dev) * dk ** -0.5
    k = torch.randn((B, S, H, dk), generator=gen, device=dev) * dk ** -0.5
    v = torch.randn((B, S, H, dv), generator=gen, device=dev)
    v[..., -1] = 1.0
    if gates == "mlstm":
        a = F.logsigmoid(3.0 + torch.randn((B, S, H), generator=gen,
                                           device=dev))
        i = torch.exp(torch.clamp(4.0 * torch.randn(
            (B, S, H), generator=gen, device=dev), -10.0, 10.0))
    else:
        a = -0.02 * torch.rand((B, S, H), generator=gen, device=dev)
        i = F.softplus(torch.randn((B, S, H), generator=gen, device=dev))
    h0 = (torch.randn((B, H, dk, dv), generator=gen, device=dev) if init
          else None)
    return q, k, v, a, i, h0


def ssd_wide_case(K4, name, shape, gates, init, gen):
    """K4's wide path against its plain version's result on the same
    inputs (both f32), y and the final state within ``K4.excess``. With
    gentle gates at the serve and smoke shapes the plain version with each
    planted fault (``p_one_part`` among them: the wide path splits the
    gated scores into bf16 parts) must fail that check; at the serve shape
    with the model's gates two calls must give the same bits, 4 calls must
    make 4 x ``K4.WIDE_LAUNCHES`` kernel launches and nothing else, the
    same holds with bf16-valued q, k and v (the serve's, whose zero bf16
    parts the kernel skips), and the path and the plain version are timed
    on those beside the bound (and the path on full f32 values too)."""
    B, S, H, dk, dv, chunk = (shape[x] for x in ("B", "S", "H", "dk", "dv",
                                                 "chunk"))
    check(K4.is_wide(dk, dv, chunk), f"{shape} is not a wide shape")
    q, k, v, a, i, h0 = wide_inputs(B, S, H, dk, dv, gates, init, gen)
    before = K4.ssd_scan.launches
    y, h = K4.ssd_scan(q, k, v, a, i, chunk=chunk, initial_state=h0)
    torch.cuda.synchronize()
    check(K4.ssd_scan.launches == before + 1, "a wide call counts once")
    y32, h32 = K4.ssd_scan_ref(q, k, v, a, i, chunk=chunk, initial_state=h0)
    check(y.shape == v.shape and y.dtype == torch.float32
          and h.shape == (B, H, dk, dv) and h.dtype == torch.float32)
    check(torch.isfinite(y).all() and torch.isfinite(h).all())
    excess = {"y": K4.excess(y, y32), "state": K4.excess(h, h32)}
    row = {**shape, "gates": gates, "initial_state": init,
           "dtype": "float32",
           "max_abs_err": float((y - y32).abs().max()),
           "state_max_abs_err": float((h - h32).abs().max()),
           "y_absmax": float(y32.abs().max()),
           "state_absmax": float(h32.abs().max()), "excess": excess}
    if max(excess.values()) > 0:
        raise AssertionError(f"ssd_scan wide {row}: beyond the tolerance")
    if shape in (SSD_WIDE_SERVE, SSD_WIDE_SMOKE) and gates == "gentle":
        faults = {}
        for fault in K4.FAULTS:
            fy, fh = K4.ssd_scan_ref(q, k, v, a, i, chunk=chunk,
                                     initial_state=h0, fault=fault)
            faults[fault] = {"y_excess": K4.excess(fy, y32),
                             "state_excess": K4.excess(fh, h32)}
            check(max(faults[fault].values()) > 0,
                  f"K4's tolerance passes a planted fault at a wide "
                  f"shape: {fault}")
            del fy, fh
        row["planted_faults"] = faults
    if shape is SSD_WIDE_SERVE and gates == "mlstm":
        y2, h2 = K4.ssd_scan(q, k, v, a, i, chunk=chunk, initial_state=h0)
        row["bitwise_equal_rerun"] = bool(torch.equal(y, y2)
                                          and torch.equal(h, h2))
        check(row["bitwise_equal_rerun"], "two wide K4 calls differ")
        del y2, h2
        row["device_kernel"] = one_kernel(
            lambda: K4.ssd_scan(q, k, v, a, i, chunk=chunk,
                                initial_state=h0), "ssd_wide",
            per_call=K4.WIDE_LAUNCHES)
        bw, f32_peak = peaks(name)
        nbytes = K4.hbm_bytes(B, S, H, dk, dv, 4,
                              qk_per_head=True)["minimum"]
        fl = K4.flops(B, S, H, dk, dv, chunk)
        row.update(K4.bound(B, S, H, dk, dv, chunk, 4, bw, tensor_peak(name),
                            f32_peak, qk_per_head=True))
        # the serve's operands: bf16 values in f32 (models/ssm.py)
        qb, kb, vb = (x.bfloat16().float() for x in (q, k, v))
        yb, hb = K4.ssd_scan(qb, kb, vb, a, i, chunk=chunk)
        yb2, hb2 = K4.ssd_scan(qb, kb, vb, a, i, chunk=chunk)
        yb32, hb32 = K4.ssd_scan_ref(qb, kb, vb, a, i, chunk=chunk)
        row["bf16_values"] = {
            "excess": {"y": K4.excess(yb, yb32), "state": K4.excess(hb, hb32)},
            "max_abs_err": float((yb - yb32).abs().max()),
            "bitwise_equal_rerun": bool(torch.equal(yb, yb2)
                                        and torch.equal(hb, hb2))}
        check(max(row["bf16_values"]["excess"].values()) <= 0
              and row["bf16_values"]["bitwise_equal_rerun"],
              f"wide K4 on bf16-valued operands: {row['bf16_values']}")
        del yb, hb, yb2, hb2, yb32, hb32
        row.update({
            "design": K4.WIDE_DESIGN,
            "ms": time_ms(lambda: K4.ssd_scan(qb, kb, vb, a, i, chunk=chunk)),
            "ms_f32_values": time_ms(lambda: K4.ssd_scan(q, k, v, a, i,
                                                         chunk=chunk)),
            "plain_ms": time_ms(lambda: K4.ssd_scan_ref(qb, kb, vb, a, i,
                                                        chunk=chunk)),
            "library_ms": None, "min_bytes": nbytes, "flops": fl,
            "launches_per_call": K4.WIDE_LAUNCHES})
        del qb, kb, vb
        row["achieved_tflop_s"] = fl / row["ms"] / 1e9
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["share_of_f32_core_bound"] = row["f32_core_bound_ms"] / row["ms"]
    del q, k, v, a, i, h0, y, h, y32, h32
    torch.cuda.empty_cache()
    return row


def phase_ssd_kernel(name):
    """K4 against ssd_scan_ref on the card, the narrow kernel and the wide
    path; returns the rows at the two serve shapes (narrow: bf16, the
    model's gates; wide: the model's gates) for the kernels line."""
    from repro_torch.kernels import ssd_scan as K4
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [ssd_case(K4, name, shape, gates, init, dtype, gen)
             for dtype in ("float32", "bfloat16")
             for shape, gates, init in SSD_CASES]
    wide = [ssd_wide_case(K4, name, shape, gates, init, gen)
            for shape, gates, init in SSD_WIDE_CASES]
    emit({"phase": "ssd_kernel", "atol_rel": K4.ATOL_REL,
          "rtol_bf16": K4.RTOL[torch.bfloat16],
          "tolerance": "|kernel - plain_f32| <= atol_rel * max|plain_f32| "
                       "+ rtol * |plain_f32|, rtol 0 in f32 and for the "
                       "state", "cases": cases, "wide_cases": wide})
    return (next(c for c in cases if c["dtype"] == "bfloat16"
                 and "ms" in c), next(c for c in wide if "ms" in c))


def phase_zamba_parity():
    """The zamba2 serve on the card against the same on the CPU, at full
    width with the cuts listed in the phase line."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve
    kw = dict(batch=2, prompt_len=256, gen=4, seed=3)
    out = {"phase": "zamba_parity", "arch": ZAMBA, "cuts": ZPARITY_CUTS,
           **kw, "tol": PARITY_TOL}
    for dtype in ("float32", "bfloat16"):
        cfg = get_config(ZAMBA).replace(dtype=dtype, **ZPARITY_CUTS)
        params = _drawn_on_card(cfg, 3)
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
    """The zamba2 serve path at full width cut to ``ZSERVE_CUTS``: two
    same-seed runs, K4 counted over the first (once a Mamba2 layer), then
    one prefill and four decode steps under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import api, hybrid
    cfg = get_config(ZAMBA).replace(**ZSERVE_CUTS)
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
           "cuts": ZSERVE_CUTS,
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
# run, 1 for the chained sync run. Each round with the chain puts the 269
# MB model to IPFS (as 538 MB of f32, zlib on one host core: 105-128 s a
# put beside an NVIDIA H100 80GB HBM3 at 700.00 W, PERF.md section 5), and
# a round waits for the last one's block, so only the sync run settles on
# the chain, one round; the async run trains without it. Its same-seed
# rerun runs without the chain too and must reach the sync run's global
# params and scores bit for bit: the round's block records those scores
# and the cid of those params (the SHA-256 of their compressed msgpack,
# ``chain/ipfs.py``), and zlib is deterministic, so equal bits are equal
# records; the chain itself is rerun block for block by ``determinism``.
LLM_TRAIN = ["--arch", LLM, "--full", "--workers", "8", "--clusters", "2",
             "--batch", "32", "--seq", "128", "--rounds", "3"]
LLM_SYNC = ["--rounds", "1"]
LLM_ASYNC = ["--async", "--no-blockchain"]
LLM_RERUN = ["--rounds", "1", "--no-blockchain"]
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
                                tensor_peak(name), f32_peak,
                                dh_final=dh is not None))
        row.update({
            "ms": time_ms(lambda: K4.ssd_scan_bwd(
                q, k, v, a, i, dy, dh, chunk=chunk, initial_state=h0,
                states=states)),
            "plain_ms": time_ms(lambda: K4.ssd_scan_bwd_ref(
                q, k, v, a, i, dy, dh, chunk=chunk, initial_state=h0,
                states=states)),
            "library_ms": None,
            "min_bytes": K4.bwd_hbm_bytes(
                B, S, H, dk, dv, chunk, v.element_size(),
                dh_final=dh is not None)["minimum"],
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


def _rel_errs(g, want):
    """Each leaf's largest gap to ``want`` over want's largest value."""
    return {k: float((g[k] - want[k]).abs().max()
                     / want[k].abs().max().clamp_min(1e-30)) for k in g}


def phase_zamba_grad_parity():
    """zamba2-7b's loss and gradients on the card against the CPU, at full
    width cut to ZPARITY_CUTS, from the same weights, in f32 and bf16, with
    remat off and on: the loss and each leaf's gradient within ZGRAD_TOL;
    one K4 forward (two with remat in the super-layer, which backward
    recomputes; the tail layer is not checkpointed) and one K4 backward a
    Mamba2 layer a call, and no other kernel."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.datasets import synthetic_tokens
    from repro_torch.models import hybrid
    dev = torch.device("cuda")
    out = {"phase": "zamba_grad_parity", "arch": ZAMBA, "cuts": ZPARITY_CUTS,
           **ZGRAD, "tol": ZGRAD_TOL}
    for dtype in ("float32", "bfloat16"):
        cfg = get_config(ZAMBA).replace(dtype=dtype, **ZPARITY_CUTS)
        params = _drawn_on_card(cfg, 3)
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
            rel = _rel_errs(g, cpu_g)
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


def _drawn_on_card(cfg, seed):
    """``api.init(cfg)`` from a CUDA generator of ``seed``, copied to the
    CPU: the weights a parity phase hands to both devices. The CPU's
    generator draws ~115 M numbers a second on one core (15.4 s for
    chameleon-34b's one layer at full width on an NVIDIA H100 80GB HBM3
    host, PERF.md section 6), the card's in milliseconds."""
    from repro_torch.models import api
    dev = torch.device("cuda")
    drawn = api.init(cfg, torch.Generator(dev).manual_seed(seed), dev)
    params = {k: v.cpu() for k, v in drawn.items()}
    del drawn
    torch.cuda.empty_cache()
    return params


def _round_run(cfg, fresh, workers, async_mode, rounds, seed=0,
               kernels=("ssd_scan", "ssd_scan_bwd"), phase="zamba_round",
               shape=None, frames=None):
    """``rounds`` rounds of SDFLBProtocol over ``cfg`` on the card, built as
    launch/train.py builds it (no chain): each round's wall, tokens/s, K4's
    forward and backward launches, scores; the peak memory; before (the
    same seeded init) and after, the held-out loss on the continuation of
    the first round's streams, which must fall, and the loss on ``fresh``,
    a batch of an unrelated seed. ``shape`` holds the clusters, batch and
    seq (``ZROUND`` by default); ``frames(r)``, where given, the (workers,
    batch, encoder_seq, d) frames of round r (whisper), the first round's
    also the held-out set's. Each of ``kernels`` must launch every round
    and no other kernel at all."""
    from repro_torch.configs.base import FederationConfig, TrainConfig
    from repro_torch.core import async_sim
    from repro_torch.core.protocol import SDFLBProtocol
    from repro_torch.data.datasets import synthetic_tokens
    from repro_torch.models import api
    dev = torch.device("cuda")
    shape = ZROUND if shape is None else shape
    fed = FederationConfig(num_clusters=shape["clusters"],
                           workers_per_cluster=workers // shape["clusters"],
                           async_mode=async_mode, trust_threshold=0.3,
                           mode="allreduce")
    tc = TrainConfig(optimizer="adamw", lr=3e-4, remat=True, grad_clip=1.0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    proto = SDFLBProtocol(cfg, fed, tc, use_blockchain=False, seed=seed,
                          device=dev)
    B, S = shape["batch"], shape["seq"]
    # each round's streams at twice the length: the first half trains, the
    # second half of the first round's is the held-out set
    streams = [synthetic_tokens(workers, B, 2 * S, cfg.vocab_size,
                                seed=seed + r) for r in range(rounds)]
    heldout = {k: v[..., S:].reshape(workers * B, S)
               for k, v in streams[0].items()}
    if frames is not None:
        heldout["frames"] = frames(0).reshape((workers * B,)
                                              + frames(0).shape[2:])
    before = (_heldout_loss(cfg, proto.global_params, heldout, dev),
              _heldout_loss(cfg, proto.global_params, fresh, dev))
    torch.cuda.empty_cache()
    scheduler = async_sim.AsyncScheduler(
        async_sim.heterogeneous_profiles(workers, seed=seed), seed=seed,
        buffer_size=max(2, workers // 2)) if async_mode else None
    tokens = workers * B * S
    rec = {"workers": workers, "round_wall_s": [], "tokens_per_s": [],
           "k4_launches": [], "k4_bwd_launches": [], "mean_loss": [],
           "mean_score": [], "participation": []}
    first = None
    for r in range(rounds):
        part = scheduler.next_aggregation()[1] if scheduler else None
        data = {k: np.ascontiguousarray(v[..., :S])
                for k, v in streams[r].items()}
        if frames is not None:
            data["frames"] = frames(r)
        reset_counts()
        if r == 0:
            step = _step_begin([proto.task.global_params,
                                proto.task.opt_state])
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = proto.run_round(data, participation=part)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        if r == 0:
            window_max = _step_end(
                f"{phase}_{'async' if async_mode else 'sync'}", step)
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
    rec["max_memory_allocated"] = max(window_max,
                                      torch.cuda.max_memory_allocated())
    after = (_heldout_loss(cfg, proto.global_params, heldout, dev),
             _heldout_loss(cfg, proto.global_params, fresh, dev))
    rec["heldout_loss"] = [before[0], after[0]]
    rec["fresh_seed_loss"] = [before[1], after[1]]
    check(all(torch.isfinite(v).all() for v in proto.global_params.values()))
    check(after[0] < before[0], f"{phase}: held-out loss {before[0]} "
          f"-> {after[0]}")
    proto.finalize()
    return proto, rec, first


def _k4_round(phase, arch, cuts, extra, kernels=("ssd_scan", "ssd_scan_bwd"),
              ours=("ssd_",), label="k4_s", rounds=ZROUND["rounds"]):
    """``arch`` at full width cut to ``cuts``, federated on the card:
    ``rounds`` sync rounds at W = 4 and as many async rounds, each run with
    a falling
    held-out loss (``_round_run``) and each of ``kernels`` (K4's forward
    and backward by default) on every round, no other; a same-seed
    one-round rerun with bitwise-equal global params and scores; one
    worker's backward under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` flags no
    op, and a warm one under torch.profiler (device activity only: the
    share of the kernels named by ``ours``, as ``label``, and the device's
    busy share of the step, reported). ``extra(cfg)`` adds fields to the
    phase's line. Returns the launches of the rounds."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.datasets import synthetic_tokens
    from repro_torch.models import api
    dev = torch.device("cuda")
    cfg = get_config(arch).replace(**cuts)
    fresh = {k: v[0] for k, v in synthetic_tokens(
        1, ZROUND["batch"], ZROUND["seq"], cfg.vocab_size,
        seed=ZROUND_FRESH_SEED).items()}
    before_release = torch.cuda.memory_allocated()
    _release()
    held = torch.cuda.memory_allocated()
    free, total = torch.cuda.mem_get_info()
    out = {"phase": phase, "arch": arch, "cuts": cuts, **ZROUND,
           "rounds": rounds, "dtype": cfg.dtype, "chain": False,
           **extra(cfg),
           "memory_before_release": before_release,
           "memory_held_at_start": held, "device_free_at_start": free}
    reset_counts()
    W = ZROUND["workers"]
    proto, out["sync"], (p1, s1) = _round_run(cfg, fresh, W, False, rounds,
                                              kernels=kernels, phase=phase)
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
    check(not flagged, f"{phase}: nondeterministic ops {flagged}")
    out["worker_step_profile"] = _device_step_profile(step, ours, label)
    del step
    _release()
    # a same-seed rerun of the first round
    again, rerun, (p2, s2) = _round_run(cfg, fresh, W, False, 1,
                                        kernels=kernels, phase=phase)
    identical = all(torch.equal(p1[k], p2[k]) for k in p1) and \
        np.array_equal(s1, s2)
    check(identical, f"{phase}: same-seed rounds differ")
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
    proto, out["async"], _ = _round_run(cfg, fresh, Wa, True, rounds,
                                        kernels=kernels, phase=phase)
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


def phase_zamba_round(name):
    """zamba2-7b at full width (one super-layer) federated on the card
    (``_k4_round``)."""
    return _k4_round("zamba_round", ZAMBA, ZROUND_CUTS, lambda cfg: {
        "d_model": cfg.d_model, "ssd_heads": cfg.d_model * cfg.ssm.expand
        // 64})


def phase_xlstm_round(name):
    """xlstm-1.3b at full width cut to one super-layer (7 mLSTM blocks and
    the sLSTM block) federated on the card (``_k4_round``, ``XROUNDS``
    sync and async rounds): K4's wide forward and its wide backward on
    every round, and no other kernel."""
    from repro_torch.models import xlstm
    return _k4_round("xlstm_round", XLSTM, XPARITY_CUTS, lambda cfg: {
        "d_model": cfg.d_model,
        "mlstm_blocks": xlstm._split_layers(cfg)[0],
        "mlstm_heads": cfg.ssm.num_ssm_heads,
        "mlstm_head_dim": cfg.d_model * cfg.ssm.expand
        // cfg.ssm.num_ssm_heads}, rounds=XROUNDS)


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
    """Run the round ``fn(*args)`` and keep what its flat-pack path hands
    to K1 (``trust.update_stats_flat``): the (W, D) pack and the losses
    before and after the step."""
    from repro_torch.core import trust
    seen = []
    orig = trust.update_stats_flat

    def spy(*stats_args):
        seen.append(stats_args)
        return orig(*stats_args)
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
                floor=1.0, checks=None, library=None, cols=None, reps=REPS):
    """One kernel at a round's shape: error against its plain version,
    each output held to RTOL of its largest plain value (at least
    ``floor``), times and bound, and the time of ``library``, one PyTorch
    call computing the same, where given; ``checks(args, want, floor)``
    adds its own fields (without ``cols``). With ``cols``, the plain
    version runs on slices
    of that many columns of the 2-D arguments against the same columns of
    each output (K2 and K3, whose output columns read their own columns
    alone), where the whole plain version and the kernel's outputs do not
    fit the card together; ``reps`` timed calls each (``time_ms``)."""
    got = fn(*args)
    got = got if isinstance(got, tuple) else (got,)
    torch.cuda.synchronize()
    errs, tops = [0.0] * len(got), [0.0] * len(got)
    D = args[0].shape[1]
    for a in range(0, D, cols or D):
        sl = slice(a, a + (cols or D))
        want = plain(*[x[:, sl] if cols and x.ndim == 2 else x
                       for x in args])
        want = want if isinstance(want, tuple) else (want,)
        for i, (g, e) in enumerate(zip(got, want)):
            errs[i] = max(errs[i], float((g[..., sl] - e).abs().max())
                          if cols else float((g - e).abs().max()))
            tops[i] = max(tops[i], float(e.abs().max()))
    check(all(d <= RTOL * max(floor, t) for d, t in zip(errs, tops)),
          f"{name} at its round's shape: {errs} against {tops}")
    del got
    extra = checks(args, want, floor) if checks else {}
    del want
    t_bytes, t_ops = nbytes / bw * 1e3, flops / f32_peak * 1e3
    return {"max_abs_err": max(errs), "plain_max": tops,
            "ms": time_ms(lambda: fn(*args), reps),
            "plain_ms": time_ms(lambda: plain(*args), reps),
            "library_ms": (time_ms(lambda: library(*args), reps) if library
                           else None), "reps": reps,
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


def _device_step_profile(step, ours, label):
    """A warm ``step`` under torch.profiler, device activity only: its
    busy share and the time of the kernels named by ``ours``."""
    from torch.profiler import ProfilerActivity, profile
    step()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    t0 = time.monotonic()
    step()
    wall = time.monotonic() - t0
    prof.stop()
    return device_profile(prof, wall, ours=ours, label=label)


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
    """smollm-135m at full size through ``launch/train.py --full``: 1 sync
    round with the chain and 3 async rounds without it, per-leaf (no
    trust kernel on that path): each round's wall, tokens/s, settle time,
    the IPFS puts of the global model, peak memory and the held-out loss;
    one sync and one async flat-pack round from the same state as a
    per-leaf one, each timed against the per-leaf round (the same scores
    within LLM_SCORE_TOL and decisions; K1 with K2 or K3 once each,
    checked against their plain versions and K1 against the per-leaf
    statistics at W = 8, D = 134,515,008); a same-seed rerun without the
    chain reaches the sync round's global params and scores bit for bit;
    the deterministic-algorithms probe of the backward and one worker's
    step profiled."""
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
           "sync_args": LLM_SYNC, "async_args": LLM_ASYNC,
           "rerun_args": LLM_RERUN,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "dtype": cfg.dtype}
    reset_counts()
    proto, out["sync"], hashes = _llm_run(LLM_SYNC, heldout)
    out["sync"]["launches"] = read_counts()
    out["sync"]["blocks"] = len(hashes)
    # what the rerun must reach: round 1's global params and scores
    first = ({k: v.cpu() for k, v in proto.global_params.items()},
             proto.history[0].scores.copy())
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
    step = _step_begin([gp, opt, batch])
    t0 = time.monotonic()
    flat, (upd, _, _) = _capture_flat(flat_fn, gp, opt, batch)
    torch.cuda.synchronize()
    flat_s = time.monotonic() - t0
    window_max = _step_end("llm_flat_sync", step)
    flat_counts = read_counts()
    _expect("llm_round flat sync", flat_counts, _trust_launches(1, 0))
    flat_scores = flat.scores.cpu().numpy()
    sync_flat = {
        "leaf_round_s": leaf_s, "flat_round_s": flat_s,
        "round_max_memory_allocated": max(
            window_max, torch.cuda.max_memory_allocated()),
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
        f32_peak, library=lambda u, w: torch.mv(u.t(), w.to(u.dtype)))
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
    step = _step_begin([gp, opt, batch, part, flat_st])
    t0 = time.monotonic()
    (flat, flat_new), (upd, _, _) = _capture_flat(
        flat_fn, gp, opt, batch, None, part, flat_st)
    torch.cuda.synchronize()
    flat_s = time.monotonic() - t0
    _step_end("llm_flat_async", step)
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

    # a same-seed rerun of the sync run's round without the chain reaches
    # its global params and scores bit for bit (LLM_TRAIN's comment)
    again, rerun, _ = _llm_run(LLM_RERUN, heldout)
    identical = all(torch.equal(v, again.global_params[k].cpu())
                    for k, v in first[0].items()) and \
        np.array_equal(first[1], again.history[0].scores)
    check(identical, "llm_round: the unchained same-seed round differs "
          "from the chained one")
    out["rerun"] = {"chain": False, "identical_params_and_scores": identical,
                    "round_wall_s": rerun["round_wall_s"],
                    "settle_s": rerun["settle_s"]}
    del first
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
    before, held = _held_after_release()
    out = {"phase": "dense_serve", "parity": DENSE_PARITY,
           "serve": DENSE_SERVE, "tol": PARITY_TOL,
           "memory_before_release": before, "memory_held_at_start": held}
    for arch in DENSE:
        rec = {}
        for dtype in ("float32", "bfloat16"):
            cfg = get_config(arch).replace(dtype=dtype, num_layers=2)
            params = _drawn_on_card(cfg, 3)
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
        p32 = _drawn_on_card(cfg32, 3)
        rec["init_s"] = time.monotonic() - t0
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
    before, held = _held_after_release()
    out = {"phase": "moe_serve", "serve": DENSE_SERVE, "hbm_bytes_s": bw,
           "memory_before_release": before, "memory_held_at_start": held}
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
        held_before_serve = torch.cuda.memory_allocated()
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
            "memory_held_before_serve": held_before_serve,
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


def phase_xlstm_parity():
    """xlstm-1.3b at full width cut to one super-layer (``XPARITY_CUTS``:
    7 mLSTM blocks and the sLSTM block): ``serve`` on the card against the
    CPU, f32 and bf16 (``XPARITY``: batch 2, a 512-token prompt of two
    mLSTM chunks, 4 greedy tokens), the weights drawn once in f32 (bf16:
    rounded, the gates' f32 leaves kept, the smoke config's dtypes); K4
    launches 7 times (once an mLSTM prefill, its wide path) and no other
    kernel. bf16 logits are held within PARITY_TOL plus what bf16 alone
    moves the CPU's (the same weights in f32), as the MoE parity and the
    CPU tests hold bf16 logits. Every number is emitted before the checks
    fail the phase."""
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import api, xlstm
    cpu_dev = torch.device("cpu")
    cfg32 = get_config(XLSTM).replace(dtype="float32", **XPARITY_CUTS)
    n_m, n_super = xlstm._split_layers(cfg32)
    out = {"phase": "xlstm_parity", "arch": XLSTM, "cuts": XPARITY_CUTS,
           "mlstm_blocks": n_m * n_super, "slstm_blocks": n_super,
           **XPARITY, "tol": PARITY_TOL}
    t0 = time.monotonic()
    p32 = _drawn_on_card(cfg32, 3)
    out["init_s"] = time.monotonic() - t0
    dts = {k: v.dtype for k, v in api.init(
        get_smoke_config(XLSTM), torch.Generator().manual_seed(0),
        cpu_dev).items()}
    failures, cpu32 = [], None
    for dtype in ("float32", "bfloat16"):
        cfg = cfg32.replace(dtype=dtype)
        params = p32 if dtype == "float32" else \
            {k: v.to(dts[k]) for k, v in p32.items()}
        t0 = time.monotonic()
        cpu = serve(cfg, device="cpu", params=params, **XPARITY)
        cpu_s = time.monotonic() - t0
        reset_counts()
        card = serve(cfg, device="cuda",
                     params={k: v.cuda() for k, v in params.items()},
                     **XPARITY)
        launches = read_counts()
        want = {k: 0 for k in launches}
        want["ssd_scan"] = n_m * n_super
        if launches != want:
            failures.append(f"{dtype}: kernel launches {launches}, "
                            f"expected {want}")
        tol, gap = PARITY_TOL[dtype], None
        if dtype == "bfloat16":
            gap = _steps_gap(cpu, cpu32)
            tol += gap
        try:
            r = parity_record(cpu, card, dtype, XPARITY["gen"], tol=tol)
        except AssertionError as e:
            failures.append(f"{dtype}: {e}")
            r = {"failed": str(e)[:500]}
        out[dtype] = {**r, "tol": tol, "cpu_bf16_vs_f32_gap": gap,
                      "launches": launches, "cpu_serve_s": cpu_s,
                      "card_prefill_ms": card.prefill_s * 1e3}
        if dtype == "float32":
            cpu32 = cpu
        del params, card
        _release()
    del p32, cpu, cpu32
    emit(out)
    check(not failures, f"xlstm_parity: {failures}")


def phase_xlstm_serve(name):
    """xlstm-1.3b at full width cut to ``XSERVE_CUTS`` (8 of its 48
    layers; seeded random weights, bf16) serving ``XSERVE`` twice: K4
    launches 7 times a prefill (its wide path, once an mLSTM block) and
    no other kernel, the same-seed rerun
    emits the same tokens; prefill and decode times, the decode floor (the
    weights read once and the recurrent states read and written once a
    step, over the card's memory rate), peak memory; then one prefill and
    four decode steps under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import api, xlstm
    cfg = get_config(XLSTM).replace(**XSERVE_CUTS)
    n_m, n_super = xlstm._split_layers(cfg)
    B, P, G = XSERVE["batch"], XSERVE["prompt_len"], XSERVE["gen"]
    _release()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    r = serve(cfg, seed=0, **XSERVE)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in counts}
    want["ssd_scan"] = n_m * n_super
    if counts != want:
        raise AssertionError(f"xlstm_serve: kernel launches {counts}, "
                             f"expected {want}")
    check(r.tokens.shape == (B, G) and r.logits.shape == (B, G,
                                                          cfg.vocab_size))
    check(torch.isfinite(r.logits).all())
    check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()))
    check(torch.equal(r.tokens, r.logits.float().argmax(-1)))
    again = serve(cfg, seed=0, **XSERVE)
    if not torch.equal(again.tokens, r.tokens):
        raise AssertionError("same-seed xlstm serves emitted different "
                             "tokens")
    rec = {"phase": "xlstm_serve", "arch": XLSTM, **XSERVE,
           "cuts": XSERVE_CUTS,
           "layers": cfg.num_layers, "super_layers": n_super,
           "mlstm_per_super": n_m, "dtype": cfg.dtype,
           "prefill_ms": r.prefill_s * 1e3,
           "prefill_tok_s": B * P / r.prefill_s,
           "decode_ms_per_step": r.decode_s * 1e3 / (G - 1),
           "decode_tok_s": B * (G - 1) / r.decode_s,
           "rerun_prefill_ms": again.prefill_s * 1e3,
           "rerun_decode_ms_per_step": again.decode_s * 1e3 / (G - 1),
           "memory_held_at_start": held,
           "max_memory_allocated": peak, "launches": counts,
           "identical_tokens": True,
           "identical_logits": bool(torch.equal(again.logits, r.logits)),
           "sample_tokens": r.tokens[0, :16].tolist()}
    del r, again
    _release()
    dev = torch.device("cuda")
    params = api.init(cfg, torch.Generator(dev).manual_seed(0), dev)
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(1)
                            ).to(dev)
    acts = (ProfilerActivity.CPU, ProfilerActivity.CUDA)
    with torch.inference_mode():
        # where the prefill's device time goes: K4 against the rest. Its
        # device activities (~145k at full depth) come from the sLSTM
        # loop; the device
        # activity alone is recorded (the host's ops would triple what the
        # profiler then sorts). The profiler may lose device records late
        # in a long process (``_build.launch_records``), so they are
        # reported, not checked.
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        t0 = time.monotonic()
        logits, cache = api.prefill(params, cfg, {"tokens": prompts}, P + G)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        prof.stop()
        pre = device_profile(prof, wall, ours=("ssd_wide",), label="k4_s")
        pre["k4_share_of_busy"] = pre["k4_s"] / max(pre["device_busy_s"],
                                                    1e-12)
        rec["prefill_profile"] = pre
        del prof
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
    dec = device_profile(prof, wall, ours=("ssd_wide",), label="k4_s")
    dec["device_activities_per_step"] = dec["activities"] / 4
    rec["decode_profile_4_steps"] = dec
    nbytes = {key: v.numel() * v.element_size() for key, v in params.items()}
    # a decode step reads every weight once and of the embedding only the
    # B rows it looks up, and reads and writes every recurrent state once
    weights = (sum(nbytes.values()) - nbytes["embed"]
               + B * cfg.d_model * params["embed"].element_size())
    state = sum(t.numel() * t.element_size()
                for leaves in cache.values() for t in leaves.values())
    bw, _ = peaks(name)
    floor_ms = (weights + 2 * state) / bw * 1e3
    rec.update({
        "param_count": sum(v.numel() for v in params.values()),
        "param_bytes": sum(nbytes.values()),
        "weight_bytes_per_decode_step": weights,
        "state_bytes": state,
        "cache_bytes": {g: {n: t.numel() * t.element_size()
                            for n, t in leaves.items()}
                        for g, leaves in cache.items()},
        "decode_floor_ms_per_step": floor_ms,
        "decode_over_floor": rec["decode_ms_per_step"] / floor_ms})
    del params, cache, logits
    _release()
    emit(rec)
    return counts


# -- the xLSTM training slice: K4's wide backward, gradients, rounds ---------

# K4's wide backward (``csrc/ssd_scan_wide_bwd.cu``) at xlstm-1.3b's
# training shape (batch 4, seq 512: two chunks of 256, so the state's
# gradient crosses a chunk; dv 1025's last column tile holds one column)
# with mLSTM's gates and gentle ones, the smoke config's mLSTM shape from an
# initial state with a nonzero dh_final (init True), from an initial state
# alone ("h0") and with a dh_final alone ("dh"), each skip of a state known
# to be zero on its own, and sizes off the 128 x 128 tiles; the tolerance
# is ssd_scan.BWD_ATOL_REL
SSD_WIDE_TRAIN = dict(B=4, S=512, H=4, dk=1024, dv=1025, chunk=256)
SSD_WIDE_BWD_CASES = [(SSD_WIDE_TRAIN, "mlstm", False),
                      (SSD_WIDE_TRAIN, "gentle", False),
                      (SSD_WIDE_SMOKE, "mlstm", True),
                      (SSD_WIDE_SMOKE, "gentle", True),
                      (SSD_WIDE_SMOKE, "mlstm", "h0"),
                      (SSD_WIDE_SMOKE, "gentle", "dh"),
                      (dict(B=2, S=192, H=3, dk=200, dv=77, chunk=96),
                       "gentle", True)]
# xlstm_grad_parity: the card against the CPU at full width cut to one
# super-layer (XPARITY_CUTS), batch 1, seq 512 (two mLSTM chunks), the
# weights drawn once in f32 and rounded to the smoke config's dtypes, the
# f32 runs on those rounded values. The loss (absolute) against the CPU's
# whole model; the gradients block by block: each block's (and the head's)
# VJP on the CPU at the card's residual stream where the block takes it and
# the card's gradient where the block hands it on, each leaf's gradient and
# the gradient handed back relative to the CPU's largest value, each
# block's output relative to its largest. Not the CPU's whole-model
# gradient: the sLSTM's VJP moves some 20 times what its input moves
# (tests/test_torch_xlstm_train.py), so any rounding upstream of it, in f32
# the wide forward's two-part bf16 split, is magnified there. The bounds are
# zamba_grad_parity's (f32 loss 1e-4, gradients 2e-4; bf16 loss 2e-3,
# gradients 5e-2) and, for a block's output, 2e-4 in f32 and 2e-2 (about 5
# bf16 steps at the largest value) in bf16, as the CPU test's.
XGRAD = dict(batch=1, seq=512, seed=5)
XGRAD_TOL = {"float32": {"loss": 1e-4, "grad": 2e-4, "block_out": 2e-4},
             "bfloat16": {"loss": 2e-3, "grad": 5e-2, "block_out": 2e-2}}


def ssd_wide_bwd_case(K4, name, shape, gates, init, gen):
    """K4's wide backward against the plain backward's f32 result and
    against ``torch.autograd`` through the plain forward on the same card
    inputs (``K4.bwd_margins`` <= 1), both reading the f32 states the wide
    forward wrote, which must pass the forward's check of the plain
    forward's; ``init`` True, False, "h0" or "dh" (an initial state and a
    dh_final, neither, or one of them). At the training and smoke shapes
    each planted fault must fail by a margin > 1; at the training shape
    with mLSTM's gates two calls must give the same bits, 4 calls make 4 x
    ``WIDE_BWD_LAUNCHES`` kernel launches and nothing else, the kernel as
    autograd calls it in training (no initial state, no dh_final, no dh0)
    on bf16-valued q, k, v (training's: mLSTM widens them from bf16) must
    pass the same check, and the kernel (so, and on f32 values, and with
    dh0), the plain backward and the wide forward with and without its
    states are timed beside the bound."""
    B, S, H, dk, dv, chunk = (shape[x] for x in ("B", "S", "H", "dk", "dv",
                                                 "chunk"))
    check(K4.is_wide(dk, dv, chunk), f"{shape} is not a wide shape")
    dev = torch.device("cuda")
    has_h0, has_dh = init in (True, "h0"), init in (True, "dh")
    q, k, v, a, i, h0 = wide_inputs(B, S, H, dk, dv, gates, has_h0, gen)
    dy = torch.randn(v.shape, generator=gen, device=dev)
    dh = torch.randn((B, H, dk, dv), generator=gen, device=dev) \
        if has_dh else None
    _, _, states = K4._launch_fwd(q, k, v, a, i, h0, chunk, True)
    want_states = K4.ssd_scan_ref(q, k, v, a, i, chunk=chunk,
                                  initial_state=h0, return_states=True)[2]
    states_excess = K4.excess(states, want_states)
    del want_states
    K4.ssd_scan.bwd_launches = 0
    got = K4.ssd_scan_bwd(q, k, v, a, i, dy, dh, chunk=chunk,
                          initial_state=h0, states=states)
    torch.cuda.synchronize()
    check(K4.ssd_scan.bwd_launches == 1, "one wide backward call counted")
    check(all(g.dtype == torch.float32 and torch.isfinite(g).all()
              for g in got))
    plain = K4.ssd_scan_bwd_ref(q, k, v, a, i, dy, dh, chunk=chunk,
                                initial_state=h0, states=states)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v, a, i)]
    if has_h0:
        leaves.append(h0.detach().clone().requires_grad_(True))
    y, h = K4.ssd_scan_ref(*leaves[:5], chunk=chunk,
                           initial_state=leaves[5] if has_h0 else None)
    auto = torch.autograd.grad(
        [y, h], leaves, [dy, dh if has_dh else torch.zeros_like(h)])
    del y, h, leaves
    margins = {"plain": K4.bwd_margins(got, plain),
               "autograd": K4.bwd_margins(got, auto)}
    row = {**shape, "gates": gates, "initial_state": init,
           "dtype": "float32", "states_excess": states_excess,
           "max_abs_err": max(float((g - w).abs().max())
                              for g, w in zip(got, plain)),
           "plain_absmax": {n: float(w.abs().max())
                            for n, w in zip(K4.BWD_NAMES, plain)},
           "margins": margins}
    if states_excess > 0 or \
            max(max(m.values()) for m in margins.values()) > 1:
        raise AssertionError(f"ssd_scan_bwd wide {row}: beyond the "
                             f"tolerance")
    del auto
    if shape in (SSD_WIDE_TRAIN, SSD_WIDE_SMOKE):
        faults = {}
        for fault in K4.BWD_FAULTS:
            fg = K4.ssd_scan_bwd_ref(q, k, v, a, i, dy, dh, chunk=chunk,
                                     initial_state=h0, states=states,
                                     fault=fault)
            faults[fault] = max(K4.bwd_margins(fg, plain).values())
            check(faults[fault] > 1, f"K4's wide backward's tolerance "
                  f"passes a planted fault: {fault} {gates}")
            del fg
        row["fault_margins"] = faults
    if shape is SSD_WIDE_TRAIN and gates == "mlstm":
        again = K4.ssd_scan_bwd(q, k, v, a, i, dy, dh, chunk=chunk,
                                initial_state=h0, states=states)
        row["bitwise_equal_rerun"] = all(torch.equal(x, y)
                                         for x, y in zip(got, again))
        check(row["bitwise_equal_rerun"], "two wide backward calls differ")
        del again
        row["device_kernel"] = one_kernel(
            lambda: K4.ssd_scan_bwd(q, k, v, a, i, dy, dh, chunk=chunk,
                                    initial_state=h0, states=states),
            "ssd_wide_bwd", per_call=K4.WIDE_BWD_LAUNCHES)
        # as autograd calls it in training: bf16-valued q, k, v, no dh0
        xb = [x.bfloat16().float() for x in (q, k, v)]
        _, _, states_b = K4._launch_fwd(*xb, a, i, h0, chunk, True)
        got_b = K4.ssd_scan_bwd(*xb, a, i, dy, dh, chunk=chunk,
                                initial_state=h0, states=states_b,
                                want_dh0=False)
        plain_b = K4.ssd_scan_bwd_ref(*xb, a, i, dy, dh, chunk=chunk,
                                      initial_state=h0, states=states_b)
        row["margins"]["plain_bf16_values"] = K4.bwd_margins(got_b[:5],
                                                             plain_b[:5])
        check(got_b[5] is None and
              max(row["margins"]["plain_bf16_values"].values()) <= 1,
              f"ssd_scan_bwd wide on bf16 values: "
              f"{row['margins']['plain_bf16_values']}")
        del got_b, plain_b
        bw, f32_peak = peaks(name)
        row.update(K4.bwd_bound(B, S, H, dk, dv, chunk, 4, bw,
                                tensor_peak(name), f32_peak,
                                qk_per_head=True, dh_final=dh is not None,
                                initial_state=h0 is not None,
                                dh0=h0 is not None))
        row.update({
            "design": K4.WIDE_BWD_DESIGN,
            "launches_per_call": K4.WIDE_BWD_LAUNCHES,
            "ms": time_ms(lambda: K4.ssd_scan_bwd(
                *xb, a, i, dy, dh, chunk=chunk, initial_state=h0,
                states=states_b, want_dh0=h0 is not None)),
            "ms_f32_values": time_ms(lambda: K4.ssd_scan_bwd(
                q, k, v, a, i, dy, dh, chunk=chunk, initial_state=h0,
                states=states, want_dh0=h0 is not None)),
            "ms_with_dh0": time_ms(lambda: K4.ssd_scan_bwd(
                q, k, v, a, i, dy, dh, chunk=chunk, initial_state=h0,
                states=states)),
            "plain_ms": time_ms(lambda: K4.ssd_scan_bwd_ref(
                *xb, a, i, dy, dh, chunk=chunk, initial_state=h0,
                states=states_b)),
            "library_ms": None,
            "forward_with_states_ms": time_ms(lambda: K4._launch_fwd(
                q, k, v, a, i, h0, chunk, True)),
            "forward_ms": time_ms(lambda: K4._launch_fwd(
                q, k, v, a, i, h0, chunk, False)),
            "min_bytes": K4.bwd_hbm_bytes(B, S, H, dk, dv, chunk, 4,
                                          qk_per_head=True,
                                          dh_final=dh is not None,
                                          initial_state=h0 is not None,
                                          dh0=h0 is not None)["minimum"],
            "flops": K4.bwd_flops(B, S, H, dk, dv, chunk,
                                  initial_state=h0 is not None,
                                  dh_final=dh is not None,
                                  dh0=h0 is not None),
            "flops_all": K4.bwd_flops(B, S, H, dk, dv, chunk),
            "scratch_bytes": K4.wide_bwd_scratch_bytes(
                B, S, H, dk, dv, chunk, initial_state=h0 is not None,
                dh_final=dh is not None)})
        del xb, states_b
        row["achieved_tflop_s"] = row["flops"] / row["ms"] / 1e9
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["share_of_f32_core_bound"] = row["f32_core_bound_ms"] / row["ms"]
    del q, k, v, a, i, h0, dy, dh, states, got, plain
    torch.cuda.empty_cache()
    return row


def phase_ssd_wide_bwd_kernel(name):
    """K4's wide backward against ssd_scan_bwd_ref and autograd on the
    card; returns the row at the training shape (mLSTM's gates) for the
    kernels line."""
    from repro_torch.kernels import ssd_scan as K4
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = [ssd_wide_bwd_case(K4, name, shape, gates, init, gen)
             for shape, gates, init in SSD_WIDE_BWD_CASES]
    emit({"phase": "ssd_wide_bwd_kernel", "atol_rel": K4.BWD_ATOL_REL,
          "tolerance": "|kernel - plain_f32| <= atol_rel * max|plain_f32| "
                       "for each of dq, dk, dv, da, di, dh0",
          "cases": cases})
    return next(c for c in cases if "ms" in c)


def _xlstm_grads_at_boundaries(cfg, params, batch, remat):
    """The port's loss and every leaf's gradient (f32, on the CPU), with the
    residual stream where each block of ``xlstm_forward`` takes it (the
    input of each block's RMSNorm and of the final norm, in order) and its
    gradient, both on the CPU."""
    from repro_torch.models import api, layers
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    xs, dxs = [], {}
    orig = layers.rms_norm

    def spy(x, w, eps=1e-5):
        k = len(xs)
        xs.append(x)
        x.register_hook(lambda g: dxs.__setitem__(k, g.detach().cpu()))
        return orig(x, w, eps)
    # the forward only: remat's recomputation in backward is not recorded
    layers.rms_norm = spy
    try:
        loss, _ = api.lm_loss_fn(cfg, remat=remat, kv_chunk=512)(p, batch)
    finally:
        layers.rms_norm = orig
    g = torch.autograd.grad(loss, list(p.values()))
    return (float(loss.detach()), {k: x.float().cpu() for k, x in zip(p, g)},
            [x.detach().cpu() for x in xs], [dxs[k] for k in range(len(xs))])


def _xlstm_blocks_at(cfg, params, batch, xs, dxs):
    """Block by block on the trajectory (xs, dxs) of
    ``_xlstm_grads_at_boundaries``, on ``params``' device: each block's
    VJP (``x + block(rms_norm(x))``, the final norm with the head and the
    loss, the embedding's gather) at the residual stream where the block
    takes it and the gradient where the block hands it on. Returns the
    loss at the last hidden state, every leaf's gradient (f32, CPU), each
    block's output and each block's input gradient beside the trajectory's
    (relative gaps)."""
    from repro_torch.models import api, layers as L, ssm as SM, xlstm
    n_m, n_super = xlstm._split_layers(cfg)
    eps = cfg.norm_eps
    dev = next(iter(params.values())).device

    def m_block(lp, x):
        return x + SM.apply_mlstm(lp["mlstm"], L.rms_norm(x, lp["norm"], eps),
                                  cfg.ssm, chunk=cfg.ssm.chunk_size)

    def s_block(sp, x):
        return x + SM.apply_slstm(sp["slstm"], L.rms_norm(x, sp["norm"], eps),
                                  cfg.num_heads)

    def rel(got, want):
        return float((got.float().cpu() - want.float().cpu()).abs().max()
                     / want.float().abs().max().clamp_min(1e-30))
    grads = {k: torch.zeros(v.shape) for k, v in params.items()}
    outs, ins, b = [], [], 0

    def vjp(prefix, index, block):
        keys = [k for k in params if k.startswith(prefix)]
        leaves = {k: params[k][index].detach().clone().requires_grad_(True)
                  for k in keys}
        x = xs[b].to(dev).requires_grad_(True)
        y = block(L.param_group(leaves, prefix), x)
        g = torch.autograd.grad(y, [*leaves.values(), x], dxs[b + 1].to(dev))
        for k, gk in zip(keys, g):
            grads[k][index] = gk.float().cpu()
        outs.append(rel(xs[b + 1], y.detach()))
        ins.append(rel(dxs[b], g[-1]))
    for n in range(n_super):
        for j in range(n_m):
            vjp(xlstm.M, (n, j), m_block)
            b += 1
        vjp(xlstm.S_, n, s_block)
        b += 1
    fn, head, x = (params["final_norm"].detach().clone().requires_grad_(True),
                   params["lm_head"].detach().clone().requires_grad_(True),
                   xs[b].to(dev).requires_grad_(True))
    targets = api._shifted_targets(batch["labels"].to(dev), x.shape[1], 0)
    loss = api._chunked_xent(L.rms_norm(x, fn, eps), head, targets)
    d_fn, d_head, dx = torch.autograd.grad(loss, [fn, head, x])
    grads["final_norm"], grads["lm_head"] = d_fn.float().cpu(), \
        d_head.float().cpu()
    ins.append(rel(dxs[b], dx))
    emb = params["embed"].detach().clone().requires_grad_(True)
    (d_emb,) = torch.autograd.grad(emb[batch["tokens"].to(dev)], emb,
                                   dxs[0].to(dev))
    grads["embed"] = d_emb.float().cpu()
    return float(loss.detach()), grads, outs, ins


def phase_xlstm_grad_parity(control=None):
    """xlstm-1.3b on the card against the CPU at full width cut to one
    super-layer (7 mLSTM blocks and the sLSTM block), from the same
    weights, in f32 and bf16, with remat off and on, within XGRAD_TOL: the
    loss against the CPU's whole model; every leaf's gradient, each
    block's output and the gradient each block hands back against the
    CPU's block by block on the card's own trajectory
    (``_xlstm_blocks_at``); one K4 wide forward an mLSTM block (two with
    remat, which backward recomputes) and one wide backward a call, and no
    other kernel. ``control`` (a fault of ``ssd_scan.FAULTS``) runs the card
    with K4 replaced by its plain version planting that fault and no
    launch check: the phase must then fail. Every number is emitted before
    the checks fail the phase."""
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.data.datasets import synthetic_tokens
    from repro_torch.kernels import ssd_scan as K4
    from repro_torch.models import api, ssm, xlstm
    dev, cpu_dev = torch.device("cuda"), torch.device("cpu")
    cfg32 = get_config(XLSTM).replace(dtype="float32", **XPARITY_CUTS)
    n_m, n_super = xlstm._split_layers(cfg32)
    out = {"phase": "xlstm_grad_parity", "arch": XLSTM, "cuts": XPARITY_CUTS,
           **XGRAD, "tol": XGRAD_TOL, "control": control}
    t0 = time.monotonic()
    dts = {k: v.dtype for k, v in api.init(
        get_smoke_config(XLSTM), torch.Generator().manual_seed(0),
        cpu_dev).items()}
    pb = {k: v.to(dts[k]) for k, v in api.init(
        cfg32, torch.Generator().manual_seed(3), cpu_dev).items()}
    out["cpu_init_s"] = time.monotonic() - t0
    data = synthetic_tokens(1, XGRAD["batch"], XGRAD["seq"],
                            cfg32.vocab_size, seed=XGRAD["seed"])
    batch = {k: torch.from_numpy(v[0]) for k, v in data.items()}
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    failures = []
    try:
        for dtype in ("float32", "bfloat16"):
            cfg = cfg32.replace(dtype=dtype)
            params = {k: v.float() for k, v in pb.items()} \
                if dtype == "float32" else pb
            tol = XGRAD_TOL[dtype]
            t0 = time.monotonic()
            with torch.no_grad():
                cpu_loss = float(api.lm_loss_fn(cfg, kv_chunk=512)(
                    params, batch)[0])
            rec = {"cpu_loss": cpu_loss, "cpu_loss_s": time.monotonic() - t0,
                   "cpu_blocks_s": 0.0}
            card_params = {k: v.to(dev) for k, v in params.items()}
            ref = None
            for remat in (False, True):
                reset_counts()
                if control is not None:
                    ssm.ssd_scan = lambda *a, **kw: K4.ssd_scan_ref(
                        *a, fault=control, **kw)
                loss, g, xs, dxs = _xlstm_grads_at_boundaries(
                    cfg, card_params, card_batch, remat)
                ssm.ssd_scan = K4.ssd_scan
                counts = read_counts()
                want = {name: 0 for name in counts}
                if control is None:
                    want["ssd_scan"] = n_m * n_super * (2 if remat else 1)
                    want["ssd_scan_bwd"] = n_m * n_super
                if counts != want:
                    failures.append(f"{dtype} remat={remat}: launches "
                                    f"{counts}, expected {want}")
                same = ref is not None and all(
                    torch.equal(a, b) for a, b in zip(xs + dxs, ref[0]))
                if not same:
                    t0 = time.monotonic()
                    ref = (xs + dxs, _xlstm_blocks_at(cfg, params, batch,
                                                      xs, dxs))
                    rec["cpu_blocks_s"] += time.monotonic() - t0
                tail_loss, want_g, outs, ins = ref[1]
                rel = _rel_errs(g, want_g)
                worst = max(rel, key=rel.get)
                r = {"loss": loss, "loss_err": abs(loss - cpu_loss),
                     "tail_loss_err": abs(loss - tail_loss),
                     "worst_leaf": worst, "worst_rel_err": rel[worst],
                     "worst_over_tol": rel[worst] / tol["grad"],
                     "block_out_rel_err": max(outs),
                     "block_in_grad_rel_err": max(ins),
                     "trajectory_as_plain_run": same, "launches": counts}
                rec["remat" if remat else "plain"] = r
                if not (r["loss_err"] <= tol["loss"]
                        and r["tail_loss_err"] <= tol["loss"]
                        and rel[worst] <= tol["grad"]
                        and max(ins) <= tol["grad"]
                        and max(outs) <= tol["block_out"]
                        and np.isfinite(loss)):
                    failures.append(f"{dtype} remat={remat}: {r}")
                del g
            out[dtype] = rec
            del params, card_params, ref
            torch.cuda.empty_cache()
    finally:
        ssm.ssd_scan = K4.ssd_scan
    del pb
    _release()
    emit(out)
    check(not failures, f"xlstm_grad_parity: {failures}")


# -- MLA and the encoder-decoder: minicpm3-4b and whisper-base ---------------

# minicpm3-4b (Multi-head Latent Attention: q rank 768, latent rank 256, 40
# heads of nope 64 + rope 32, v 64; d 2560, 62 layers, V 73,448; 4.26 B
# parameters, bf16). Card against CPU at full width cut to 2 layers as
# dense_serve; the full-size serve's prompt is two KV chunks of 1024, so
# the prefill runs the chunked online softmax; its decode is the absorbed
# form over the (62, B, S, 288) latent cache.
MLA = "minicpm3-4b"
MLA_CUTS = {"num_layers": 2}
MLA_PARITY = dict(batch=2, prompt_len=160, gen=4, seed=3)
MLA_SERVE = dict(batch=4, prompt_len=2048, gen=32)
MLA_GRAD = dict(batch=1, seq=256, seed=5)
# whisper-base (6 encoder and 6 decoder layers, d 512, 8 heads, V 51,865,
# 1500 frames of the stub frontend; 71.4 M parameters, bf16), card against
# CPU and served at full size; its decode context is 448 tokens
WHISPER = "whisper-base"
WHISPER_PARITY = dict(batch=2, prompt_len=64, gen=4, seed=3)
WHISPER_SERVE = dict(batch=4, prompt_len=64, gen=64)
WHISPER_GRAD = dict(batch=1, seq=64, seed=5)
# whisper_round: W = 8 in 2 clusters, batch 4, 256 text tokens and 1500
# frames a sample (normal, from a numpy generator of the round's seed)
WROUND = dict(workers=8, clusters=2, batch=4, seq=256, rounds=3)
WROUND_FRAMES_SEED = 500


def _held_after_release():
    """(device bytes allocated before ``_release()``, after it): what the
    cycle collector frees of earlier phases' garbage, and what stays."""
    before = torch.cuda.memory_allocated()
    _release()
    return before, torch.cuda.memory_allocated()


def _grad_parity(cfg, params, batch, f32_grads=None):
    """The loss and every leaf's gradient on the card against the CPU from
    the same weights and batch (remat off), within ``ZGRAD_TOL`` of the
    dtype; in bf16 each leaf's bound adds the CPU's own bf16-vs-f32 gap of
    that leaf against ``f32_grads`` (the CPU's f32 gradients of the same
    weights before rounding), as the MoE and xLSTM parities add the CPU's
    bf16-vs-f32 gap to theirs: the CPU sums repeated tokens' embedding rows
    in bf16 (``index_add_``), the card in f32. No kernel may launch.
    Returns (the record, the CPU's gradients)."""
    dev = torch.device("cuda")
    tol = ZGRAD_TOL[cfg.dtype]
    t0 = time.monotonic()
    cpu_loss, cpu_g = _lm_grads(cfg, params, batch, False)
    cpu_s = time.monotonic() - t0
    reset_counts()
    loss, g = _lm_grads(cfg, {k: v.to(dev) for k, v in params.items()},
                        {k: v.to(dev) for k, v in batch.items()}, False)
    counts = read_counts()
    rel = _rel_errs(g, cpu_g)
    gap = (_rel_errs(cpu_g, f32_grads) if f32_grads is not None
           else {k: 0.0 for k in rel})
    over = {k: rel[k] / (tol["grad"] + gap[k]) for k in rel}
    worst = max(over, key=over.get)
    rec = {"loss": loss, "cpu_loss": cpu_loss,
           "loss_err": abs(loss - cpu_loss), "worst_leaf": worst,
           "worst_rel_err": rel[worst], "worst_leaf_cpu_gap": gap[worst],
           "worst_share_of_bound": over[worst],
           "largest_rel_err": max(rel.values()), "leaves": len(rel),
           "cpu_s": cpu_s, "launches": counts}
    _expect("grad parity", counts, _trust_launches(0, 0))
    check(np.isfinite(loss) and rec["loss_err"] <= tol["loss"]
          and over[worst] <= 1.0, f"grad parity: {rec}")
    return rec, cpu_g


def _serve_twice(cfg, params, serve_kw, phase):
    """``serve`` at ``serve_kw`` twice on the card from ``params`` (seed 0's
    weights) and seed 0's inputs: no kernel launches, the greedy tokens are
    the logits' argmax and the same both times. Returns (the first run,
    the second, the first's peak memory)."""
    from repro_torch.launch.serve import serve
    B, G = serve_kw["batch"], serve_kw["gen"]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    r = serve(cfg, seed=0, params=params, **serve_kw)
    peak = torch.cuda.max_memory_allocated()
    _expect(phase, read_counts(), _trust_launches(0, 0))
    check(r.tokens.shape == (B, G)
          and r.logits.shape == (B, G, cfg.vocab_size))
    check(torch.isfinite(r.logits).all())
    check(torch.equal(r.tokens, r.logits.float().argmax(-1)))
    again = serve(cfg, seed=0, params=params, **serve_kw)
    check(torch.equal(again.tokens, r.tokens),
          f"{phase}: same-seed serves emitted different tokens")
    return r, again, peak


def _serve_times(r, again, serve_kw):
    B, P, G = serve_kw["batch"], serve_kw["prompt_len"], serve_kw["gen"]
    return {"prefill_ms": r.prefill_s * 1e3,
            "prefill_tok_s": B * P / r.prefill_s,
            "decode_ms_per_step": r.decode_s * 1e3 / (G - 1),
            "decode_tok_s": B * (G - 1) / r.decode_s,
            "rerun_prefill_ms": again.prefill_s * 1e3,
            "rerun_decode_ms_per_step": again.decode_s * 1e3 / (G - 1),
            "identical_tokens": True,
            "identical_logits": bool(torch.equal(again.logits, r.logits)),
            "sample_tokens": r.tokens[0, :16].tolist()}


def _nbytes(tree):
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(_nbytes(v) for v in tree.values())


def _serve_parity(out, cfg32, serve_kw, grad_batch):
    """``serve`` on the card against the CPU in f32 and bf16 from weights
    drawn once in f32 (seed 3, ``_drawn_on_card``; bf16: rounded), within
    PARITY_TOL (``parity_record``), and the loss and every leaf's gradient
    on ``grad_batch`` (``_grad_parity``); no kernel launches. Fills
    ``out[dtype]``."""
    from repro_torch.launch.serve import serve
    dev = torch.device("cuda")
    t0 = time.monotonic()
    p32 = _drawn_on_card(cfg32, 3)
    out["init_s"] = time.monotonic() - t0
    g32 = None
    for dtype in ("float32", "bfloat16"):
        cfg = cfg32.replace(dtype=dtype)
        params = {k: v.to(getattr(torch, dtype)) for k, v in p32.items()}
        t0 = time.monotonic()
        cpu = serve(cfg, device="cpu", params=params, **serve_kw)
        cpu_s = time.monotonic() - t0
        reset_counts()
        card = serve(cfg, device="cuda",
                     params={k: v.to(dev) for k, v in params.items()},
                     **serve_kw)
        _expect(f"{out['phase']} parity {dtype}", read_counts(),
                _trust_launches(0, 0))
        rec = parity_record(cpu, card, dtype, serve_kw["gen"])
        rec["cpu_serve_s"] = cpu_s
        rec["grads"], g = _grad_parity(cfg, params, grad_batch, g32)
        out[dtype] = rec
        g32 = g
        del params, cpu, card
        _release()
    del p32, g32
    _release()


def phase_mla_serve(name):
    """minicpm3-4b. Card against CPU at full width cut to 2 layers
    (``MLA_PARITY``, ``_serve_parity``): prefill logits, absorbed-decode
    logits and greedy tokens within PARITY_TOL; the loss and every leaf's
    gradient at batch 1, seq 256 within ZGRAD_TOL. Then the full size
    (bf16, seeded weights) serving ``MLA_SERVE`` twice with the same
    tokens: prefill ms, decode ms a step against the floor (the weights a
    step reads, all but the embedding's unused rows, and the whole latent
    cache, over the card's memory rate), the cache's bytes a token against
    expanded K/V, peak memory, and four decode steps under torch.profiler
    (device activity). No kernel launches anywhere."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.data.datasets import synthetic_tokens
    from repro_torch.models import api
    dev = torch.device("cuda")
    before, held = _held_after_release()
    out = {"phase": "mla_serve", "arch": MLA, "cuts": MLA_CUTS,
           "parity": MLA_PARITY, "grad": MLA_GRAD, "serve": MLA_SERVE,
           "tol": PARITY_TOL, "grad_tol": ZGRAD_TOL,
           "memory_before_release": before, "memory_held_at_start": held}
    t0 = time.monotonic()
    cfg32 = get_config(MLA).replace(dtype="float32", **MLA_CUTS)
    data = synthetic_tokens(1, MLA_GRAD["batch"], MLA_GRAD["seq"],
                            cfg32.vocab_size, seed=MLA_GRAD["seed"])
    _serve_parity(out, cfg32, MLA_PARITY,
                  {k: torch.from_numpy(v[0]) for k, v in data.items()})
    out["parity_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    cfg = get_config(MLA)
    B, P, G = MLA_SERVE["batch"], MLA_SERVE["prompt_len"], MLA_SERVE["gen"]
    params = api.init(cfg, torch.Generator(dev).manual_seed(0), dev)
    r, again, peak = _serve_twice(cfg, params, MLA_SERVE, "mla_serve")
    out["full"] = {"layers": cfg.num_layers, "d_model": cfg.d_model,
                   "dtype": cfg.dtype, "max_memory_allocated": peak,
                   **_serve_times(r, again, MLA_SERVE)}
    del r, again
    out["serve_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(1)
                            ).to(dev)
    with torch.inference_mode():
        logits, cache = api.prefill(params, cfg, {"tokens": prompts}, P + G)
        tok = logits[:, -1].float().argmax(-1, keepdim=True)
        api.decode_step(params, cfg, cache, tok, P)           # warm
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        t1 = time.monotonic()
        for i in range(4):
            api.decode_step(params, cfg, cache, tok, P + 1 + i)
        torch.cuda.synchronize()
        wall = time.monotonic() - t1
        prof.stop()
    dec = device_profile(prof, wall, ours=("gemm", "nvjet", "xmma"),
                         label="gemm_s")
    dec["device_activities_per_step"] = dec["activities"] / 4
    out["full"]["decode_profile_4_steps"] = dec
    out["profile_s"] = time.monotonic() - t0
    nbytes = {k: _nbytes(v) for k, v in params.items()}
    # a decode step reads every weight once, of the embedding only the B
    # rows it looks up, and the whole latent cache (every slot's score)
    weights = (sum(nbytes.values()) - nbytes["embed"]
               + B * cfg.d_model * params["embed"].element_size())
    cache_bytes = _nbytes(cache)
    m = cfg.mla
    el = params["embed"].element_size()
    bw, _ = peaks(name)
    floor_ms = (weights + cache_bytes) / bw * 1e3
    out["full"].update({
        "param_count": api.param_count(params),
        "param_bytes": sum(nbytes.values()),
        "weight_bytes_per_decode_step": weights,
        "latent_cache_bytes": cache_bytes,
        "cache_bytes_per_token": cfg.num_layers * (m.kv_lora_rank
                                                   + m.qk_rope_head_dim) * el,
        "expanded_kv_bytes_per_token": cfg.num_layers * cfg.num_heads * (
            m.qk_nope_head_dim + m.qk_rope_head_dim + m.v_head_dim) * el,
        "decode_floor_ms_per_step": floor_ms,
        "decode_over_floor": out["full"]["decode_ms_per_step"] / floor_ms})
    del params, cache, logits, prof
    _release()
    emit(out)


def phase_mla_round(name):
    """minicpm3-4b at full width cut to 2 layers (D = 501,406,208)
    federated on the card (``_k4_round`` with no kernel to launch): 3 sync
    rounds at W = 4 and async rounds at the W the memory reckoning allows,
    each with a falling held-out loss, a bitwise same-seed rerun, the
    deterministic-algorithms probe and a profiled worker step."""
    return _k4_round("mla_round", MLA, MLA_CUTS, lambda cfg: {
        "d_model": cfg.d_model, "heads": cfg.num_heads,
        "kv_lora_rank": cfg.mla.kv_lora_rank}, kernels=(),
        ours=("gemm", "nvjet", "xmma"), label="gemm_s")


def _whisper_frames(n, cfg, seed):
    """(n, encoder_seq, d) f32 frames, normal, from a numpy generator."""
    return np.random.default_rng(seed).standard_normal(
        (n, cfg.encoder_seq, cfg.d_model), dtype=np.float32)


def phase_whisper_serve(name):
    """whisper-base. Card against CPU at full size (``WHISPER_PARITY``: 1500
    frames, a 64-token prompt, 4 greedy tokens; ``_serve_parity``): logits
    and tokens within PARITY_TOL; the loss and every leaf's gradient at
    batch 1, 64 tokens and 1500 frames within ZGRAD_TOL. Then the full size
    (bf16, seeded weights and frames) serving ``WHISPER_SERVE`` twice with
    the same tokens: prefill ms, decode ms a step against the floor (the
    decoder's weights, the tied head and both caches read once a step, over
    the card's memory rate), peak memory. No kernel launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import api
    dev = torch.device("cuda")
    before, held = _held_after_release()
    out = {"phase": "whisper_serve", "arch": WHISPER,
           "parity": WHISPER_PARITY, "grad": WHISPER_GRAD,
           "serve": WHISPER_SERVE, "tol": PARITY_TOL, "grad_tol": ZGRAD_TOL,
           "memory_before_release": before, "memory_held_at_start": held}
    t0 = time.monotonic()
    cfg32 = get_config(WHISPER).replace(dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(WHISPER_GRAD["seed"])
                            .integers(0, cfg32.vocab_size,
                                      (WHISPER_GRAD["batch"],
                                       WHISPER_GRAD["seq"])))
    _serve_parity(out, cfg32, WHISPER_PARITY, {
        "tokens": toks, "labels": toks, "frames": torch.from_numpy(
            _whisper_frames(WHISPER_GRAD["batch"], cfg32,
                            WHISPER_GRAD["seed"]))})
    out["parity_s"] = time.monotonic() - t0
    cfg = get_config(WHISPER)
    B, P, G = WHISPER_SERVE["batch"], WHISPER_SERVE["prompt_len"], \
        WHISPER_SERVE["gen"]
    check(P + G <= 448, "whisper serves at most 448 tokens")
    params = api.init(cfg, torch.Generator(dev).manual_seed(0), dev)
    r, again, peak = _serve_twice(cfg, params, WHISPER_SERVE,
                                  "whisper_serve")
    nbytes = {k: _nbytes(v) for k, v in params.items()}
    # a decode step reads the decoder's weights, the whole tied head (the
    # embedding) and both caches: self K/V at every slot, cross K/V
    dec_w = sum(n for k, n in nbytes.items() if k.startswith("dec"))
    cache = _nbytes(api.make_cache(cfg, B, P + G, torch.device("meta")))
    bw, _ = peaks(name)
    floor_ms = (dec_w + nbytes["embed"] + cache) / bw * 1e3
    out["full"] = {
        "encoder_layers": cfg.encoder_layers, "layers": cfg.num_layers,
        "frames": cfg.encoder_seq, "d_model": cfg.d_model,
        "dtype": cfg.dtype, "param_count": api.param_count(params),
        "decoder_weight_bytes": dec_w, "head_bytes": nbytes["embed"],
        "cache_bytes": cache, "max_memory_allocated": peak,
        **_serve_times(r, again, WHISPER_SERVE),
        "decode_floor_ms_per_step": floor_ms}
    out["full"]["decode_over_floor"] = \
        out["full"]["decode_ms_per_step"] / floor_ms
    del r, again, params
    _release()
    emit(out)


def phase_whisper_round(name):
    """whisper-base at full size (D = 71,426,560) federated on the card
    through ``SDFLBProtocol`` (AdamW, remat, no chain), batches with
    frames: 3 sync rounds at W = 8 and 3 async rounds, each with a falling
    held-out loss and no kernel launch (``_round_run``), and a same-seed
    one-round rerun with bitwise-equal global params and scores; one
    worker's step under the deterministic-algorithms probe and, warm,
    under torch.profiler (device activity)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import api
    dev = torch.device("cuda")
    cfg = get_config(WHISPER)
    W, B, S = WROUND["workers"], WROUND["batch"], WROUND["seq"]
    rng = np.random.default_rng(ZROUND_FRESH_SEED)
    fresh = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                    ).astype(np.int32)}
    fresh["labels"] = fresh["tokens"].copy()
    fresh["frames"] = _whisper_frames(B, cfg, ZROUND_FRESH_SEED)

    def frames(r):
        return _whisper_frames(W * B, cfg, WROUND_FRAMES_SEED + r).reshape(
            W, B, cfg.encoder_seq, cfg.d_model)

    before, held = _held_after_release()
    out = {"phase": "whisper_round", "arch": WHISPER, **WROUND,
           "frames": cfg.encoder_seq, "dtype": cfg.dtype, "chain": False,
           "memory_before_release": before, "memory_held_at_start": held}
    kw = dict(kernels=(), phase="whisper_round", shape=WROUND, frames=frames)
    proto, out["sync"], (p1, s1) = _round_run(cfg, fresh, W, False,
                                              WROUND["rounds"], **kw)
    D = api.param_count(proto.global_params)
    out["D"] = D
    step = _worker_step(cfg, proto.global_params, {
        k: torch.from_numpy(v).to(dev) for k, v in fresh.items()})
    del proto
    flagged, cublas = _deterministic_probe(step)
    out["nondeterministic_ops_flagged"] = flagged
    out["cublas_notes"] = cublas
    check(not flagged, f"whisper_round: nondeterministic ops {flagged}")
    out["worker_step_profile"] = _device_step_profile(
        step, ("gemm", "nvjet", "xmma"), "gemm_s")
    del step
    _release()
    again, rerun, (p2, s2) = _round_run(cfg, fresh, W, False, 1, **kw)
    identical = all(torch.equal(p1[k], p2[k]) for k in p1) and \
        np.array_equal(s1, s2)
    check(identical, "whisper_round: same-seed rounds differ")
    out["rerun"] = {"identical_params_and_scores": identical,
                    "round_wall_s": rerun["round_wall_s"]}
    del again, p1, p2
    _release()
    proto, out["async"], _ = _round_run(cfg, fresh, W, True,
                                        WROUND["rounds"], **kw)
    del proto
    _release()
    emit(out)


# chameleon-34b (the VLM family: 48 layers, d 8192, 64 heads and 8 KV heads
# of 128, d_ff 22016, V 65,536, an untied head; 256 patch embeddings of the
# stub VQ frontend before the text; 34,293,424,128 parameters, 68.6 GB in
# bf16): card against CPU at full width cut to one layer with all 256
# patches, then served at full size. The serve's 256 patches and 1792 text
# tokens make 2048 fused positions, two KV chunks; its cache holds 2080
# slots. At batch 4 it peaks at 76.8 GB of the card's 85.0 (PERF.md
# section 5).
VLM = "chameleon-34b"
VLM_CUTS = {"num_layers": 1}
VLM_PARITY = dict(batch=2, prompt_len=64, gen=4, seed=3)
VLM_SERVE = dict(batch=4, prompt_len=1792, gen=32)
VLM_GRAD = dict(batch=1, seq=64, seed=5)
VLM_PARAMS = 34_293_424_128
VLM_HELD_MAX = 1e9               # bytes earlier phases may leave allocated


def phase_vlm_serve(name):
    """chameleon-34b. Starts with what earlier phases hold collected, at
    most VLM_HELD_MAX allocated. Card against CPU at full width cut to one
    layer (``VLM_PARITY``, ``_serve_parity``): prefill and decode logits and
    greedy tokens within PARITY_TOL; the loss (the patch positions
    masked) and every leaf's gradient at batch 1, 256 patches and 64
    tokens within ZGRAD_TOL. Then the full size (bf16, seeded weights,
    34,293,424,128 parameters) serving ``VLM_SERVE`` twice with the same
    tokens: prefill ms and text tokens/s, decode ms a step against the floor (the
    weights a step reads, all but the embedding's unused rows, and the
    whole K/V cache, over the card's memory rate), peak memory, and four
    decode steps under torch.profiler. No kernel launches anywhere."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.models import api
    dev = torch.device("cuda")
    before, held = _held_after_release()
    free, total = torch.cuda.mem_get_info()
    out = {"phase": "vlm_serve", "arch": VLM, "cuts": VLM_CUTS,
           "parity": VLM_PARITY, "grad": VLM_GRAD, "serve": VLM_SERVE,
           "tol": PARITY_TOL, "grad_tol": ZGRAD_TOL,
           "memory_before_release": before, "memory_held_at_start": held,
           "device_free_at_start": free, "device_total": total}
    check(held <= VLM_HELD_MAX,
          f"vlm_serve: {held} B still allocated after the collector ran "
          f"(mem_get_info: {free} B free of {total}); the 68.6 GB model "
          f"needs the card")
    t0 = time.monotonic()
    cfg32 = get_config(VLM).replace(dtype="float32", **VLM_CUTS)
    rng = np.random.default_rng(VLM_GRAD["seed"])
    toks = torch.from_numpy(rng.integers(0, cfg32.vocab_size,
                                         (VLM_GRAD["batch"],
                                          VLM_GRAD["seq"])))
    patches = torch.from_numpy(rng.standard_normal(
        (VLM_GRAD["batch"], cfg32.num_patch_tokens, cfg32.d_model),
        dtype=np.float32))
    _serve_parity(out, cfg32, VLM_PARITY, {
        "tokens": toks, "labels": toks, "patch_embeds": patches})
    out["parity_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    cfg = get_config(VLM)
    params = api.init(cfg, torch.Generator(dev).manual_seed(0), dev)
    n_params = api.param_count(params)
    check(n_params == VLM_PARAMS, f"vlm_serve: {n_params} parameters")
    out["full_init_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    r, again, peak = _serve_twice(cfg, params, VLM_SERVE, "vlm_serve")
    B, P, G = VLM_SERVE["batch"], VLM_SERVE["prompt_len"], VLM_SERVE["gen"]
    Pt = cfg.num_patch_tokens
    out["full"] = {"layers": cfg.num_layers, "d_model": cfg.d_model,
                   "dtype": cfg.dtype, "patch_tokens": Pt,
                   "fused_positions": Pt + P, "cache_slots": Pt + P + G,
                   "max_memory_allocated": peak,
                   **_serve_times(r, again, VLM_SERVE)}
    del r, again
    out["serve_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    dt = getattr(torch, cfg.dtype)
    inputs = {"tokens": torch.randint(
        0, cfg.vocab_size, (B, P),
        generator=torch.Generator().manual_seed(1)).to(dev),
        "patch_embeds": torch.randn(
            (B, Pt, cfg.d_model),
            generator=torch.Generator().manual_seed(2)).to(dev, dt)}
    with torch.inference_mode():
        step = _step_begin([params, inputs])
        logits, cache = api.prefill(params, cfg, inputs, Pt + P + G)
        _step_end("vlm_prefill", step)
        tok = logits[:, -1].float().argmax(-1, keepdim=True)
        step = _step_begin([params, cache, tok])
        api.decode_step(params, cfg, cache, tok, Pt + P)       # warm
        _step_end("vlm_decode", step)
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        t1 = time.monotonic()
        for i in range(4):
            api.decode_step(params, cfg, cache, tok, Pt + P + 1 + i)
        torch.cuda.synchronize()
        wall = time.monotonic() - t1
        prof.stop()
    dec = device_profile(prof, wall, ours=("gemm", "nvjet", "xmma"),
                         label="gemm_s")
    dec["device_activities_per_step"] = dec["activities"] / 4
    out["full"]["decode_profile_4_steps"] = dec
    out["profile_s"] = time.monotonic() - t0
    nbytes = {k: _nbytes(v) for k, v in params.items()}
    # a decode step reads every weight once, of the embedding only the B
    # rows it looks up, and the whole K/V cache (every slot's score)
    weights = (sum(nbytes.values()) - nbytes["embed"]
               + B * cfg.d_model * params["embed"].element_size())
    cache_bytes = _nbytes(cache)
    bw, _ = peaks(name)
    floor_ms = (weights + cache_bytes) / bw * 1e3
    out["full"].update({
        "param_count": n_params, "param_bytes": sum(nbytes.values()),
        "weight_bytes_per_decode_step": weights,
        "kv_cache_bytes": cache_bytes,
        "decode_floor_ms_per_step": floor_ms,
        "decode_over_floor": out["full"]["decode_ms_per_step"] / floor_ms})
    del params, cache, logits, prof, inputs
    _release()
    emit(out)


# chameleon-34b federated on one card: full width cut to one layer, W = 2
# (2 clusters x 1 worker), 4 sequences a worker of 256 patches and 256 text
# tokens, the economics ``specs.train_config_for`` gives the full config
# (SGD, lr 0.01, momentum 0.5, bf16 momentum, remat, no clip), the flat pack
VLM_ROUND = dict(workers=2, clusters=2, batch=4, text=256, sync_rounds=3,
                 async_rounds=2)
VLM_ROUND_D = 1_765_826_560
VLM_ROUND_MASKS = [[1, 0], [0, 1]]    # async: one takes part, the other's
                                      # update waits in its pending row
VLM_ROUND_PATCH_SEED = 600
VLM_ROUND_COLS = 1 << 28              # columns a plain check takes at once
VLM_ROUND_PEAK_TOL = 64 * 2**20       # its dry run's peaks, against the card
VLM_ROUND_REPS = 10                   # timed calls a kernel (K1 ~0.18 s)


def _vlm_round_fed(async_mode):
    from repro_torch.configs.base import FederationConfig
    return FederationConfig(num_clusters=VLM_ROUND["clusters"],
                            workers_per_cluster=VLM_ROUND["workers"]
                            // VLM_ROUND["clusters"], async_mode=async_mode,
                            trust_threshold=0.3, mode="allreduce",
                            fused_trust_path="on")


def _vlm_round_setup():
    """(the config, the TrainConfig) of the round: the reference's rule
    read on the full config (the cut one would give f32 state)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import specs
    return (get_config(VLM).replace(**VLM_CUTS),
            specs.train_config_for(get_config(VLM)))


def _vlm_round_data(cfg, r):
    """Round r's batch: each worker's token streams at twice the text
    length (the second half of round 0's is the held-out set) and its
    (B, P, d) patch embeddings, seeded normal f32 from numpy."""
    from repro_torch.data.datasets import synthetic_tokens
    W, B, S = (VLM_ROUND[k] for k in ("workers", "batch", "text"))
    streams = synthetic_tokens(W, B, 2 * S, cfg.vocab_size, seed=r)
    patches = np.random.default_rng(VLM_ROUND_PATCH_SEED + r).standard_normal(
        (W, B, cfg.num_patch_tokens, cfg.d_model), dtype=np.float32)
    data = {k: np.ascontiguousarray(v[..., :S]) for k, v in streams.items()}
    data["patch_embeds"] = patches
    heldout = {k: v[..., S:].reshape(W * B, S) for k, v in streams.items()}
    heldout["patch_embeds"] = patches.reshape((W * B,) + patches.shape[2:])
    return data, heldout


def _plain_stats(upd):
    """K1's plain version on the card's pack, in column slices of
    VLM_ROUND_COLS (its f32 upcast of the whole pack would not fit beside
    the round): (dot, sq_u, sq_c), each a sum over the slices."""
    from repro_torch.kernels import trust_score
    out = None
    for a in range(0, upd.shape[1], VLM_ROUND_COLS):
        part = trust_score.trust_score_ref(upd[:, a:a + VLM_ROUND_COLS])
        out = part if out is None else tuple(x + y for x, y in
                                             zip(out, part))
    return out


def _vlm_round_checks(fed, scores, upd, loss_before, loss_after):
    """After a round: K1 launched again over the captured pack against its
    plain version (RTOL of the largest plain value, at least 1, as
    ``_kernel_row``), the scores that the plain statistics give, and the
    share of each worker's update that bf16 did not round away."""
    from repro_torch.core import trust
    from repro_torch.kernels import trust_score
    got = trust_score.trust_score_stats(upd)
    want = _plain_stats(upd)
    errs = [float((g - e).abs().max()) for g, e in zip(got, want)]
    tops = [float(e.abs().max()) for e in want]
    check(all(d <= RTOL * max(1.0, t) for d, t in zip(errs, tops)),
          f"vlm_round: K1 against its plain version {errs} of {tops}")
    plain = trust.scores_from_stats(trust.TrustStats(
        *want, loss_before - loss_after), fed).cpu().numpy()
    nonzero = [int(torch.count_nonzero(upd[w])) / upd.shape[1]
               for w in range(upd.shape[0])]
    return {"k1_errs": errs, "k1_plain_max": tops,
            "plain_scores": plain.tolist(),
            "score_diff": float(np.abs(plain - scores).max()),
            "sq_u": want[1].tolist(),
            "nonzero_share": nonzero}


def _vlm_rounds(cfg, tc, async_mode, rounds, key=None, keep_first=False,
                keep_last=False):
    """``rounds`` rounds of SDFLBProtocol (no chain) over the VLM round on
    the card: each round's wall and tokens/s (patches and text), exactly
    K1 with K2 (sync) or K3 (async) and no other kernel, finite scores
    and losses, ``_vlm_round_checks``; async, each round's new pending
    buffer against K3's plain version on the captured pack and the
    pending buffer the round read, bit for bit. Round 0's step is kept for
    the dry run as ``key``, where given. The held-out loss before (the
    seeded init) and after must not rise. Returns (the record, with
    ``keep_first`` round 0's global params on the card (3.5 GB: the async
    rounds have no room for them), the card's and the plain scores of each
    round, and with ``keep_last`` the last round's captured pack, its
    weights, its losses and in async the pending buffer it read, its mask
    and its new pending buffer)."""
    from repro_torch.core.protocol import SDFLBProtocol
    from repro_torch.kernels import fused_round
    dev = torch.device("cuda")
    fed = _vlm_round_fed(async_mode)
    W = VLM_ROUND["workers"]
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    proto = SDFLBProtocol(cfg, fed, tc, use_blockchain=False, seed=0,
                          device=dev)
    rec = {"init_s": time.monotonic() - t0, "round_wall_s": [],
           "tokens_per_s": [], "launches": [], "mean_loss": [],
           "scores": [], "weights": [], "checks": []}
    _, heldout = _vlm_round_data(cfg, 0)
    before = _heldout_loss(cfg, proto.global_params, heldout, dev)
    tokens = W * VLM_ROUND["batch"] * (cfg.num_patch_tokens
                                       + VLM_ROUND["text"])
    first, card, plain, last = None, [], [], None
    for r in range(rounds):
        data, _ = _vlm_round_data(cfg, r)
        part = (np.array(VLM_ROUND_MASKS[r], np.int32) if async_mode
                else None)
        task = proto.task
        read = task.async_state.pending if async_mode else None
        reset_counts()
        if r == 0:
            step = _step_begin([task.global_params, task.opt_state]
                               + ([task.async_state] if async_mode else []))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out, (upd, lb, la) = _capture_flat(proto.run_round, data, part)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        if r == 0:
            window_max = _step_end(key, step) if key else max(
                step["max_before"], torch.cuda.max_memory_allocated())
        counts = read_counts()
        _expect(f"vlm_round {key} round {r}", counts,
                _trust_launches(0, 1) if async_mode
                else _trust_launches(1, 0))
        check(np.isfinite(out.scores).all() and np.isfinite(out.losses).all(),
              f"vlm_round: scores {out.scores}, losses {out.losses}")
        checks = _vlm_round_checks(fed, out.scores, upd, lb, la)
        check(all(x > 0 for x in checks["nonzero_share"]),
              f"vlm_round: an update rounded to zero: {checks}")
        if async_mode:
            new = task.async_state.pending
            keep = 1.0 - torch.from_numpy(part).to(dev).float()
            w = torch.from_numpy(np.asarray(out.weights, np.float32)).to(dev)
            same = all(torch.equal(new[:, a:a + VLM_ROUND_COLS],
                                   fused_round.fused_async_agg_ref(
                                       upd[:, a:a + VLM_ROUND_COLS],
                                       read[:, a:a + VLM_ROUND_COLS], w,
                                       keep)[1])
                       for a in range(0, upd.shape[1], VLM_ROUND_COLS))
            check(same, f"vlm_round: round {r}'s new pending buffer is not "
                  f"K3's plain version's")
            checks["pending_equal_plain"] = same
            checks["pending_rows_nonzero"] = [
                bool(new[i].any()) for i in range(W)]
        rec["round_wall_s"].append(wall)
        rec["tokens_per_s"].append(tokens / wall)
        rec["launches"].append(counts)
        rec["mean_loss"].append(float(np.mean(out.losses)))
        rec["scores"].append(np.asarray(out.scores).tolist())
        rec["weights"].append(np.asarray(out.weights).tolist())
        rec["checks"].append(checks)
        card.append(np.asarray(out.scores, np.float64))
        plain.append(np.asarray(checks["plain_scores"], np.float64))
        if keep_first and r == 0:
            first = {k: v.clone() for k, v in proto.global_params.items()}
        if keep_last and r == rounds - 1:
            w = torch.from_numpy(np.asarray(out.weights, np.float32)).to(dev)
            last = (upd, w, lb, la)
            if async_mode:
                last += (read, keep, new)
        del upd, lb, la, read
    rec["round0_max_memory_allocated"] = window_max
    rec["max_memory_allocated"] = max(window_max,
                                      torch.cuda.max_memory_allocated())
    after = _heldout_loss(cfg, proto.global_params, heldout, dev)
    rec["heldout_loss"] = [before, after]
    rec["heldout_loss_fell"] = after < before
    check(all(torch.isfinite(v).all() for v in proto.global_params.values()))
    check(after <= before, f"vlm_round: held-out loss {before} -> {after}")
    proto.finalize()
    del proto, task
    _release()
    return rec, first, card, plain, last


@contextlib.contextmanager
def _expandable_segments():
    """The caching allocator with expandable segments while the block
    runs (cached blocks released before and after). The async VLM round
    peaks at ~81 GB of the card's 85.0: with fixed segments, blocks split
    off the round's 14 GB pending buffers left ~4 GiB reserved but
    unusable for its 2 GiB f32 leaves, and it ran out of memory (NVIDIA
    H100 80GB HBM3, PERF.md section 6); expandable segments map the pages
    of freed blocks where the next block needs them."""
    set_settings = getattr(torch._C, "_accelerator_setAllocatorSettings",
                           None) or torch.cuda.memory._set_allocator_settings
    _release()
    set_settings("expandable_segments:True")
    try:
        yield
    finally:
        _release()
        set_settings("expandable_segments:False")


def phase_vlm_round(name):
    """chameleon-34b federated on the card: full width cut to one layer
    (D = 1,765,826,560), W = 2 (``VLM_ROUND``), SDFLBProtocol as
    launch/train.py builds it without the chain, the TrainConfig that
    ``specs.train_config_for`` gives the full config (SGD with bf16
    momentum), the flat pack (``_vlm_rounds``): 3 sync rounds, a same-seed
    rerun of the first (global params and scores bit for bit), 2 async
    rounds (``VLM_ROUND_MASKS``). Starts with at most VLM_HELD_MAX held.
    Then, from the last sync round's pack, K1 (against its plain version
    and the per-leaf statistics, ``_stats_check``) and K2, and from the
    last async round's, K3 (checked in column slices; its new pending also
    against the round's), each timed beside its bound (``_kernel_row``);
    the settlement decisions from the card's scores against those from the
    plain statistics' (``_settle_decisions``). Returns the rounds'
    launches."""
    from repro_torch.kernels import fused_round, pack, trust_agg, \
        trust_score
    before, held = _held_after_release()
    free, total = torch.cuda.mem_get_info()
    cfg, tc = _vlm_round_setup()
    W = VLM_ROUND["workers"]
    out = {"phase": "vlm_round", "arch": VLM, "cuts": VLM_CUTS, **VLM_ROUND,
           "patch_tokens": cfg.num_patch_tokens, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "train_config": dataclasses.asdict(tc),
           "fused_trust_path": "on", "chain": False,
           "async_masks": VLM_ROUND_MASKS,
           "memory_before_release": before, "memory_held_at_start": held,
           "device_free_at_start": free, "device_total": total}
    check(held <= VLM_HELD_MAX, f"vlm_round: {held} B still allocated")
    check(tc.optimizer == "sgd" and tc.opt_dtype == "bfloat16",
          f"vlm_round: {tc}")
    bw, f32_peak = peaks(name)

    out["sync"], first, card_s, plain_s, last = _vlm_rounds(
        cfg, tc, False, VLM_ROUND["sync_rounds"], "vlm_round_sync",
        keep_first=True, keep_last=True)
    upd, w, lb, la = last
    D = upd.shape[1]
    check(D == VLM_ROUND_D, f"vlm_round: D = {D}")
    spec = pack.pack_spec(first)
    out["D"] = D
    out["param_bytes"] = D * upd.element_size()
    out["stats"] = _stats_check(upd, spec, la)
    kernels = {"trust_score": _kernel_row(
        "trust_score", trust_score.trust_score_stats,
        trust_score.trust_score_ref, (upd,),
        trust_score.hbm_bytes(W, D, 2)["minimum"],
        trust_score.flops(W, D), bw, f32_peak, reps=VLM_ROUND_REPS)}
    kernels["trust_score"]["plan"] = trust_score.plan(W, D, 2)._asdict()
    kernels["trust_agg"] = _kernel_row(
        "trust_agg", trust_agg.trust_agg, trust_agg.trust_agg_ref, (upd, w),
        trust_agg.hbm_bytes(W, D, 2)["minimum"], trust_agg.flops(W, D), bw,
        f32_peak, library=lambda u, w: torch.mv(u.t(), w.to(u.dtype)),
        reps=VLM_ROUND_REPS)
    kernels["trust_agg"]["plan"] = trust_agg.plan(W, D, 2)._asdict()
    del upd, w, lb, la, last
    _release()

    # a same-seed rerun of the first sync round
    out["rerun"], again, *_ = _vlm_rounds(cfg, tc, False, 1,
                                          keep_first=True)
    identical = all(torch.equal(first[k], again[k]) for k in first) and \
        out["rerun"]["scores"][0] == out["sync"]["scores"][0]
    check(identical, "vlm_round: same-seed rounds differ")
    out["rerun"]["identical_params_and_scores"] = identical
    del first, again
    _release()

    with _expandable_segments():
        out["async"], _, card_a, plain_a, last = _vlm_rounds(
            cfg, tc, True, VLM_ROUND["async_rounds"], "vlm_round_async",
            keep_last=True)
        out["async"]["expandable_segments"] = any(
            seg.get("is_expandable") for seg in torch.cuda.memory_snapshot())
        upd, w, lb, la, read, keep, new = last
        del last
        got = fused_round.fused_async_agg(upd, read, w, keep)
        out["async"]["k3_new_pending_equals_round"] = torch.equal(got[1],
                                                                  new)
        check(out["async"]["k3_new_pending_equals_round"],
              "vlm_round: K3 again gives another new pending buffer")
        del got, new
        _release()
        kernels["fused_async_agg"] = _kernel_row(
            "fused_async_agg", fused_round.fused_async_agg,
            fused_round.fused_async_agg_ref, (upd, read, w, keep),
            fused_round.hbm_bytes(W, D, 2)["minimum"],
            fused_round.flops(W, D), bw, f32_peak, floor=0.0,
            cols=VLM_ROUND_COLS, reps=VLM_ROUND_REPS)
        kernels["fused_async_agg"]["plan"] = fused_round.plan(
            W, D, 2)._asdict()
        del upd, w, lb, la, read, keep
    out["kernels_at_vlm_shape"] = kernels

    decisions = {}
    for mode, card, plain in (("sync", card_s, plain_s),
                              ("async", card_a, plain_a)):
        fed = _vlm_round_fed(mode == "async")
        a, b = (_settle_decisions(fed, card, W),
                _settle_decisions(fed, plain, W))
        # how far the card's scores lie from the threshold, beside how far
        # they lie from the plain statistics' scores
        decisions[mode] = {
            "equal": a == b, "card": a,
            "threshold_margin": float(np.abs(np.array(card)
                                             - fed.trust_threshold).min()),
            "score_diff": float(np.abs(np.array(card)
                                       - np.array(plain)).max())}
        check(a == b, f"vlm_round {mode}: decisions {a} against {b}")
    out["decisions"] = decisions
    out["launches"] = {k: sum(c[k] for run in ("sync", "rerun", "async")
                              for c in out[run]["launches"])
                       for k in counters()}
    emit(out)
    return out["launches"]


# -- the dry run held against the card -----------------------------------

# a predicted peak (the trace's, plus what the card held beside the step's
# arguments) against the measured one: within the larger of these
DRYRUN_PEAK_REL = 0.05
DRYRUN_PEAK_ABS = 0.5 * 2**30
DRYRUN_WAIT_S = 900              # the background traces' limit at the phase
DRYRUN_STEPS = {}                # the measured steps the dry run re-traces


def _storage_bytes(tree):
    """The device bytes of the tensors in ``tree`` (dicts, lists, tuples),
    each storage once, in the caching allocator's 512-byte blocks."""
    from repro_torch.launch import dryrun
    seen = {}
    for t in dryrun._tensors(tree, []):
        s = t.untyped_storage()
        seen[s.data_ptr()] = -(-s.nbytes() // dryrun.BLOCK) * dryrun.BLOCK
    return sum(seen.values())


def _step_begin(args):
    """Before a step that the ``dryrun`` phase re-traces: the bytes
    allocated, those of the step's arguments ``args``, and the peak so far;
    then the peak counter restarts."""
    torch.cuda.synchronize()
    rec = {"allocated_before": torch.cuda.memory_allocated(),
           "args_bytes": _storage_bytes(args),
           "max_before": torch.cuda.max_memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    rec["t0"] = time.monotonic()
    return rec


def _step_end(key, rec):
    """After the step: its wall and its peak, kept as ``DRYRUN_STEPS[key]``
    (the first time). Returns the peak of the window before the step and
    the step together, the figure the phase's own peak keeps reading."""
    torch.cuda.synchronize()
    rec["wall_s"] = time.monotonic() - rec.pop("t0")
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    DRYRUN_STEPS.setdefault(key, rec)
    return max(rec["max_before"], rec["max_memory_allocated"])


def dryrun_setups():
    """The steps earlier phases measured, as ``dryrun.run_one`` re-traces
    them: {key: (arch, registry shape, setup_override)}. ``vlm_serve``'s
    chameleon-34b prefill and warm decode (batch 4, 256 patches and a
    1792-token prompt, 2080 cache slots), ``llm_round``'s flat-pack sync
    and async rounds (smollm-135m, W = 8: K1 with K2, K1 with K3), the
    first sync round of ``moe_round`` (olmoe-1b-7b, one layer) and of
    ``xlstm_round`` (xlstm-1.3b, one super-layer: K4's wide path and its
    backward), and the first sync and async rounds of ``vlm_round``
    (chameleon-34b, one layer, W = 2, SGD with bf16 momentum, the flat
    pack; the patches f32, as the protocol takes them from numpy)."""
    from repro_torch.configs.base import FederationConfig, ShapeConfig, \
        TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import specs
    B, P, G = VLM_SERVE["batch"], VLM_SERVE["prompt_len"], VLM_SERVE["gen"]
    vlm = get_config(VLM)
    Pt = vlm.num_patch_tokens
    tc = TrainConfig(optimizer="adamw", lr=3e-4, remat=True, grad_clip=1.0)

    def round_setup(arch, cfg, fed, shape, tc=tc):
        return (arch, "train_4k", lambda a, s, mesh, _, **kw:
                specs.train_setup(a, s, mesh, fed, cfg=cfg, tc=tc,
                                  shape=shape))

    vcfg, vtc = _vlm_round_setup()
    vshape = ShapeConfig("vlm_round", Pt + VLM_ROUND["text"],
                         VLM_ROUND["workers"] * VLM_ROUND["batch"], "train")

    def vlm_round_setup(async_mode):
        def setup(a, s, mesh, _, **kw):
            step = specs.train_setup(a, s, mesh, _vlm_round_fed(async_mode),
                                     cfg=vcfg, tc=vtc, shape=vshape)
            batch = dict(step.args[2])
            batch["patch_embeds"] = torch.empty(
                batch["patch_embeds"].shape, dtype=torch.float32,
                device=specs.DEVICE)
            return step._replace(args=step.args[:2] + (batch,)
                                 + step.args[3:])
        return VLM, "train_4k", setup

    def llm_fed(async_mode):
        return FederationConfig(num_clusters=2, workers_per_cluster=4,
                                async_mode=async_mode, trust_threshold=0.3,
                                mode="allreduce", fused_trust_path="on")
    zfed = FederationConfig(num_clusters=ZROUND["clusters"],
                            workers_per_cluster=ZROUND["workers"]
                            // ZROUND["clusters"], trust_threshold=0.3,
                            mode="allreduce")
    zshape = ShapeConfig("round", ZROUND["seq"],
                         ZROUND["workers"] * ZROUND["batch"], "train")
    llm_shape = ShapeConfig("llm_round", 128, 8 * 32, "train")
    return {
        "vlm_prefill": (VLM, "prefill_32k", lambda a, s, mesh, _, **kw:
                        specs.prefill_setup(
                            a, s, mesh, cfg=vlm, cache_len=Pt + P + G,
                            shape=ShapeConfig("vlm_prefill", Pt + P, B,
                                              "prefill"))),
        "vlm_decode": (VLM, "decode_32k", lambda a, s, mesh, _, **kw:
                       specs.decode_setup(
                           a, s, mesh, cfg=vlm, cur_index=Pt + P,
                           shape=ShapeConfig("vlm_decode", Pt + P + G, B,
                                             "decode"))),
        "llm_flat_sync": round_setup(LLM, get_config(LLM), llm_fed(False),
                                     llm_shape),
        "llm_flat_async": round_setup(LLM, get_config(LLM), llm_fed(True),
                                      llm_shape),
        "moe_round_sync": round_setup(
            MOE_ROUND_ARCH,
            get_config(MOE_ROUND_ARCH).replace(**MOE_ROUND_CUTS), zfed,
            zshape),
        "xlstm_round_sync": round_setup(
            XLSTM, get_config(XLSTM).replace(**XPARITY_CUTS), zfed, zshape),
        "vlm_round_sync": vlm_round_setup(False),
        "vlm_round_async": vlm_round_setup(True),
    }


def dryrun_traces(path):
    """``chip_smoke.py --dryrun-traces PATH``: each of ``dryrun_setups``
    traced once (``dryrun.run_one``), the results written to PATH as they
    come. ``_start_dryrun_traces`` runs it in a process of its own with the
    card hidden, so its fake tensors lie on the meta device, which stands in
    for the card as it does on a host without one."""
    from repro_torch.launch import dryrun
    t0 = time.monotonic()
    out = {}
    for key, (arch, shape, setup) in dryrun_setups().items():
        out[key] = dryrun.run_one(arch, shape, setup_override=setup)
        out[key]["done_after_s"] = time.monotonic() - t0
        with open(path, "w") as f:
            json.dump(out, f)
    return 0


def _start_dryrun_traces():
    """Start ``dryrun_traces`` in the background at the lowest CPU
    priority (the traces take minutes of one core on the host, the card
    none), while the earlier phases run. Returns (process, results
    path); the process is stopped at exit if it still runs."""
    import atexit
    path = os.path.join(ROOT, "build", f"dryrun_traces-{os.getpid()}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dryrun-traces", path],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        preexec_fn=lambda: os.nice(19))

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    atexit.register(stop)
    return proc, path


def _shapes(out):
    """(shape, dtype, strides) of each output (None stays None)."""
    outs = out if isinstance(out, tuple) else (out,)
    return [None if x is None else
            (tuple(x.shape), str(x.dtype), tuple(x.stride())) for x in outs]


def _abstract_cases():
    """One call of each kernel case the kernel phases time, on the card's
    inputs: {name: (wrapper, real inputs)}."""
    from repro_torch.kernels import fused_round, ssd_scan, swa_decode, \
        trust_agg, trust_score
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    W, dt = MAIN_SHAPE[0], getattr(torch, MAIN_SHAPE[1])

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    u, w = rnd(W, D_PAPER, dtype=dt), rnd(W).abs()
    sw = SWA_SHAPE
    q = rnd(sw["B"], sw["H"], sw["hd"], dtype=torch.bfloat16)
    kc = rnd(sw["B"], SWA_S, sw["KV"], sw["hd"], dtype=torch.bfloat16)

    def k4(shape, dtype, per_head):
        B, S, H, dk, dv = (shape[k] for k in ("B", "S", "H", "dk", "dv"))
        if per_head:
            qk = [rnd(B, S, H, dk, dtype=dtype) for _ in range(2)]
        else:        # Mamba2's B and C: one row for every head
            qk = [rnd(B, S, 1, dk, dtype=dtype).expand(B, S, H, dk)
                  for _ in range(2)]
        return qk + [rnd(B, S, H, dv, dtype=dtype), -rnd(B, S, H).abs(),
                     rnd(B, S, H).abs()]

    def bwd(shape, dtype, per_head, wide):
        q, k, v, a, i = k4(shape, dtype, per_head)
        c = shape["chunk"]
        with torch.no_grad():
            y, h, states = ssd_scan._launch_fwd(q, k, v, a, i, None, c, True)
        dy = torch.randn_like(y)
        return (lambda *x: ssd_scan.ssd_scan_bwd(
            *x[:6], chunk=c, states=x[6], want_dh0=not wide),
            [q, k, v, a, i, dy, states])
    narrow, wide = SSD_SERVE, SSD_WIDE_SERVE
    return {
        "trust_score": (trust_score.trust_score_stats, [u]),
        "trust_agg": (trust_agg.trust_agg, [u, w]),
        "fused_async_agg": (fused_round.fused_async_agg,
                            [u, rnd(W, D_PAPER), w, (w > 0.5).float()]),
        "swa_decode": (lambda *x: swa_decode.swa_decode(
            *x, SWA_MAIN_CUR, SWA_WINDOW), [q, kc, torch.randn_like(kc)]),
        "ssd_scan": (lambda *x: ssd_scan._launch_fwd(
            *x, None, narrow["chunk"], True),
            k4(narrow, torch.bfloat16, False)),
        "ssd_scan_wide": (lambda *x: ssd_scan._launch_fwd(
            *x, None, wide["chunk"], False), k4(wide, torch.float32, True)),
        "ssd_scan_bwd": bwd(SSD_TRAIN, torch.bfloat16, False, False),
        "ssd_scan_bwd_wide": bwd(SSD_WIDE_TRAIN, torch.float32, True, True),
    }


def _abstract_checks():
    """Each kernel case on the card's tensors and on fake copies of them:
    the abstract branch's outputs have the real launch's shapes, dtypes and
    strides, and the fake calls launch nothing; the wide path's scratch
    layouts in Python equal the library's own count."""
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch import specs
    rows = {}
    for key, (fn, args) in _abstract_cases().items():
        with torch.no_grad():
            real = _shapes(fn(*args))
        torch.cuda.synchronize()
        before = read_counts()
        mode = specs.new_fake_mode()
        with mode, torch.no_grad():
            fake = _shapes(fn(*[mode.from_tensor(x) for x in args]))
        moved = read_counts() != before
        rows[key] = {"outputs": real, "abstract_equal": fake == real,
                     "counters_moved": moved}
        check(fake == real and not moved,
              f"dryrun: {key}'s abstract branch {fake} != launch {real}"
              f" or a counter moved")
        del args
    w, t = SSD_WIDE_SERVE, SSD_WIDE_TRAIN
    dims = lambda d: (d["B"], d["S"], d["H"], d["dk"], d["dv"], d["chunk"])
    layouts = {
        "wide_fwd": (ssd_scan.wide_scratch_layout_bytes(*dims(w)),
                     ssd_scan.wide_scratch_bytes(*dims(w)))}
    for h0 in (False, True):
        for dhf in (False, True):
            layouts[f"wide_bwd_h0_{h0}_dhf_{dhf}"] = (
                ssd_scan.wide_bwd_scratch_layout_bytes(
                    *dims(t), initial_state=h0, dh_final=dhf),
                ssd_scan.wide_bwd_scratch_bytes(
                    *dims(t), initial_state=h0, dh_final=dhf))
    check(all(a == b for a, b in layouts.values()),
          f"dryrun: scratch layouts {layouts}")
    return rows, layouts


def phase_dryrun(name, child):
    """The dry run held against the card. ``HBM_BYTES`` within 1 % of the
    card's total memory; each kernel case's abstract branch against its
    launch (``_abstract_checks``); the background traces of
    ``dryrun_setups`` (meta stand-in), two of them traced again here on
    fake CUDA tensors with equal counts; each predicted peak, plus what the
    card held beside the step's arguments before it, within
    max(DRYRUN_PEAK_REL, DRYRUN_PEAK_ABS) of the step's measured
    ``max_memory_allocated``, and each measured wall at least
    max(compute_s, memory_s) of its trace."""
    from repro_torch.launch import dryrun, mesh
    smi_line = smi("name,power.limit")
    total = torch.cuda.get_device_properties(0).total_memory
    out = {"phase": "dryrun", "card": smi_line,
           "hbm_bytes": mesh.HBM_BYTES, "total_memory": total,
           "peak_tol": {"rel": DRYRUN_PEAK_REL, "abs": DRYRUN_PEAK_ABS}}
    check(abs(mesh.HBM_BYTES - total) <= 0.01 * total,
          f"dryrun: HBM_BYTES {mesh.HBM_BYTES} against {total}")
    out["abstract"], out["scratch_layouts"] = _abstract_checks()
    proc, path = child
    t0 = time.monotonic()
    try:
        text, _ = proc.communicate(timeout=DRYRUN_WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        text, _ = proc.communicate()
        raise AssertionError(f"dryrun: the background traces ran past "
                             f"{DRYRUN_WAIT_S} s at the phase:\n{text}")
    out["waited_for_traces_s"] = time.monotonic() - t0
    check(proc.returncode == 0, f"dryrun: traces failed:\n{text}")
    with open(path) as f:
        traces = json.load(f)
    out["traces_wall_s"] = max(r["done_after_s"] for r in traces.values())
    setups = dryrun_setups()
    check(set(traces) == set(setups), f"dryrun: traced {sorted(traces)}")
    # the meta stand-in against fake CUDA tensors, on two setups
    same = {}
    for key in ("vlm_decode", "moe_round_sync"):
        arch, shape, setup = setups[key]
        cuda = dryrun.run_one(arch, shape, setup_override=setup)
        fields = ("flops_bf16", "flops_f32", "bytes_per_device",
                  "peak_bytes", "args_bytes", "kernels")
        same[key] = {k: [cuda[k], traces[key][k]] for k in fields}
        check(all(cuda[k] == traces[key][k] for k in fields),
              f"dryrun: {key} on fake CUDA tensors {same[key]}")
    out["cuda_equals_meta"] = same
    steps = {}
    for key, r in traces.items():
        m = DRYRUN_STEPS[key]
        held = m["allocated_before"] - m["args_bytes"]
        predicted = r["peak_bytes"] + held
        measured = m["max_memory_allocated"]
        tol = (VLM_ROUND_PEAK_TOL if key.startswith("vlm_round") else
               max(DRYRUN_PEAK_REL * measured, DRYRUN_PEAK_ABS))
        bound = max(r["compute_s"], r["memory_s"])
        steps[key] = {
            "predicted_peak": predicted, "measured_peak": measured,
            "gap": predicted - measured,
            "gap_share": (predicted - measured) / measured, "tol": tol,
            "trace_peak": r["peak_bytes"], "trace_args": r["args_bytes"],
            "card_args": m["args_bytes"], "held_beside_args": held,
            "wall_s": m["wall_s"], "compute_s": r["compute_s"],
            "memory_s": r["memory_s"], "dominant": r["dominant"],
            "wall_over_bound": m["wall_s"] / bound,
            "flops_bf16": r["flops_bf16"], "flops_f32": r["flops_f32"],
            "bytes": r["bytes_per_device"], "kernels": r["kernels"],
            "aten_calls": r["aten_calls"], "lower_s": r["lower_s"]}
    out["steps"] = steps
    emit(out)
    bad = {k: v for k, v in steps.items()
           if abs(v["gap"]) > v["tol"] or v["wall_over_bound"] < 1}
    check(not bad, f"dryrun: peaks or walls off: {bad}")


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
    dry_child = _start_dryrun_traces()
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
    ssd_row, ssd_wide_row = run("ssd_kernel", phase_ssd_kernel, name)
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
    run("xlstm_parity", phase_xlstm_parity)
    xlstm_counts = run("xlstm_serve", phase_xlstm_serve, name)
    wide_bwd_row = run("ssd_wide_bwd_kernel", phase_ssd_wide_bwd_kernel,
                       name)
    run("xlstm_grad_parity", phase_xlstm_grad_parity)
    xround_counts = run("xlstm_round", phase_xlstm_round, name)
    run("mla_serve", phase_mla_serve, name)
    run("mla_round", phase_mla_round, name)
    run("whisper_serve", phase_whisper_serve, name)
    run("whisper_round", phase_whisper_round, name)
    run("vlm_serve", phase_vlm_serve, name)
    new_paths.append(run("vlm_round", phase_vlm_round, name))
    run("dryrun", phase_dryrun, name, dry_child)
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
    if xlstm_counts["ssd_scan"] < 1:
        raise AssertionError("ssd_scan never launched on the xlstm serve "
                             "path")
    if xround_counts["ssd_scan_bwd"] < 1:
        raise AssertionError("ssd_scan_bwd never launched on the xlstm "
                             "round path")
    # K4's calls on its paths: zamba2's serve and round (the narrow
    # kernel) and xlstm's serve and round (the wide path, three launches a
    # call); the top-level numbers are the narrow kernel's at zamba2's
    # prefill, the wide path's at xlstm-1.3b's prefill under "wide"
    summary.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:29",
        "launches": (zamba_counts["ssd_scan"] + round_counts["ssd_scan"]
                     + xlstm_counts["ssd_scan"] + xround_counts["ssd_scan"]),
        "max_abs_err": ssd_row["max_abs_err"], "ms": ssd_row["ms"],
        "plain_ms": ssd_row["plain_ms"], "bound_ms": ssd_row["bound_ms"],
        "bound_by": ssd_row["bound_by"], "library_ms": ssd_row["library_ms"],
        "shape": {k: ssd_row[k] for k in ("B", "S", "H", "dk", "dv", "chunk",
                                           "gates", "dtype")},
        "wide": {
            "source": "src/repro_torch/csrc/ssd_scan_wide.cu",
            "design": ssd_wide_row["design"],
            "launches": xlstm_counts["ssd_scan"] + xround_counts["ssd_scan"],
            "launches_per_call": ssd_wide_row["launches_per_call"],
            **{k: ssd_wide_row[k] for k in (
                "max_abs_err", "ms", "ms_f32_values", "plain_ms",
                "bound_ms", "bound_by", "f32_core_bound_ms", "library_ms")},
            "shape": {k: ssd_wide_row[k] for k in (
                "B", "S", "H", "dk", "dv", "chunk", "gates", "dtype")}}})
    # K4's backward: no TPU kernel; the reference takes the VJP of its jnp
    # scan under autodiff. Its calls on zamba2's round (the narrow kernel)
    # and xlstm's (the wide backward, three launches a call); the top-level
    # numbers are the narrow kernel's at zamba2's training shape, the wide
    # backward's at xlstm-1.3b's under "wide"
    summary.append({
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/models/ssm.py:45",
        "launches": (round_counts["ssd_scan_bwd"]
                     + xround_counts["ssd_scan_bwd"]),
        "max_abs_err": ssd_bwd_row["max_abs_err"], "ms": ssd_bwd_row["ms"],
        "plain_ms": ssd_bwd_row["plain_ms"],
        "bound_ms": ssd_bwd_row["bound_ms"],
        "bound_by": ssd_bwd_row["bound_by"],
        "library_ms": ssd_bwd_row["library_ms"],
        "shape": {k: ssd_bwd_row[k] for k in ("B", "S", "H", "dk", "dv",
                                               "chunk", "gates", "dtype")},
        "wide": {
            "source": "src/repro_torch/csrc/ssd_scan_wide_bwd.cu",
            "design": wide_bwd_row["design"],
            "launches": xround_counts["ssd_scan_bwd"],
            **{k: wide_bwd_row[k] for k in (
                "launches_per_call", "max_abs_err", "ms", "ms_f32_values",
                "ms_with_dh0", "plain_ms", "bound_ms", "bound_by",
                "f32_core_bound_ms", "library_ms")},
            "shape": {k: wide_bwd_row[k] for k in (
                "B", "S", "H", "dk", "dv", "chunk", "gates", "dtype")}}})
    emit({"phase": "total", "wall_s": time.monotonic() - t_start,
          "phase_wall_s": walls})
    print(smi_line, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def control_main(fault):
    """``chip_smoke.py --xlstm-grad-control FAULT``: xlstm_grad_parity as
    the smoke runs it, then again with K4 replaced on the card by its plain
    version planting FAULT (one of ``ssd_scan.FAULTS``), which the phase
    must reject. Exits 0 when the first passes and the second fails."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  fails where the checkout lacks src/
    phase_device()
    phase_build()
    phase_xlstm_grad_parity()
    try:
        phase_xlstm_grad_parity(fault)
    except AssertionError:
        emit({"control": fault, "rejected": True})
        return 0
    emit({"control": fault, "rejected": False})
    return 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--xlstm-grad-control"]:
        sys.exit(control_main(sys.argv[2]))
    if sys.argv[1:2] == ["--dryrun-traces"]:
        sys.exit(dryrun_traces(sys.argv[2]))
    sys.exit(main())
