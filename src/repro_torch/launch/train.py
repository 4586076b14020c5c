"""End-to-end SDFL-B training driver of the port (``repro.launch.train``).

Two modes:
  * ``--arch paper-net`` — the paper's own experiment: MNIST-surrogate CNN,
    SGD(lr=0.01, momentum=0.5), N workers in clusters, blockchain on/off.
  * an LLM arch (the dense ``smollm-135m``, ``yi-6b``, ``h2o-danube-1.8b``,
    ``minicpm3-4b`` (MLA), the MoE ``qwen2-moe-a2.7b``, ``olmoe-1b-7b``,
    the hybrid ``zamba2-7b`` or xLSTM's ``xlstm-1.3b``) — federated LM
    training on synthetic token streams, the smoke-size variant by default, the full config with
    ``--full`` (which also turns on rematerialisation per layer, or per
    super-layer for the hybrid and xLSTM, as the reference does).
    whisper-base is not among them, as in the reference, whose token
    streams carry no frames; ``SDFLBProtocol`` federates it given batches
    with ``frames``.

It runs on the card unless ``--device cpu`` is given. The flags and the
printed lines are the reference's, plus ``--device``; ``run(args)`` is the
same run as a function and returns the protocol, the log and the payouts.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-net \\
      --workers 8 --clusters 2 --rounds 50 [--no-blockchain] [--async]
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
      --rounds 5 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs.base import FederationConfig, TrainConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, \
    get_smoke_config
from repro_torch.core import async_sim
from repro_torch.core.protocol import SDFLBProtocol
from repro_torch.data.datasets import make_federated_mnist, synthetic_tokens

# the archs this launcher trains: the LLMs (dense and MoE decoders, the
# hybrid and xLSTM) and the CNN. Not the VLM nor the audio family: their
# batches need the stub frontends' ``patch_embeds`` or ``frames``, which
# ``synthetic_tokens`` does not make, and the reference's launcher (which
# feeds it alone) stops at the loss's ``batch["patch_embeds"]`` there
TRAIN_ARCHS = [a for a in ARCH_IDS if get_config(a).family
               in ("dense", "moe", "hybrid", "ssm")] + ["paper-net"]


def build_protocol(args):
    fed = FederationConfig(
        num_clusters=args.clusters,
        workers_per_cluster=args.workers // args.clusters,
        async_mode=args.async_mode,
        trust_threshold=args.trust_threshold,
        mode="head_gather" if args.head_gather else "allreduce")
    if args.arch == "paper-net":
        cfg = get_config("paper-net")
        tc = TrainConfig(optimizer="sgd", lr=0.01, momentum=0.5, remat=False)
    else:
        cfg = (get_config(args.arch) if args.full
               else get_smoke_config(args.arch))
        tc = TrainConfig(optimizer="adamw", lr=3e-4, remat=args.full,
                         grad_clip=1.0)
    proto = SDFLBProtocol(cfg, fed, tc, use_blockchain=not args.no_blockchain,
                          seed=args.seed, device=args.device)
    return proto, cfg, fed, tc


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-net", choices=TRAIN_ARCHS)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--no-blockchain", action="store_true")
    ap.add_argument("--async", dest="async_mode", action="store_true")
    ap.add_argument("--head-gather", action="store_true")
    ap.add_argument("--trust-threshold", type=float, default=0.3)
    ap.add_argument("--non-iid", type=float, default=0.0)
    ap.add_argument("--full", action="store_true",
                    help="full-size arch config (remat on)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.workers % args.clusters:
        ap.error("--workers must be a multiple of --clusters")
    return args


def run(args) -> dict:
    """The training run of ``args`` (``parse_args``): rounds, periodic
    evaluation lines, ``finalize``. Returns {"proto", "log", "payouts",
    "round_wall_s"} (the host wall of each ``run_round`` call)."""
    proto, cfg, fed, tc = build_protocol(args)
    W = args.workers

    scheduler = None
    if args.async_mode:
        scheduler = async_sim.AsyncScheduler(
            async_sim.heterogeneous_profiles(W, seed=args.seed),
            seed=args.seed, buffer_size=max(2, W // 2))

    if args.arch == "paper-net":
        ds = make_federated_mnist(W, samples=args.samples,
                                  non_iid_alpha=args.non_iid, seed=args.seed)
        eval_batch = ds.eval_batch(512)
        get_batch = lambda: ds.round_batches(args.batch)  # noqa: E731
    else:
        data = synthetic_tokens(W, args.batch, args.seq, cfg.vocab_size,
                                seed=args.seed)
        eval_batch = {k: v[0] for k, v in data.items()}
        get_batch = lambda: synthetic_tokens(  # noqa: E731
            W, args.batch, args.seq, cfg.vocab_size,
            seed=args.seed + len(proto.history))

    log, walls = [], []
    t_start = time.monotonic()
    for r in range(args.rounds):
        part = None
        if scheduler is not None:
            _, mask, _ = scheduler.next_aggregation()
            part = mask
        t = time.monotonic()
        rec = proto.run_round(get_batch(), participation=part)
        walls.append(time.monotonic() - t)
        if (r + 1) % max(1, args.rounds // 10) == 0 or r == args.rounds - 1:
            ev = proto.evaluate(eval_batch)
            entry = {"round": r + 1, **ev,
                     "mean_score": float(np.mean(rec.scores)),
                     "chain_time": rec.chain_time,
                     "wall": time.monotonic() - t_start}
            log.append(entry)
            print(json.dumps(entry))
    payouts = proto.finalize()
    if proto.ledger is not None:
        print(f"ledger: {len(proto.ledger.blocks)} blocks, "
              f"verified={proto.ledger.verify_chain()}, "
              f"ipfs objects={proto.ipfs.puts}")
        print(f"value conservation: {proto.contract.total_value():.2f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"log": log, "payouts": payouts}, f, indent=1)
    return {"proto": proto, "log": log, "payouts": payouts,
            "round_wall_s": walls}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
