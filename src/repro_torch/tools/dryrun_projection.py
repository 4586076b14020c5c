"""Project a dry-run round too long to trace (xlstm-1.3b's train_4k: the
sLSTM loop runs on the host, position by position, in every worker's
forward, its recomputation and its backward) from shorter traces of the
same round.

A round of W workers takes each worker's step in turn, the same ATen
calls for each, then aggregates, and the aggregation does not depend on
the sequence S. So every count c of the round (ATen calls, FLOPs by
dtype, bytes) grows from a short S0 to S by W times one worker's growth:

    c(W, S) = c(W, S0) + W · (c(1, S) − c(1, S0)).

The tool traces the round at the shape's W (the default federation) at
S0, and one worker (one cluster) at S0 and at S. ``lower_s`` is the
projected calls times the seconds a call of the (1, S) trace took. The
peak is projected as peak(W, S0) + (peak(1, S) − peak(1, S0)): one
worker's activations grown from S0 to S on top of the W-worker round's
peak at S0, exact where that peak falls inside a worker's step and an
upper bound where it falls in the aggregation. Each measured trace is
printed beside the projection.

Usage:
  PYTHONPATH=src python -m repro_torch.tools.dryrun_projection \\
      --arch xlstm-1.3b --shape train_4k [--short-seq 512] [--json out.json]
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs.base import FederationConfig, INPUT_SHAPES, \
    ShapeConfig
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.core import fl_step
from repro_torch.launch import dryrun, mesh as meshlib, specs

COUNTS = ("aten_calls", "flops_bf16", "flops_f32", "bytes_per_device")


def trace(arch: str, shape_name: str, seq: int, workers: int = None
          ) -> dict:
    """The round at ``seq`` with the shape's per-worker batch: the default
    federation's W workers, or ``workers`` in one cluster."""
    sh = INPUT_SHAPES[shape_name]
    fed = FederationConfig()
    per_worker = sh.global_batch // fl_step.num_workers(fed)
    if workers is not None:
        fed = FederationConfig(num_clusters=1, workers_per_cluster=workers)
    W = fl_step.num_workers(fed)

    def setup(a, s, mesh, _, **kw):
        return specs.train_setup(a, s, mesh, fed, shape=ShapeConfig(
            sh.name, seq, W * per_worker, "train"))
    r = dryrun.run_one(arch, shape_name, setup_override=setup)
    return {k: r[k] for k in COUNTS + ("peak_bytes", "lower_s")}


def project(arch: str, shape_name: str, short_seq: int) -> dict:
    sh = INPUT_SHAPES[shape_name]
    if sh.kind != "train":
        raise ValueError(f"{shape_name}: only a train round has workers")
    W = fl_step.num_workers(FederationConfig())
    one_short = trace(arch, shape_name, short_seq, workers=1)
    all_short = trace(arch, shape_name, short_seq)
    one = trace(arch, shape_name, sh.seq_len, workers=1)
    out = {k: all_short[k] + W * (one[k] - one_short[k]) for k in COUNTS}
    out["peak_bytes"] = all_short["peak_bytes"] + max(
        0, one["peak_bytes"] - one_short["peak_bytes"])
    out["lower_s"] = out["aten_calls"] * one["lower_s"] / one["aten_calls"]
    out["compute_s"] = out["flops_bf16"] / meshlib.PEAK_FLOPS_BF16 + \
        out["flops_f32"] / meshlib.PEAK_FLOPS_F32
    out["memory_s"] = out["bytes_per_device"] / meshlib.HBM_BW
    out["fits_one_card"] = out["peak_bytes"] <= meshlib.HBM_BYTES
    mf, n = dryrun.model_flops(arch, shape_name)
    out.update(model_flops=mf, params_active=n, workers=W,
               useful_flops_ratio=mf / (out["flops_bf16"] + out["flops_f32"]))
    return {"arch": arch, "shape": shape_name, "projected": out,
            "traces": {f"W1_S{sh.seq_len}": one, f"W1_S{short_seq}": one_short,
                       f"W{W}_S{short_seq}": all_short}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES), required=True)
    ap.add_argument("--short-seq", type=int, default=512)
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    r = project(args.arch, args.shape, args.short_seq)
    print(json.dumps(r))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(r, f, indent=1)


if __name__ == "__main__":
    main()
