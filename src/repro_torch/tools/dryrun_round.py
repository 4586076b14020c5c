"""Size an FL round of any arch on one card with the dry run
(``launch.dryrun.run_one``): the arch at full width cut to ``--layers``,
W workers in ``--clusters`` clusters, each with ``--batch`` sequences of
``--seq`` positions (the VLM's patches among them), the optimizer and its
state's dtype as asked, remat on and the gradient clip at 1.0, as
``chip_smoke.py``'s rounds run; ``--fused-trust-path on`` takes the flat
pack (K1, then K2 or K3), ``--async`` the async round (the participation
mask and the pending buffers among the arguments), ``--smoke`` the arch's
smoke config. One JSON line a combination: the peak,
whether it fits the card, its bytes a parameter a worker beside the
arguments' and the temporaries', the compute and memory bounds, and the
trace's wall.

Usage (chameleon-34b's one-layer round, ROADMAP Queue 1):
  PYTHONPATH=src python -m repro_torch.tools.dryrun_round \\
      --arch chameleon-34b --layers 1 --workers 2 4 --seq 512 --batch 4 \\
      --opt-dtype float32 bfloat16
and its round on the flat pack with the reference's economics for archs of
≳ 20 B parameters (SGD, bf16 state) at W = 2, async:
  PYTHONPATH=src python -m repro_torch.tools.dryrun_round \\
      --arch chameleon-34b --layers 1 --workers 2 --optimizer sgd \\
      --opt-dtype bfloat16 --fused-trust-path on --async
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs.base import FederationConfig, ShapeConfig, \
    TrainConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, \
    get_smoke_config
from repro_torch.launch import dryrun, specs
from repro_torch.models import api


def size_round(arch: str, layers: int, workers: int, clusters: int,
               seq: int, batch: int, optimizer: str, opt_dtype: str,
               fused_trust_path: str = "off", async_mode: bool = False,
               smoke: bool = False) -> dict:
    cfg = (get_smoke_config if smoke else get_config)(arch).replace(
        num_layers=layers)
    fed = FederationConfig(num_clusters=clusters,
                           workers_per_cluster=workers // clusters,
                           trust_threshold=0.3, mode="allreduce",
                           fused_trust_path=fused_trust_path,
                           async_mode=async_mode)
    tc = TrainConfig(optimizer=optimizer, lr=3e-4, remat=True,
                     grad_clip=1.0, opt_dtype=opt_dtype)
    shape = ShapeConfig("round", seq, workers * batch, "train")

    def setup(a, s, mesh, _, **kw):
        return specs.train_setup(a, s, mesh, fed, cfg=cfg, tc=tc,
                                 shape=shape)
    r = dryrun.run_one(arch, "train_4k", setup_override=setup)
    D = api.param_count(specs.init_specs(cfg))
    keep = ("peak_bytes", "args_bytes", "fits_one_card", "compute_s",
            "memory_s", "flops_bf16", "flops_f32", "bytes_per_device",
            "aten_calls", "kernels", "lower_s")
    return {"arch": arch, "smoke": smoke, "layers": layers,
            "workers": workers, "seq": seq, "batch": batch,
            "optimizer": optimizer, "opt_dtype": opt_dtype,
            "fused_trust_path": fused_trust_path, "async": async_mode,
            "D": D, **{k: r[k] for k in keep},
            "bytes_per_param_per_worker": r["peak_bytes"] / (D * workers),
            "args_per_param_per_worker": r["args_bytes"] / (D * workers)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--layers", type=int, required=True)
    ap.add_argument("--workers", type=int, nargs="+", default=[4])
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--optimizer", choices=("adamw", "sgd"),
                    default="adamw")
    ap.add_argument("--opt-dtype", nargs="+", default=["float32"])
    ap.add_argument("--fused-trust-path", choices=("off", "on"),
                    default="off")
    ap.add_argument("--async", dest="async_mode", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    for W in args.workers:
        for dt in args.opt_dtype:
            print(json.dumps(size_round(args.arch, args.layers, W,
                                        min(args.clusters, W), args.seq,
                                        args.batch, args.optimizer, dt,
                                        args.fused_trust_path,
                                        args.async_mode, args.smoke)),
                  flush=True)


if __name__ == "__main__":
    main()
