"""Time K1 (the trust statistics) in several launch plans on one card.

    python -m repro_torch.tools.k1_plans [--reps 30] [--shapes 4096:f32,...]

(from the checkout root with ``PYTHONPATH=src``). At the paper CNN's
D = 21840 and each shape ``W:dtype`` (default: PERF.md §6's W 16, 4096 and
10240 in f32 and W 4096 in bf16), every plan that fits (each cluster size
of ``trust_score.CLUSTERS`` and strip width of ``STRIPS``, with the rest
of ``trust_score.plan``'s choices) is held to the plain version (max
|kernel - plain| within 1e-4 of the largest plain value of each output)
and then timed: the median of ``--reps`` launches by CUDA events, the
launches queued behind a sleep kernel. Prints one JSON line per shape and
plan (``default`` marks the one ``trust_score.plan`` picks) with the byte
bound at 3.35 TB/s, and the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from repro_torch.kernels import trust_score as K1

D = 21840
HBM = 3.35e12            # bytes/s of an H100 SXM


def time_ms(fn, reps):
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


def plans(W, isz):
    default = K1.plan(W, D, isz)
    out = [default]
    for c in K1.CLUSTERS:
        for sb in K1.STRIPS:
            try:
                alt = K1.plan(W, D, isz, cluster=c, strip=sb)
            except ValueError:
                continue
            if alt not in out:
                out.append(alt)
    return default, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--shapes", default="16:f32,4096:f32,4096:bf16,10240:f32")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape in args.shapes.split(","):
        W, dt = shape.split(":")
        W = int(W)
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
        u = torch.randn((W, D), generator=gen, device=dev).to(dtype)
        want = K1.trust_score_ref(u)
        bound = K1.hbm_bytes(W, D, u.element_size())["minimum"] / HBM * 1e3
        default, cands = plans(W, u.element_size())
        for p in cands:
            got = K1._launch(u, p)
            torch.cuda.synchronize()
            err = max(float((g - e).abs().max()) for g, e in zip(got, want))
            ok = all(float((g - e).abs().max())
                     <= 1e-4 * max(1.0, float(e.abs().max()))
                     for g, e in zip(got, want))
            ms = time_ms(lambda: K1._launch(u, p), args.reps) if ok else None
            print(json.dumps({"W": W, "D": D, "dtype": dt,
                              "default": p == default, "plan": p._asdict(),
                              "max_abs_err": err, "ok": ok, "ms": ms,
                              "bound_ms": bound}), flush=True)
        del u, want
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
