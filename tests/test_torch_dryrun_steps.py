"""The dry run (``repro_torch.launch.dryrun.run_one``) over the smoke
config of every family through ``setup_override``: a prefill, a decode
step against a cache of ``DECODE_SLOTS``, and a sync round at W = 4
(``tests/test_torch_dryrun_async.py`` has the async rounds and
``tests/test_torch_dryrun_flat.py`` the flat pack's).
Each step is traced once on fake tensors on the CPU: its terms are finite
and positive, the useful share of its FLOPs lies in (0, 1.5], its peak
holds at least its arguments, and the kernels its path runs on the card
are counted (K4 and its backward in the hybrid's and xLSTM's rounds, K4
in their prefills, K5 in the sliding-window decode).

The decode's cache is long enough for its attention to count:
``model_flops`` takes 2 N a token over every parameter, whisper's encoder
too, which a decode step does not run.
"""
import math

import pytest

from repro_torch.configs.base import FederationConfig, ShapeConfig, \
    TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun, specs
from repro_torch.models import api

FAMILIES = {"dense": "h2o-danube-1.8b", "moe": "olmoe-1b-7b",
            "vlm": "chameleon-34b", "hybrid": "zamba2-7b",
            "ssm": "xlstm-1.3b", "audio": "whisper-base"}
SEQ, BATCH, W = 16, 2, 4
DECODE_SLOTS = 512
TC = TrainConfig(optimizer="adamw", lr=3e-4, remat=True, grad_clip=1.0)


def _check(r, kernels=()):
    for k in ("compute_s", "memory_s", "flops_per_device",
              "bytes_per_device", "peak_memory_per_device_gb"):
        assert math.isfinite(r[k]) and r[k] > 0, k
    assert 0 < r["useful_flops_ratio"] <= 1.5, r["useful_flops_ratio"]
    assert r["peak_bytes"] >= r["args_bytes"] > 0
    assert r["dominant"] in ("compute_s", "memory_s")
    assert set(r["kernels"]) == set(kernels), r["kernels"]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_serve_steps(family):
    arch = FAMILIES[family]
    cfg = get_smoke_config(arch)
    seq = SEQ + cfg.num_patch_tokens

    def prefill(a, s, mesh, fed, **kw):
        return specs.prefill_setup(a, s, mesh, cfg=cfg, shape=ShapeConfig(
            "p", seq, BATCH, "prefill"))

    def decode(a, s, mesh, fed, **kw):
        return specs.decode_setup(a, s, mesh, cfg=cfg, shape=ShapeConfig(
            "d", DECODE_SLOTS, BATCH, "decode"))
    k4 = ("ssd_scan",) if family in ("hybrid", "ssm") else ()
    _check(dryrun.run_one(arch, "prefill_32k", setup_override=prefill), k4)
    swa = ("swa_decode",) if cfg.attn_type == "swa" else ()
    _check(dryrun.run_one(arch, "decode_32k", setup_override=decode), swa)


def run_round(family, mode):
    """One round of ``family``'s smoke config at W = 4 on fake tensors:
    ``mode`` sync or async, ``flat_sync`` or ``flat_async`` on the flat
    pack (in f32 where the bf16 params mix dtypes). The checked result."""
    arch = FAMILIES[family]
    cfg = get_smoke_config(arch)
    flat = mode.startswith("flat")
    if flat and not api.flat_packable(specs.init_specs(cfg)):
        cfg = cfg.replace(dtype="float32")
    fed = FederationConfig(num_clusters=2, workers_per_cluster=W // 2,
                           async_mode=mode.endswith("async"),
                           fused_trust_path="on" if flat else "off",
                           mode="allreduce")

    def setup(a, s, mesh, _, **kw):
        return specs.train_setup(a, s, mesh, fed, cfg=cfg, tc=TC,
                                 shape=ShapeConfig(
                                     "t", SEQ + cfg.num_patch_tokens,
                                     W * BATCH, "train"))
    r = dryrun.run_one(arch, "train_4k", setup_override=setup)
    kernels = {"flat_sync": ("trust_score", "trust_agg"),
               "flat_async": ("trust_score", "fused_async_agg")}.get(
                   mode, ())
    if family in ("hybrid", "ssm"):
        kernels += ("ssd_scan", "ssd_scan_bwd")
    _check(r, kernels)
    n = api.param_count(specs.init_specs(cfg))
    assert r["params_active"] == n if not cfg.moe.enabled else \
        0 < r["params_active"] < n
    return r


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sync_round(family):
    run_round(family, "sync")
