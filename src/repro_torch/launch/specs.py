"""The dry run's inputs for every (arch × input shape) on one card
(``repro.launch.specs``): fake tensors on ``cuda``, which allocate nothing
on any device, and the port's own step functions.

The reference builds ``jax.ShapeDtypeStruct`` trees, their shardings over
the production mesh and a jit-able step. On one card every tensor lies
whole, so the shardings and the activation-sharding policies drop out.
What stays is the step itself: ``core.fl_step.make_fl_round``,
``api.prefill`` and ``api.decode_step``, called on fake tensors of the
shapes and dtypes a real call takes (``torch._subclasses.FakeTensorMode``),
on ``DEVICE``.

Every setup runs under the active ``FakeTensorMode`` (``launch.dryrun``
enters one), or under one of its own where none is active, and returns a
``Setup``: the step ``fn``, its ``args``, and the config and shape it was
built for (what ``dryrun.model_flops`` counts).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import (FederationConfig, ModelConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.configs.registry import get_config, get_shape
from repro_torch.core import fl_step
from repro_torch.device import fake_mode_active
from repro_torch.models import api

# the card; without one (a host with no card, or a PyTorch built without
# CUDA) the meta device stands in for it: a build without CUDA keeps no
# CUDA device guard (indexing and ``.to`` refuse even a fake CUDA tensor),
# and without a card the autograd engine finds no accelerator for a CUDA
# tensor's backward. Every branch of the port tells the CPU from the card by
# ``device.type == "cpu"``, so a meta tensor takes the card's path, its
# kernels' abstract branches included.
DEVICE = torch.device("cuda" if torch.cuda.is_available() else "meta")


class Setup(NamedTuple):
    """What a setup hands the dry run: ``fn(*args)`` is the step."""
    fn: Callable
    args: Tuple[Any, ...]
    cfg: ModelConfig
    shape: ShapeConfig


def new_fake_mode() -> FakeTensorMode:
    """A ``FakeTensorMode`` for the dry run. It takes in the tensors a step
    makes from Python numbers on the meta device (``torch.as_tensor(0.0,
    device=...)``), which it would otherwise refuse as real."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def fake_mode():
    """The active ``FakeTensorMode``'s context (nothing to enter), or a new
    one (``new_fake_mode``) where none is active."""
    return contextlib.nullcontext() if fake_mode_active() else \
        new_fake_mode()


def federation_for(mesh, fed: FederationConfig) -> FederationConfig:
    """The cluster topology on one card: all ``num_workers(fed)`` workers
    share it, one after another (the reference gives each worker a slot of
    the data axis, and a 1×1 mesh would make ``workers_per_cluster`` 1 // 4
    = 0). So the default ``FederationConfig`` keeps W = 16, and a train
    shape's ``per_worker`` = global_batch / W is 16 sequences at
    train_4k, as in the reference."""
    return fed


def train_config_for(cfg: ModelConfig) -> TrainConfig:
    """LLM FL rounds: the paper's SGD(momentum) economics, bf16 optimizer
    state for the biggest archs (≳ 20 B parameters), remat on (the
    reference's rule)."""
    big = cfg.num_layers * cfg.d_model * cfg.d_model > 2e9
    return TrainConfig(optimizer="sgd", lr=0.01, momentum=0.5,
                       remat=True, opt_dtype="bfloat16" if big else "float32")


def init_specs(cfg: ModelConfig, device=DEVICE):
    """The port's ``api.init`` of ``cfg`` on fake tensors on ``device``,
    drawn from a CPU generator: the params' shapes and dtypes, with no
    allocation and no draw on any device."""
    with fake_mode():
        return api.init(cfg, torch.Generator().manual_seed(0),
                        torch.device(device))


def _empty(shape, dtype, device=DEVICE) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def _batch_struct(cfg: ModelConfig, W: int, steps: int, per_worker: int,
                  seq: int, device=DEVICE):
    """A round's batch: tokens and labels (W, steps, per_worker, seq) int32;
    the VLM's text is seq less its patches, whose ``patch_embeds`` ride
    along; the audio family's ``frames`` (…, encoder_seq, d)."""
    text = seq - cfg.num_patch_tokens if cfg.family == "vlm" else seq
    lead = (W, steps, per_worker)
    b = {"tokens": _empty(lead + (text,), torch.int32, device),
         "labels": _empty(lead + (text,), torch.int32, device)}
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        b["patch_embeds"] = _empty(
            lead + (cfg.num_patch_tokens, cfg.d_model), dt, device)
    if cfg.family == "audio":
        b["frames"] = _empty(lead + (cfg.encoder_seq, cfg.d_model), dt,
                             device)
    return b


def train_setup(arch: str, shape_name: str, mesh, fed: FederationConfig,
                *, head_gather: bool = False, local_steps: int = 1,
                cfg: ModelConfig = None, shape: ShapeConfig = None,
                tc: TrainConfig = None) -> Setup:
    """One FL round of W workers (``make_fl_round``) over the global
    params, the per-worker optimizer state and the batch; an async round
    (``fed.async_mode``) also over the participation mask (W,) int32 and
    the async state (``fl_step.init_async_state_for``). ``cfg``, ``shape``
    and ``tc`` replace the registry's config and shape and
    ``train_config_for``'s rule (the card's re-traces of its own runs)."""
    cfg = cfg or get_config(arch)
    sh = shape or get_shape(shape_name)
    fed = federation_for(mesh, fed)
    if head_gather:
        fed = dataclasses.replace(fed, mode="head_gather")
    tc = dataclasses.replace(tc or train_config_for(cfg),
                             local_steps=local_steps)
    W = fl_step.num_workers(fed)
    assert sh.global_batch % W == 0, (sh.global_batch, W)
    per_worker = sh.global_batch // W
    with fake_mode():
        params = init_specs(cfg)
        opt = fl_step.init_worker_opt(params, fed, tc)
        batch = _batch_struct(cfg, W, tc.local_steps, per_worker,
                              sh.seq_len)
        fl_round = fl_step.make_fl_round(cfg, fed, tc, device=DEVICE)
        if not fed.async_mode:
            return Setup(fl_round, (params, opt, batch), cfg, sh)
        part = _empty((W,), torch.int32)
        state = fl_step.init_async_state_for(cfg, fed, params, W)

    def fn(params, opt, batch, part, state):
        return fl_round(params, opt, batch, participation=part,
                        async_state=state)
    return Setup(fn, (params, opt, batch, part, state), cfg, sh)


def _prefill_batch_struct(cfg: ModelConfig, B: int, seq: int,
                          device=DEVICE):
    """A prefill's batch: tokens (B, seq) int32 (the VLM: seq less its
    patches, and ``patch_embeds`` (B, P, d)); the audio family's
    ``frames`` (B, encoder_seq, d)."""
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        return {"tokens": _empty((B, seq - cfg.num_patch_tokens),
                                 torch.int32, device),
                "patch_embeds": _empty((B, cfg.num_patch_tokens,
                                        cfg.d_model), dt, device)}
    b = {"tokens": _empty((B, seq), torch.int32, device)}
    if cfg.family == "audio":
        b["frames"] = _empty((B, cfg.encoder_seq, cfg.d_model), dt, device)
    return b


def prefill_setup(arch: str, shape_name: str, mesh, *,
                  cfg: ModelConfig = None, shape: ShapeConfig = None,
                  cache_len: int = None) -> Setup:
    """``api.prefill`` of the global batch into a cache of seq slots
    (``cfg``, ``shape`` and ``cache_len`` replace the registry's and
    seq)."""
    cfg = cfg or get_config(arch)
    sh = shape or get_shape(shape_name)
    slots = sh.seq_len if cache_len is None else cache_len
    with fake_mode():
        params = init_specs(cfg)
        batch = _prefill_batch_struct(cfg, sh.global_batch, sh.seq_len)

    def fn(params, batch):
        return api.prefill(params, cfg, batch, slots)
    return Setup(fn, (params, batch), cfg, sh)


def cache_specs(cfg: ModelConfig, batch: int, seq: int, device=DEVICE):
    """Fake tensors of ``api.cache_struct``."""
    def mk(struct):
        return {k: mk(v) if isinstance(v, dict) else _empty(*v, device)
                for k, v in struct.items()}
    return mk(api.cache_struct(cfg, batch, seq))


def decode_setup(arch: str, shape_name: str, mesh, *,
                 long_context: bool = False, cfg: ModelConfig = None,
                 shape: ShapeConfig = None, cur_index: int = None) -> Setup:
    """One ``api.decode_step`` of the global batch (tokens (B, 1)) against
    a cache of seq slots, at its last slot (cur_index = seq − 1: the step
    that sees the whole context, which sets a sliding window's work).
    ``long_context`` (long_500k) takes the same whole cache: one card has
    no axes to lay its sequence along. ``cfg``, ``shape`` and
    ``cur_index`` replace the registry's and the last slot."""
    cfg = cfg or get_config(arch)
    sh = shape or get_shape(shape_name)
    cur = sh.seq_len - 1 if cur_index is None else cur_index
    B = sh.global_batch
    with fake_mode():
        params = init_specs(cfg)
        cache = cache_specs(cfg, B, sh.seq_len)
        tokens = _empty((B, 1), torch.int32)

    def fn(params, cache, tokens):
        return api.decode_step(params, cfg, cache, tokens, cur)
    return Setup(fn, (params, cache, tokens), cfg, sh)


def setup_for(arch: str, shape_name: str, mesh, fed: FederationConfig,
              **kw) -> Setup:
    kind = get_shape(shape_name).kind
    if kind == "train":
        return train_setup(arch, shape_name, mesh, fed, **kw)
    if kind == "prefill":
        return prefill_setup(arch, shape_name, mesh)
    return decode_setup(arch, shape_name, mesh)
