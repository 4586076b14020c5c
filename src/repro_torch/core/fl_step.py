"""The SDFL-B round — the framework's ``train_step``, eager PyTorch.

Workers carry an explicit leading dim W on params, optimizer state and
batch (W = num_clusters × workers_per_cluster). The round:

  1. broadcast the global params to all workers
  2. ``local_steps`` of per-worker SGD(momentum) or AdamW on each worker's
     own batch (the CNN runs all W workers at once: grouped convolutions
     and batched matmuls, so one backward gives every worker its own
     gradient; a decoder runs the workers one after another, one forward
     and one ``autograd.grad`` each, so one worker's graph is alive at a
     time, where the reference ``vmap``s them)
  3. per-worker update u_w = params_w − global
  4. trust statistics and scores (``core.trust``)
  5. trust-weighted aggregation; async mode folds in staleness discounts
     and the pending buffers (``core.async_agg``)
  6. new global = global + aggregate

Steps 3–5 have two implementations. The fused path
(``FederationConfig.fused_trust_path``, auto-on for the CNN, ``"on"`` for
any family) packs the deltas into ONE (W, D) matrix (``kernels.pack``)
and runs the trust kernels on it: K1 for the statistics, then K2 (sync)
or K3 (async). The per-leaf path (``"off"``) works on the update dict in plain PyTorch
(``core.hierarchy``). Both share the score and weight math.

Host-level protocol work (settlement, ledger blocks, IPFS, head rotation)
happens between rounds in ``core.node``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.configs.base import FederationConfig, ModelConfig, \
    TrainConfig
from repro_torch.core import async_agg, hierarchy, trust
from repro_torch.device import resolve_device
from repro_torch.kernels import fused_round, pack, trust_agg
from repro_torch.models import api, cnn
from repro_torch.optim import clip_grads, init_opt, opt_update

Params = Dict[str, torch.Tensor]


class RoundOutput(NamedTuple):
    global_params: Params
    opt_state: object
    scores: torch.Tensor       # (W,) trust scores S(w)
    weights: torch.Tensor      # (W,) effective aggregation weights
    losses: torch.Tensor       # (W,) final local loss per worker
    metrics: dict


def num_workers(fed: FederationConfig, *, pods: int = 1) -> int:
    return fed.num_clusters * fed.workers_per_cluster * pods


def fused_round_enabled(cfg: ModelConfig, fed: FederationConfig,
                        params: Params) -> bool:
    """``auto`` engages the flat-pack path for a CNN param dict with one
    floating dtype; ``on`` forces it for any packable dict; ``off`` keeps
    the per-leaf path."""
    knob = fed.fused_trust_path
    if knob == "off":
        return False
    ok = pack.packable(params)
    if knob == "on":
        if not ok:
            raise ValueError(
                "fused_trust_path='on' requires a packable param dict "
                "(uniform floating leaf dtype)")
        return True
    if knob != "auto":
        raise ValueError(f"fused_trust_path must be auto|on|off, "
                         f"got {knob!r}")
    return ok and cfg.family == "cnn"


def init_async_state_for(cfg: ModelConfig, fed: FederationConfig,
                         global_params: Params, W: int
                         ) -> async_agg.AsyncState:
    """Async state for the path ``make_fl_round`` will take: on the fused
    path the pending buffer is ONE unpadded (W, D) f32 matrix (what K3
    reads and writes); otherwise a per-leaf dict."""
    device = next(iter(global_params.values())).device
    if fused_round_enabled(cfg, fed, global_params):
        spec = pack.pack_spec(global_params)
        return async_agg.AsyncState(
            torch.zeros((W,), dtype=torch.int32, device=device),
            torch.zeros((W, spec.total), dtype=torch.float32, device=device))
    updates_like = {k: torch.zeros((W,) + tuple(x.shape), device=device)
                    for k, x in global_params.items()}
    return async_agg.init_async_state(updates_like, W)


def _stack_state(x, W: int):
    if isinstance(x, dict):
        return {k: _stack_state(v, W) for k, v in x.items()}
    return x[None].expand((W,) + tuple(x.shape)).clone()


def init_worker_opt(global_params: Params, fed: FederationConfig,
                    tc: TrainConfig, *, pods: int = 1):
    """Per-worker optimizer state: leading W dim on every leaf."""
    return _stack_state(init_opt(global_params, tc),
                        num_workers(fed, pods=pods))


def make_fl_round(cfg: ModelConfig, fed: FederationConfig, tc: TrainConfig,
                  *, device=None):
    """Builds the round function. It runs on ``device`` — ``cuda`` unless
    the caller passes another (see ``repro_torch.device``); every tensor
    handed to it must already live there.

    ``fl_round(global_params, opt_state, batch, rngs=None,
    participation=None, async_state=None)``: batch leaves are
    (W, local_steps, per_worker_batch, ...) — ``images``/``labels`` for the
    CNN, ``tokens``/``labels`` (..., S) for a decoder; ``rngs`` is a
    ``torch.Generator`` on ``device`` for the CNN's conv2 dropout masks
    (None: no dropout; decoders have none); participation (W,) 0/1;
    async_state an ``async_agg.AsyncState``. Returns a ``RoundOutput``
    (and the new async state in async mode)."""
    dev = resolve_device(device)
    is_cnn = cfg.family == "cnn"
    loss_fn = api.loss_fn(cfg, remat=tc.remat, kv_chunk=tc.kv_chunk)
    lm_loss = None if is_cnn else api.lm_loss_fn(cfg, remat=tc.remat,
                                                 kv_chunk=tc.kv_chunk)

    def grads_and_loss(params_w: Params, step_batch, mask):
        if not is_cnn:
            return lm_grads_and_loss(params_w, step_batch)
        p = {k: v.detach().requires_grad_(True) for k, v in params_w.items()}
        with torch.enable_grad():
            losses, _ = loss_fn(p, step_batch, mask)
            g = torch.autograd.grad(losses.sum(), list(p.values()))
        return clip_grads(dict(zip(p, g)), tc.grad_clip), losses.detach()

    def lm_grads_and_loss(params_w: Params, step_batch):
        """Each worker's loss and gradient in turn, into (W, ...) grads."""
        W = step_batch["tokens"].shape[0]
        grads = {k: torch.empty_like(v) for k, v in params_w.items()}
        losses = torch.empty((W,), dtype=torch.float32, device=dev)
        for w in range(W):
            p = {k: v[w].detach().requires_grad_(True)
                 for k, v in params_w.items()}
            with torch.enable_grad():
                loss, _ = lm_loss(p, api.worker(step_batch, w))
                g = torch.autograd.grad(loss, list(p.values()))
            for k, gk in zip(p, g):
                grads[k][w] = gk
            losses[w] = loss.detach()
        return clip_grads(grads, tc.grad_clip), losses

    def draw_mask(rngs, W: int, B: int):
        if rngs is None or not is_cnn:
            return None
        return cnn.dropout_mask(rngs, W, B, cfg, dev)

    @torch.no_grad()
    def fl_round(global_params: Params, opt_state, batch, rngs=None,
                 participation=None, async_state=None):
        # leaves (W, local_steps, B, ...): images/labels or tokens/labels
        W, L, B = next(iter(batch.values())).shape[:3]
        first = next(iter(global_params.values()))
        if first.device.type != dev.type:
            raise ValueError(f"params on {first.device}, round built for "
                             f"{dev}")
        use_fused = fused_round_enabled(cfg, fed, global_params)
        params_w = hierarchy.broadcast_to_workers(global_params, W)
        if tc.local_steps == 1:
            step_batch = {k: v[:, 0] for k, v in batch.items()}
            mask = draw_mask(rngs, W, B)
            grads, l_pre = grads_and_loss(params_w, step_batch, mask)
            new_p, new_opt = opt_update(params_w, grads, opt_state, tc)
            if fed.w_loss > 0:
                # contribution quality needs a live loss delta: re-evaluate
                # the SAME batch with the SAME dropout mask (the mask
                # cancels) at the post-step params
                l_post = loss_fn(new_p, step_batch, mask)[0]
                losses = torch.stack([l_pre, l_post], dim=1)
            else:
                losses = l_pre[:, None]
        else:
            new_p, new_opt, steps = params_w, opt_state, []
            for s in range(L):
                step_batch = {k: v[:, s] for k, v in batch.items()}
                grads, loss = grads_and_loss(new_p, step_batch,
                                             draw_mask(rngs, W, B))
                new_p, new_opt = opt_update(new_p, grads, new_opt, tc)
                steps.append(loss)
            losses = torch.stack(steps, dim=1)

        metrics = {"mean_loss": losses[:, -1].mean(),
                   "mean_loss_delta": (losses[:, 0] - losses[:, -1]).mean()}
        if fed.async_mode:
            if async_state is None or participation is None:
                raise ValueError("async rounds need participation and "
                                 "async_state")
            metrics["cohort_size"] = (participation > 0).sum()
            metrics["mean_staleness"] = async_state.staleness.float().mean()
        if use_fused:
            # deltas land in ONE contiguous (W, D) matrix in the param
            # dtype; K1 then K2 (sync) or K3 (async) stream it, and the
            # param dict is reassembled once from the (D,) aggregate
            spec = pack.pack_spec(global_params)
            upd_flat = pack.pack_delta(new_p, global_params, spec)
            stats = trust.update_stats_flat(upd_flat, losses[:, 0],
                                            losses[:, -1])
            scores = trust.scores_from_stats(stats, fed)
            if fed.async_mode:
                weights = async_agg.effective_weights(
                    scores, participation, async_state.staleness, fed)
                keep = 1.0 - participation.float()
                agg_flat, new_pending = fused_round.fused_async_agg(
                    upd_flat, async_state.pending, weights, keep)
                new_async = async_agg.AsyncState(
                    torch.where(participation > 0,
                                torch.zeros_like(async_state.staleness),
                                async_state.staleness + 1), new_pending)
            else:
                weights = trust.trust_weights(scores, fed,
                                              participation=participation)
                agg_flat = trust_agg.trust_agg(upd_flat, weights)
                new_async = async_state
            agg = pack.unpack_vector(agg_flat, spec)
        else:
            updates = {k: (new_p[k].float() - g.float()[None]).to(g.dtype)
                       for k, g in global_params.items()}
            stats = trust.update_stats(updates, losses[:, 0], losses[:, -1])
            scores = trust.scores_from_stats(stats, fed)
            if fed.async_mode:
                agg, new_async, weights = async_agg.async_round(
                    updates, scores, participation, async_state, fed)
            else:
                weights = trust.trust_weights(scores, fed,
                                              participation=participation)
                if fed.mode == "head_gather":
                    agg = hierarchy.aggregate_head_gather(updates, weights,
                                                          fed)
                elif fed.mode == "two_stage":
                    agg = hierarchy.aggregate(updates, weights, fed)
                else:   # "allreduce": one weighted sum, identical value
                    agg = hierarchy.aggregate_fused(updates, weights)
                new_async = async_state

        new_global = {k: (g.float() + agg[k]).to(g.dtype)
                      for k, g in global_params.items()}
        out = RoundOutput(new_global, new_opt, scores, weights,
                          losses[:, -1], metrics)
        if fed.async_mode:
            return out, new_async
        return out

    return fl_round

