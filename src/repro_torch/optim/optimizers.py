"""Optimizers over worker-stacked param dicts (every leaf (W, ...)).

SGD(momentum) matches the paper's §IV hyperparameters (lr=0.01,
momentum=0.5, dampening=0, weight_decay=0, nesterov=False) with PyTorch
SGD semantics (buf = μ·buf + (1−damp)·g ; p −= lr·buf). AdamW is the
LLM-config default; its step ``count`` is per worker ((W,) int32). Updates
compute in f32 and return new tensors; nothing is updated in place. Square
roots go through ``repro_torch.mathfn``: on the CPU, ``torch.sqrt`` of
float32 is MKL's vector math, whose first call in a process can be wrong
(fault F2, ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import mathfn
from repro_torch.configs.base import TrainConfig

Params = Dict[str, torch.Tensor]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# -- SGD (paper) -------------------------------------------------------------

def sgd_init(params: Params, dtype=torch.float32):
    return {"momentum": {k: torch.zeros_like(p, dtype=dtype)
                         for k, p in params.items()}}


def sgd_update(params: Params, grads: Params, state, tc: TrainConfig):
    new_p, new_buf = {}, {}
    for k, p in params.items():
        g = grads[k].float()
        if tc.weight_decay:
            g = g + tc.weight_decay * p.float()
        buf = state["momentum"][k]
        b = tc.momentum * buf.float() + (1.0 - tc.dampening) * g
        step = (g + tc.momentum * b) if tc.nesterov else b
        new_p[k] = (p.float() - tc.lr * step).to(p.dtype)
        new_buf[k] = b.to(buf.dtype)
    return new_p, {"momentum": new_buf}


# -- AdamW -------------------------------------------------------------------

def adamw_init(params: Params, dtype=torch.float32):
    z = {k: torch.zeros_like(p, dtype=dtype) for k, p in params.items()}
    device = next(iter(params.values())).device
    return {"m": z, "v": {k: t.clone() for k, t in z.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(params: Params, grads: Params, state, tc: TrainConfig):
    count = state["count"] + 1
    b1, b2 = tc.adam_b1, tc.adam_b2
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()

    def bc(c, x):
        """count may carry a leading worker dim — broadcast to x's rank."""
        return c.reshape(c.shape + (1,) * (x.ndim - c.ndim)) if c.ndim else c

    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        m0, v0 = state["m"][k], state["v"][k]
        m = b1 * m0.float() + (1 - b1) * g
        v = b2 * v0.float() + (1 - b2) * g * g
        step = (m / bc(c1, m)) / (mathfn.sqrt(v / bc(c2, v)) + tc.adam_eps)
        if tc.weight_decay:
            step = step + tc.weight_decay * p.float()
        new_p[k] = (p.float() - tc.lr * step).to(p.dtype)
        new_m[k], new_v[k] = m.to(m0.dtype), v.to(v0.dtype)
    return new_p, {"m": new_m, "v": new_v, "count": count}


# -- dispatch ------------------------------------------------------------------

def init_opt(params: Params, tc: TrainConfig):
    dt = _dtype(tc.opt_dtype)
    return (sgd_init(params, dt) if tc.optimizer == "sgd"
            else adamw_init(params, dt))


def opt_update(params: Params, grads: Params, state, tc: TrainConfig):
    if tc.optimizer == "sgd":
        return sgd_update(params, grads, state, tc)
    return adamw_update(params, grads, state, tc)


def clip_grads(grads: Params, max_norm: float) -> Params:
    """Per-worker global-norm clipping: leaves are (W, ...), each worker's
    norm runs over all its leaves (the JAX package clips inside the worker
    vmap)."""
    if not max_norm:
        return grads
    sq = sum(g.float().square().reshape(g.shape[0], -1).sum(dim=1)
             for g in grads.values())
    scale = torch.clamp(max_norm / torch.clamp(mathfn.sqrt(sq), min=1e-12),
                        max=1.0)
    return {k: (g * scale.reshape((-1,) + (1,) * (g.ndim - 1))).to(g.dtype)
            for k, g in grads.items()}
