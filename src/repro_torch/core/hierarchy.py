"""Cluster-hierarchical aggregation over worker-stacked update dicts — the
per-leaf path (``fused_trust_path="off"``).

W is laid out ``(num_clusters, workers_per_cluster)``: stage 1 is the
trust-weighted mean inside each cluster (the cluster head's FedAvg), stage
2 the trust-weighted mean over clusters (the head↔head exchange).
``aggregate_fused`` is the single weighted sum the hierarchy telescopes to;
``aggregate`` and ``aggregate_head_gather`` compute the same value through
the two stages. ``rotate_heads`` rolls each cluster's members so the
round's head sits at sub-index 0.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import FederationConfig

Params = Dict[str, torch.Tensor]


def _cluster_view(x: torch.Tensor, C: int) -> torch.Tensor:
    """(W, ...) -> (C, Wc, ...)"""
    return x.reshape(C, x.shape[0] // C, *x.shape[1:])


def _bshape(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return w.reshape(tuple(w.shape) + (1,) * (x.ndim - w.ndim))


def aggregate_fused(updates: Params, weights: torch.Tensor) -> Params:
    """Σ_w weights_w · u_w as one weighted reduction per leaf."""
    return {k: (u.float() * _bshape(weights, u)).sum(dim=0)
            for k, u in updates.items()}


def _stage_weights(weights: torch.Tensor, C: int):
    w_cl = _cluster_view(weights, C)                       # (C, Wc)
    member_total = w_cl.sum(dim=1)                         # (C,)
    cluster_weights = member_total / torch.clamp(member_total.sum(),
                                                 min=1e-12)
    w_intra = w_cl / torch.clamp(member_total, min=1e-12)[:, None]
    return w_intra, cluster_weights


def aggregate(updates: Params, weights: torch.Tensor,
              fed: FederationConfig) -> Params:
    """Two-level trust-weighted aggregation; weights (W,) already combine
    trust × participation × staleness and sum to 1. Returns the aggregated
    update (leaves without the W dim)."""
    C = fed.num_clusters
    w_intra, cluster_weights = _stage_weights(weights, C)
    out = {}
    for k, u in updates.items():
        uc = _cluster_view(u.float(), C)                   # (C, Wc, ...)
        head = (uc * _bshape(w_intra, uc)).sum(dim=1)      # stage 1
        out[k] = (head * _bshape(cluster_weights, head)).sum(dim=0)
    return out


def aggregate_head_gather(updates: Params, weights: torch.Tensor,
                          fed: FederationConfig) -> Params:
    """Paper-faithful stage 1: every member's update is gathered at its
    cluster head (slot 0 after rotation), which reduces alone. Same value
    as ``aggregate``; on one device the gather is the identity."""
    C = fed.num_clusters
    w_intra, cluster_weights = _stage_weights(weights, C)
    out = {}
    for k, u in updates.items():
        gathered = _cluster_view(u.float(), C).clone()     # at the head slot
        head = (gathered * _bshape(w_intra, gathered)).sum(dim=1)
        out[k] = (head * _bshape(cluster_weights, head)).sum(dim=0)
    return out


def broadcast_to_workers(params: Params, W: int) -> Params:
    """Global model redistributed to every worker: (W, ...) views."""
    return {k: x[None].expand((W,) + tuple(x.shape))
            for k, x in params.items()}


def rotate_heads(x: Params, offsets: torch.Tensor) -> Params:
    """Head rotation: roll each cluster's member axis so the round's head
    is at sub-index 0 — member j of cluster c takes the update of member
    (j + offsets[c]) mod Wc. offsets: (C,) ints (on-chain randomness)."""
    C = offsets.shape[0]
    out = {}
    for k, u in x.items():
        uc = _cluster_view(u, C)                           # (C, Wc, ...)
        Wc = uc.shape[1]
        src = (torch.arange(Wc, device=u.device)[None, :]
               + offsets.to(u.device, torch.int64)[:, None]) % Wc
        rows = torch.arange(C, device=u.device)[:, None]
        out[k] = uc[rows, src].reshape(u.shape)
    return out
