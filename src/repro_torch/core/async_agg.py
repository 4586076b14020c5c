"""Asynchronous functionality — buffered, staleness-weighted aggregation
(``async_sim`` is the event-driven host simulator).

Each round a participation mask says which workers' updates arrived.
Arrived updates are weighted by trust × staleness discount and aggregated
through the cluster hierarchy; absent workers accumulate staleness, and
their pending local progress is folded in when they next arrive.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FederationConfig
from repro_torch.core import hierarchy, trust


class AsyncState(NamedTuple):
    staleness: torch.Tensor   # (W,) int32 rounds since last inclusion
    pending: object           # dict (W, ...) f32, or the fused path's
                              # unpadded (W, D) f32 matrix


def init_async_state(updates_like, W: int) -> AsyncState:
    pending = {k: torch.zeros_like(x, dtype=torch.float32)
               for k, x in updates_like.items()}
    device = next(iter(pending.values())).device
    return AsyncState(torch.zeros((W,), dtype=torch.int32, device=device),
                      pending)


def host_staleness_update(staleness, mask):
    """Host-side (numpy) mirror of the device staleness rule: arrived
    workers reset to 0, everyone else ages by one round. ``FederatedTask``
    keeps it so the pre-round staleness can go into the on-chain records
    without a device sync."""
    m = np.asarray(mask) > 0
    return np.where(m, 0, np.asarray(staleness, np.int64) + 1)


def effective_weights(scores, mask, staleness,
                      fed: FederationConfig) -> torch.Tensor:
    """trust × penalization filter × participation × staleness discount,
    normalized. Shared by the per-leaf and the fused paths."""
    discount = trust.staleness_discount(staleness, fed.staleness_alpha)
    w = trust.trust_weights(scores, fed, participation=mask) * discount
    return w / torch.clamp(w.sum(), min=1e-12)


def async_round(updates, scores, mask, state: AsyncState,
                fed: FederationConfig) -> Tuple[dict, AsyncState,
                                                torch.Tensor]:
    """One asynchronous aggregation round over a per-leaf update dict.
    Returns (aggregated_update, new_state, effective_weights)."""
    total = {k: state.pending[k] + u.float() for k, u in updates.items()}
    w = effective_weights(scores, mask, state.staleness, fed)
    agg = hierarchy.aggregate(total, w, fed)
    # arrived workers flush their buffer exactly (keep = 1 − arrivals), so
    # no buffered update is ever aggregated twice
    keep = 1.0 - mask.float()
    new_pending = {k: t * keep.reshape((-1,) + (1,) * (t.ndim - 1))
                   for k, t in total.items()}
    new_staleness = torch.where(mask > 0, torch.zeros_like(state.staleness),
                                state.staleness + 1)
    return agg, AsyncState(new_staleness, new_pending), w
