"""Trust scoring — ``EvaluatePerformance`` of Algorithm 1, in PyTorch.

Three terms over the per-worker update vectors u_w and the provisional
consensus c = mean_w u_w:

  cosine   : cos(u_w, c_w) vs the leave-one-out consensus
  norm     : exp(-|log(‖u_w‖ / median‖u‖)|)
  loss     : relative local-loss improvement

S(w) = (w_cos·cos⁺ + w_norm·norm + w_loss·loss) / (w_cos + w_norm + w_loss).

``update_stats`` reduces per leaf (the path for ``fused_trust_path="off"``);
``update_stats_flat`` runs K1 over the packed (W, D) matrix. Both feed the
same ``scores_from_stats``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch import mathfn
from repro_torch.configs.base import FederationConfig
from repro_torch.kernels.trust_score import trust_score_stats


class TrustStats(NamedTuple):
    dot: torch.Tensor         # (W,)  <u_w, c> vs INCLUSIVE consensus c
    sq_u: torch.Tensor        # (W,)  ‖u_w‖²
    sq_c: torch.Tensor        # ()    ‖c‖²
    loss_delta: torch.Tensor  # (W,)  loss_before - loss_after


def update_stats(updates: Dict[str, torch.Tensor], loss_before,
                 loss_after) -> TrustStats:
    """updates: dict with leading worker dim W on every leaf. The leaves
    are summed in key order, one f32 copy at a time, so the f32 copies of
    a large model's (W, D) updates are never all held at once."""
    dot = sq_u = sq_c = 0
    for _, x in sorted(updates.items()):
        x = x.float()
        red = tuple(range(1, x.ndim))
        dot = dot + (x * x.mean(dim=0, keepdim=True)).sum(dim=red)
        sq_u = sq_u + x.square().sum(dim=red)
        sq_c = sq_c + x.mean(dim=0).square().sum()
    return TrustStats(dot, sq_u, sq_c, loss_before - loss_after)


def update_stats_flat(updates_flat: torch.Tensor, loss_before,
                      loss_after) -> TrustStats:
    """Fused-path twin of ``update_stats``: K1 over the (W, D) pack."""
    dot, sq_u, sq_c = trust_score_stats(updates_flat)
    return TrustStats(dot, sq_u, sq_c, loss_before - loss_after)


def median(x: torch.Tensor) -> torch.Tensor:
    """Median of a 1-D tensor as ``jnp.median`` defines it: the mean of the
    two middle values for an even count (``torch.median`` returns the
    lower one)."""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) / 2


def scores_from_stats(stats: TrustStats,
                      fed: FederationConfig) -> torch.Tensor:
    """S(w) ∈ [0,1] per worker. The cosine term uses the leave-one-out
    consensus c_w = mean_{v≠w} u_v, derived from the inclusive stats:

        <u_w, c_w>  = (W·<u_w,c> − ‖u_w‖²) / (W−1)
        ‖c_w‖²      = (W²‖c‖² − 2W·<u_w,c> + ‖u_w‖²) / (W−1)²
    """
    W = stats.dot.shape[0]
    if W > 1:
        dot_loo = (W * stats.dot - stats.sq_u) / (W - 1)
        sq_c_loo = (W * W * stats.sq_c - 2 * W * stats.dot
                    + stats.sq_u) / ((W - 1) ** 2)
    else:
        dot_loo, sq_c_loo = stats.dot, stats.sq_c.expand(1)
    norm_u = mathfn.sqrt(stats.sq_u)
    cos = dot_loo / torch.clamp(
        norm_u * mathfn.sqrt(torch.clamp(sq_c_loo, min=0.0)), min=1e-12)
    cos_term = torch.clamp(cos, 0.0, 1.0)

    med = median(norm_u)
    norm_term = mathfn.exp(-torch.abs(mathfn.log(
        torch.clamp(norm_u, min=1e-12) / torch.clamp(med, min=1e-12))))

    best = torch.clamp(stats.loss_delta.max(), min=1e-12)
    loss_term = torch.clamp(stats.loss_delta / best, 0.0, 1.0)

    s = (fed.w_cosine * cos_term + fed.w_norm * norm_term
         + fed.w_loss * loss_term)
    return s / (fed.w_cosine + fed.w_norm + fed.w_loss)


def trust_weights(scores: torch.Tensor, fed: FederationConfig,
                  participation=None) -> torch.Tensor:
    """Aggregation weights: bad workers (S < T) are zeroed (the penalization
    filter); survivors weighted by score (soft) or uniformly (hard).
    ``participation``: optional (W,) 0/1 mask (async rounds)."""
    good = (scores >= fed.trust_threshold).float()
    w = good * scores if fed.soft_trust_weighting else good
    if participation is not None:
        w = w * participation.float()
    # fall back to uniform if everything was filtered (keeps training alive)
    uniform = (torch.ones_like(w) if participation is None
               else participation.float())
    w = torch.where(w.sum() > 0, w, uniform)
    return w / torch.clamp(w.sum(), min=1e-12)


def staleness_discount(staleness: torch.Tensor,
                       alpha: float) -> torch.Tensor:
    """Async functionality: 1/(1+s)^α staleness weighting."""
    return (1.0 + staleness.float()) ** (-alpha)
