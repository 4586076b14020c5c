"""Client-selection strategies (paper §II: "careful planning, fine-tuning of
communication protocols, client selection strategies, and trust mechanisms
become crucial").

Selects the per-round participation mask consumed by ``fl_step``/
``async_agg``. All strategies are deterministic given (seed, round)."""
from __future__ import annotations


import numpy as np

from repro_torch.core.reputation import ReputationBook


def select_random(W: int, k: int, *, seed: int, round_index: int) -> np.ndarray:
    rng = np.random.default_rng(seed * 1_000_003 + round_index)
    mask = np.zeros(W, np.int64)
    mask[rng.choice(W, size=min(k, W), replace=False)] = 1
    return mask


def select_by_reputation(book: ReputationBook, k: int, *, seed: int,
                         round_index: int, explore: float = 0.1) -> np.ndarray:
    """Top-reputation selection with ε-greedy exploration so new/penalized
    workers can rebuild reputation (avoids starvation)."""
    W = len(book.scores)
    rng = np.random.default_rng(seed * 7_368_787 + round_index)
    k = min(k, W)
    n_explore = (max(1, int(round(k * explore)))
                 if explore > 0 and k < W else 0)
    ranked = np.argsort(-book.scores)
    chosen = list(ranked[: k - n_explore])
    rest = [w for w in range(W) if w not in chosen]
    if n_explore and rest:
        chosen += list(rng.choice(rest, size=min(n_explore, len(rest)),
                                  replace=False))
    mask = np.zeros(W, np.int64)
    mask[chosen] = 1
    return mask


def select_per_cluster(W: int, num_clusters: int, k_per_cluster: int, *,
                       seed: int, round_index: int) -> np.ndarray:
    """Balanced selection: k workers from every cluster (keeps the two-level
    aggregation well-conditioned — no empty cluster heads)."""
    wpc = W // num_clusters
    rng = np.random.default_rng(seed * 97 + round_index)
    mask = np.zeros(W, np.int64)
    for c in range(num_clusters):
        pick = rng.choice(wpc, size=min(k_per_cluster, wpc), replace=False)
        mask[c * wpc + pick] = 1
    return mask
