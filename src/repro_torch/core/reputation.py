"""Reputation: persistent trust across rounds + reputation-aware leader
selection (the paper's §VI.E future-work item: "leaders chosen at random
might be bad workers and affect the performance of the model by pushing bad
weights").

ReputationBook keeps an EMA of per-worker scores plus the on-chain penalty
history; ``leader_weights`` turns that into a sampling distribution for
cluster-head election so low-reputation workers rarely lead — while keeping
rotation stochastic (on-chain randomness) so no worker dominates (paper
§III.A requirement).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


class ReputationBook:
    def __init__(self, num_workers: int, *, ema: float = 0.8,
                 prior: float = 0.5) -> None:
        self.ema = ema
        self.scores = np.full(num_workers, prior, np.float64)
        self.penalties = np.zeros(num_workers, np.int64)
        self.rounds = 0

    def update(self, round_scores: Sequence[float],
               penalized: Sequence[int] = ()) -> None:
        """Vectorized: ``penalized`` is either a (W,) boolean mask or an
        array/sequence of penalized worker indices — no Python loop."""
        s = np.asarray(round_scores, np.float64)
        self.scores = self.ema * self.scores + (1 - self.ema) * s
        p = np.asarray(penalized)
        if p.size:
            if p.dtype == bool:
                self.penalties += p
            else:
                np.add.at(self.penalties, p.astype(np.int64), 1)
        self.rounds += 1

    def leader_weights(self, members: Sequence[int],
                       *, floor: float = 0.05) -> np.ndarray:
        """Sampling weights over a cluster's members: reputation discounted
        by penalty history, floored so rotation never fully excludes anyone
        (the paper's dynamism requirement)."""
        rep = self.scores[list(members)]
        pen = self.penalties[list(members)]
        w = np.maximum(rep / (1.0 + pen), floor)
        return w / w.sum()

    def elect(self, members: Sequence[int], rng_seed: int) -> int:
        """Deterministic reputation-weighted election from on-chain
        randomness — every node derives the same leader."""
        rng = np.random.default_rng(rng_seed)
        return int(rng.choice(len(members), p=self.leader_weights(members)))


def reputation_cluster_weights(book: ReputationBook, num_clusters: int,
                               workers_per_cluster: int) -> np.ndarray:
    """(C,) cluster weights for the head↔head stage: clusters led/populated
    by reputable workers carry more weight (paper §VI.B fairness)."""
    rep = book.scores.reshape(num_clusters, workers_per_cluster)
    w = rep.mean(axis=1)
    return w / w.sum()
