"""Federated data pipeline.

No MNIST on disk in this container, so the paper-repro path uses a
deterministic synthetic MNIST surrogate: 10 class-conditional 28×28
stroke-like prototypes + per-sample elastic noise/shift. The paper's claims
are about *consistency across worker counts / blockchain on-off*, which is
preserved under the surrogate (absolute accuracy differs; noted in
DESIGN.md §9).

Partitioners: IID shards and Dirichlet(α) non-IID label skew — the
geographic-cluster data-similarity of the paper's §III.B maps to assigning
adjacent Dirichlet components to workers in the same cluster.

LM path: deterministic synthetic token streams (mixture of n-gram-ish
pattern generators) for the assigned-architecture smoke/e2e runs.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


# -- synthetic MNIST surrogate -------------------------------------------------

def _digit_prototypes(image_size: int = 28) -> np.ndarray:
    """(10, H, W) smooth class-conditional patterns (fixed, deterministic)."""
    rng = np.random.default_rng(1234)
    protos = []
    yy, xx = np.mgrid[0:image_size, 0:image_size] / (image_size - 1)
    for c in range(10):
        freq_x, freq_y = 1 + c % 4, 1 + (c // 3) % 4
        phase = c * 0.7
        base = (np.sin(2 * np.pi * freq_x * xx + phase)
                * np.cos(2 * np.pi * freq_y * yy - phase))
        blob = np.exp(-(((xx - 0.3 - 0.05 * c) ** 2 + (yy - 0.5) ** 2) / 0.05))
        protos.append(0.6 * base + 0.8 * blob + 0.05 * rng.standard_normal(base.shape))
    return np.stack(protos).astype(np.float32)


_PROTOS = None


def synthetic_mnist(n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Returns images (n, 28, 28, 1) float32 in [0,1]-ish, labels (n,)."""
    global _PROTOS
    if _PROTOS is None:
        _PROTOS = _digit_prototypes()
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    base = _PROTOS[labels]
    shift = rng.integers(-2, 3, size=(n, 2))
    imgs = np.empty_like(base)
    for i in range(n):                                     # small n; fine on host
        imgs[i] = np.roll(base[i], tuple(shift[i]), axis=(0, 1))
    imgs = imgs + 0.35 * rng.standard_normal(imgs.shape).astype(np.float32)
    return imgs[..., None].astype(np.float32), labels.astype(np.int32)


# -- federated partitioners ----------------------------------------------------

def partition_iid(n: int, num_workers: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return np.array_split(perm, num_workers)


def partition_dirichlet(labels: np.ndarray, num_workers: int, alpha: float,
                        seed: int = 0) -> List[np.ndarray]:
    """Label-skewed non-IID split (Dirichlet over workers per class)."""
    rng = np.random.default_rng(seed)
    out: List[List[int]] = [[] for _ in range(num_workers)]
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * num_workers)
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for w, part in enumerate(np.split(idx, cuts)):
            out[w].extend(part.tolist())
    return [np.array(sorted(x), dtype=np.int64) for x in out]


class FederatedDataset:
    """Per-worker shards with equal-size round batches (pad by resampling)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 assignments: List[np.ndarray], seed: int = 0) -> None:
        self.images, self.labels = images, labels
        self.assignments = assignments
        self.rng = np.random.default_rng(seed)

    @property
    def num_workers(self) -> int:
        return len(self.assignments)

    def worker_batch(self, w: int, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self.assignments[w]
        take = self.rng.choice(idx, size=batch_size, replace=len(idx) < batch_size)
        return {"images": self.images[take], "labels": self.labels[take]}

    def round_batches(self, batch_size: int) -> Dict[str, np.ndarray]:
        """Stacked (W, B, ...) batch for the vmapped FL step."""
        batches = [self.worker_batch(w, batch_size) for w in range(self.num_workers)]
        return {k: np.stack([b[k] for b in batches]) for k in batches[0]}

    def eval_batch(self, n: int = 512) -> Dict[str, np.ndarray]:
        take = self.rng.choice(len(self.labels), size=min(n, len(self.labels)),
                               replace=False)
        return {"images": self.images[take], "labels": self.labels[take]}


def make_federated_mnist(num_workers: int, *, samples: int = 4096,
                         non_iid_alpha: float = 0.0, seed: int = 0) -> FederatedDataset:
    imgs, labels = synthetic_mnist(samples, seed=seed)
    if non_iid_alpha > 0:
        parts = partition_dirichlet(labels, num_workers, non_iid_alpha, seed)
    else:
        parts = partition_iid(samples, num_workers, seed)
    return FederatedDataset(imgs, labels, parts, seed=seed + 1)


# -- synthetic LM token streams --------------------------------------------------

def synthetic_tokens(num_workers: int, batch: int, seq: int, vocab: int,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """(W, B, S) learnable-but-nontrivial token streams: each worker has its
    own Markov-ish generator (cluster data similarity analogue)."""
    rng = np.random.default_rng(seed)
    toks = np.empty((num_workers, batch, seq), np.int32)
    for w in range(num_workers):
        period = 3 + (w % 5)
        base = rng.integers(0, vocab, size=(batch, period))
        reps = -(-seq // period)
        stream = np.tile(base, (1, reps))[:, :seq]
        noise = rng.random((batch, seq)) < 0.1
        stream = np.where(noise, rng.integers(0, vocab, size=(batch, seq)), stream)
        toks[w] = stream
    return {"tokens": toks, "labels": toks.copy()}
