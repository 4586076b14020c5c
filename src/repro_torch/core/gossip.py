"""Cross-cluster model exchange (paper §III.A).

"Workers from one cluster can request the model's hash from another
cluster's head if they find value in the aggregated model generated by the
latter. Upon obtaining the hash, the requesting cluster's head incorporates
the model into its own aggregation."

Implementation: each round every cluster head publishes its *cluster
aggregate* to IPFS and registers the cid on-chain. A requesting cluster
pulls peers' aggregates by hash (verified content-addressing), weighs them
by the peers' mean on-chain trust, and folds them into its own aggregate —
the semi-decentralized propagation path that lets model quality flow between
clusters even when the global synchronization is partial (async mode).

Aggregates are flat dicts of tensors (the port's param layout) or of
numpy arrays (``repro_torch.net`` gossips host-side aggregates); ``fetch``
and ``merge`` give back the kind they were given.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.chain.ipfs import IPFSStore, flatten_tree
from repro_torch.chain.ledger import Ledger


class ClusterExchange:
    """Publish/fetch cluster aggregates through IPFS + the ledger."""

    def __init__(self, ipfs: IPFSStore, ledger: Ledger,
                 num_clusters: int) -> None:
        self.ipfs = ipfs
        self.ledger = ledger
        self.num_clusters = num_clusters
        self._round_cids: Dict[int, Dict[int, str]] = {}

    # -- head side ----------------------------------------------------------

    def publish(self, round_index: int, cluster: int, aggregate) -> str:
        """Cluster head stores its aggregate; cid is gossiped via the round
        block (so every node can audit what was exchanged)."""
        cid = self.ipfs.put_tree(aggregate)
        self.register(round_index, cluster, cid)
        return cid

    def register(self, round_index: int, cluster: int, cid: str) -> None:
        """Register an already-stored aggregate's cid for a cluster. Lets
        heads that share one identical tree (e.g. the fully-synchronized
        global model) pay a single IPFS put and C cid registrations instead
        of C redundant serializations."""
        self._round_cids.setdefault(round_index, {})[cluster] = cid

    def round_transactions(self, round_index: int) -> List[dict]:
        return [{"type": "cluster_model", "round": round_index,
                 "cluster": c, "cid": cid}
                for c, cid in sorted(
                    self._round_cids.get(round_index, {}).items())]

    # -- cross-node transfer (repro.net) --------------------------------------

    def blob(self, round_index: int, cluster: int) -> "tuple[str, bytes]":
        """The raw stored bytes behind a published aggregate, with its
        cid — what a network node ships in an ``AggregateGossip`` so a
        peer with a *different* IPFS store can ingest it."""
        cid = self._round_cids[round_index][cluster]
        return cid, self.ipfs.read_blob(cid)

    def ingest(self, round_index: int, cluster: int, cid: str,
               blob: bytes) -> None:
        """Receive a gossiped aggregate: verify the bytes against their
        claimed content address (raises ``ValueError`` on mismatch —
        a tampering relay cannot forge a peer's aggregate), store them
        locally, and register the cid for this round/cluster."""
        if hashlib.sha256(blob).hexdigest() != cid:
            raise ValueError(f"content hash mismatch for {cid}")
        self.ipfs.put_blob(blob)
        self.register(round_index, cluster, cid)

    # -- requesting side ------------------------------------------------------

    def fetch(self, round_index: int, cluster: int, like):
        """Pull a peer cluster's aggregate by hash (content-verified) and
        restore it into ``like``'s keys, shapes and dtypes — tensors on
        ``like``'s device, or numpy arrays."""
        cid = self._round_cids[round_index][cluster]
        leaves = self.ipfs.get_leaves(cid)
        return {k: _restore(a, ll)
                for a, (k, ll) in zip(leaves, flatten_tree(like))}

    def merge(self, round_index: int, own_cluster: int, own_aggregate,
              peer_trust: Sequence[float], *, self_weight: float = 0.5):
        """Head folds peers' aggregates into its own: own stays at
        ``self_weight``; peers split the rest ∝ their mean trust. Skips
        peers that published nothing this round."""
        peers = [c for c in self._round_cids.get(round_index, {})
                 if c != own_cluster]
        if not peers:
            return own_aggregate
        w = np.asarray([max(float(peer_trust[c]), 0.0) for c in peers])
        if w.sum() <= 0:
            return own_aggregate
        w = w / w.sum() * (1.0 - self_weight)
        merged = {k: self_weight * _f32(x) for k, x in own_aggregate.items()}
        for c, wc in zip(peers, w):
            peer = self.fetch(round_index, c, own_aggregate)
            merged = {k: m + float(wc) * _f32(peer[k])
                      for k, m in merged.items()}
        return {k: _cast(m, own_aggregate[k]) for k, m in merged.items()}


def _restore(a: np.ndarray, like):
    """A fetched leaf in ``like``'s shape and dtype (and device)."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(a).reshape(like.shape)).to(
            device=like.device, dtype=like.dtype)
    like = np.asarray(like)
    return np.asarray(a).reshape(like.shape).astype(like.dtype)


def _f32(x):
    """f32 view of a leaf; numpy leaves stay numpy (an f32 array times a
    Python float stays f32, as in the reference)."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return np.asarray(x).astype(np.float32)


def _cast(m, like):
    if isinstance(like, torch.Tensor):
        return m.to(like.dtype)
    return m.astype(np.asarray(like).dtype)
