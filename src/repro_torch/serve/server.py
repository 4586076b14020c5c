"""Server half of the chain read path.

``ChainReadServer`` answers read queries over a *live* chain node while
its settler pool keeps appending blocks. It takes no locks; correctness
rests on the ledger's publication-order contract (see
``Ledger._seal``): a block's commit is registered before the block is
appended, appends are GIL-atomic, and sealed state is immutable. Every
read here therefore only ever sees fully-constructed, frozen data — a
reader can at worst be one block behind, never torn.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.chain.ipfs import QuotaExceeded
from repro_torch.chain.proofs import (BlockHeader, ProofBatch, build_proof_batch,
                                header_of)

__all__ = ["ChainReadServer", "HeadSync", "CheckpointManifest",
           "RoundNotSettled"]


class RoundNotSettled(LookupError):
    """The requested round has no sealed settlement block yet — the
    asynchronous settler simply hasn't gotten there. Retryable."""

    def __init__(self, task_id: Optional[str], round_index: int) -> None:
        super().__init__(
            f"round {round_index} of task {task_id!r} is not settled yet")
        self.task_id = task_id
        self.round_index = round_index


@dataclass(frozen=True)
class HeadSync:
    """Reply to a head-sync handshake. ``current`` means the client's
    claimed head is the chain head (``headers`` is empty); otherwise
    ``headers`` is the delta to append. ``reset`` means the claimed head
    was unknown (fork/garbage/genesis) and ``headers`` is the full chain
    to re-adopt from genesis."""

    current: bool
    headers: Tuple[BlockHeader, ...]
    reset: bool


@dataclass(frozen=True)
class CheckpointManifest:
    """Streaming plan for one content-addressed checkpoint blob:
    total ``size`` bytes served as ``num_chunks`` chunks of at most
    ``chunk_bytes`` each. The cid is the sha256 of the reassembled
    bytes — the client's end-to-end tamper check."""

    cid: str
    size: int
    chunk_bytes: int
    num_chunks: int


class ChainReadServer:
    """Batched proof-serving read API over a live chain node.

    Wraps either a :class:`~repro_torch.core.node.ChainNode` (tasks and their
    contracts are resolved live, so tasks added after the server exists
    are served too) or bare parts (``ledger`` + a ``contracts`` mapping
    and optional ``ipfs``) for chain-only deployments. All methods are
    safe to call from any number of reader threads concurrently with
    settlement — they never block the settler and the settler never
    blocks them."""

    def __init__(self, node=None, *, ledger=None, contracts=None,
                 ipfs=None, max_batch: int = 4096,
                 chunk_bytes: int = 1 << 18,
                 serve_quota_bytes: int = 0) -> None:
        if node is not None:
            ledger = node.ledger
            ipfs = node.ipfs if ipfs is None else ipfs
        elif contracts is not None and not isinstance(contracts, dict):
            contracts = {contracts.task_id: contracts}   # single contract
        if ledger is None and contracts:
            ledger = next(iter(contracts.values())).ledger
        if ledger is None:
            raise ValueError("need a node, a ledger, or a contract")
        if max_batch <= 0 or chunk_bytes <= 0 or serve_quota_bytes < 0:
            raise ValueError("max_batch/chunk_bytes must be positive, "
                             "serve_quota_bytes >= 0")
        self._node = node
        self.ledger = ledger
        self.ipfs = ipfs
        self._contracts = contracts or {}
        self.max_batch = max_batch
        self.chunk_bytes = chunk_bytes
        self.serve_quota_bytes = serve_quota_bytes
        self._quota_lock = threading.Lock()
        self.bytes_served_by_client: Dict[str, int] = {}
        # per-(contract, round) sorted-id index for sparse/partial rounds;
        # settled rounds are immutable, so cached entries never go stale
        self._pos_cache: Dict[Tuple[int, int],
                              Tuple[np.ndarray, np.ndarray]] = {}
        # serving stats (monotonic counters; approximate under races,
        # which is fine — they are telemetry, not consensus state)
        self.head_syncs = 0
        self.head_resets = 0
        self.proof_batches = 0
        self.proofs_served = 0
        self.digests_shipped = 0
        self.chunks_streamed = 0

    # -- task resolution -------------------------------------------------------

    def _contract(self, task_id: Optional[str]):
        """The live TrustContract for ``task_id`` (None → sole task)."""
        if self._node is not None:
            tasks = self._node.tasks
            if task_id is None:
                if len(tasks) != 1:
                    raise ValueError(
                        "task_id required on a multi-task node")
                task = next(iter(tasks.values()))
            else:
                task = tasks[task_id]
            contract = task.contract
        else:
            if task_id is None:
                if len(self._contracts) != 1:
                    raise ValueError(
                        "task_id required with multiple contracts")
                contract = next(iter(self._contracts.values()))
            else:
                contract = self._contracts[task_id]
        if contract is None:
            raise ValueError(f"task {task_id!r} runs without a contract")
        return contract

    # -- head sync -------------------------------------------------------------

    @property
    def height(self) -> int:
        return len(self.ledger.blocks)

    def sync_head(self, height: int = 0,
                  block_hash: Optional[str] = None) -> HeadSync:
        """O(1) handshake: the client claims ``(height, block_hash)``
        (its header count and last header's hash). If the claim matches
        our chain, the reply carries exactly the missing suffix —
        empty when the client is current. An unrecognized claim gets a
        full ``reset`` resync from genesis. Since ``repro_torch.net``, a
        reset is a *real signal*, not just corrupt client state: a
        fork-choice reorg (``Ledger.rollback_to`` + ``adopt_block``)
        replaces chain suffixes in place, so a client that last synced
        the losing fork presents a dead head and must re-verify from
        genesis — the sync_head-mismatch path is how a served replica
        observes its upstream's reorg (counted in ``head_resets``)."""
        self.head_syncs += 1
        blocks = self.ledger.blocks        # snapshot ref; append-only
        n = len(blocks)
        if 0 < height <= n and blocks[height - 1].hash == block_hash:
            delta = blocks[height:n]
            return HeadSync(current=not delta,
                            headers=tuple(header_of(b) for b in delta),
                            reset=False)
        self.head_resets += 1
        return HeadSync(current=False,
                        headers=tuple(header_of(b) for b in blocks[:n]),
                        reset=True)

    # -- settlement proofs -----------------------------------------------------

    def latest_settled_round(self, task_id: Optional[str] = None) -> int:
        """Highest round whose settlement block is published. Retries
        the (lock-free) dict scan if the settler mutates the round map
        mid-iteration; raises ``RoundNotSettled`` when no round of the
        task has ever settled."""
        contract = self._contract(task_id)
        n = len(self.ledger.blocks)
        while True:
            try:
                best = -1
                for r, bi in contract._round_blocks.items():
                    if bi < n and r > best:
                        best = r
                break
            except RuntimeError:           # dict grew during iteration
                continue
        if best < 0:
            raise RoundNotSettled(task_id, -1)
        return best

    def _positions(self, contract, round_index: int,
                   worker_ids: Sequence[int]) -> np.ndarray:
        """Record positions of ``worker_ids`` inside the round's
        settlement block. Full-participation rounds are the identity
        (record index == worker id); sparse rounds binary-search the
        round's sorted id vector."""
        wids = np.asarray(worker_ids, np.int64)
        if wids.ndim != 1 or len(wids) == 0:
            raise ValueError("worker_ids must be a non-empty 1-d sequence")
        if contract._round_full_cover.get(round_index):
            if len(wids) and (wids.min() < 0
                              or wids.max() >= contract.num_workers):
                raise KeyError("worker id out of range for round")
            return wids
        ckey = (id(contract), round_index)
        cached = self._pos_cache.get(ckey)
        if cached is None:
            ids = contract._round_ids[round_index]  # immutable once noted
            order = np.argsort(ids, kind="stable")
            cached = self._pos_cache[ckey] = (ids[order], order)
        sids, order = cached
        at = np.searchsorted(sids, wids)
        ok = (at < len(sids)) & (sids[np.minimum(at, len(sids) - 1)]
                                 == wids)
        if not ok.all():
            missing = wids[~ok][:5].tolist()
            raise KeyError(
                f"workers {missing} have no record in round {round_index}")
        return order[at]

    def get_proofs(self, task_id: Optional[str],
                   worker_ids: Sequence[int],
                   round_index: Optional[int] = None) -> ProofBatch:
        """One deduplicated multiproof covering ``worker_ids``'s
        settlement records for ``round_index`` (default: latest settled)
        of ``task_id``. Raises ``RoundNotSettled`` for unsettled rounds,
        ``KeyError`` for workers absent from a sparse round, and
        ``ValueError`` for oversized batches."""
        if len(worker_ids) > self.max_batch:
            raise ValueError(
                f"batch of {len(worker_ids)} exceeds max_batch="
                f"{self.max_batch}")
        contract = self._contract(task_id)
        if round_index is None:
            round_index = self.latest_settled_round(task_id)
        block_index = contract._round_blocks.get(round_index)
        if block_index is None or block_index >= len(self.ledger.blocks):
            raise RoundNotSettled(task_id, round_index)
        pos = self._positions(contract, round_index, worker_ids)
        batch = build_proof_batch(self.ledger, block_index, pos,
                                  task_id=contract.task_id,
                                  worker_ids=worker_ids,
                                  round_index=round_index)
        self.proof_batches += 1
        self.proofs_served += len(batch)
        self.digests_shipped += batch.num_digests
        return batch

    # -- checkpoint streaming --------------------------------------------------

    def _ipfs(self):
        if self.ipfs is None:
            raise ValueError("this server has no artifact store attached")
        return self.ipfs

    def checkpoint_manifest(self, cid: str) -> CheckpointManifest:
        """Chunking plan for streaming the blob behind ``cid``."""
        size = self._ipfs().blob_size(cid)
        num = max(1, -(-size // self.chunk_bytes))
        return CheckpointManifest(cid=cid, size=size,
                                  chunk_bytes=self.chunk_bytes,
                                  num_chunks=num)

    def checkpoint_chunk(self, cid: str, index: int,
                         client_id: Optional[str] = None) -> bytes:
        """One bounded byte-range of the blob behind ``cid``. With a
        ``serve_quota_bytes`` budget configured, each ``client_id``'s
        cumulative streamed bytes are capped (``QuotaExceeded``) — the
        read-side mirror of the store's per-owner put quotas."""
        store = self._ipfs()
        size = store.blob_size(cid)
        start = index * self.chunk_bytes
        if index < 0 or start >= size:
            raise IndexError(f"chunk {index} out of range for {cid}")
        stop = min(start + self.chunk_bytes, size)
        if self.serve_quota_bytes and client_id is not None:
            with self._quota_lock:
                used = self.bytes_served_by_client.get(client_id, 0)
                if used + (stop - start) > self.serve_quota_bytes:
                    raise QuotaExceeded(client_id, used, stop - start,
                                        self.serve_quota_bytes)
                self.bytes_served_by_client[client_id] = \
                    used + (stop - start)
        self.chunks_streamed += 1
        return store.read_blob(cid, start, stop)
