"""SDFLBProtocol — one-task compatibility wrapper over a private
``ChainNode`` (see ``repro_torch.core.node``, where the orchestration now
lives).

Historically this module held the whole host-level driver: enrollment +
staking, the ``fl_step`` dispatch, trust scoring + on-chain
settlement, IPFS publication, head rotation from on-chain randomness,
the background settler pool, and the sharded Merkle commits. The
multi-tenant refactor carved that into two layers — ``ChainNode`` (the
shared chain substrate: ledger, IPFS store, shard worker pool, cross-task
settlement scheduler) and ``FederatedTask`` (everything task-scoped) —
because the paper's blockchain is shared infrastructure: many federated
tasks settle on one chain.

``SDFLBProtocol`` keeps the original single-task API intact by driving a
private node with exactly one task: ``run_round`` is a one-task
``run_tick``, and every attribute of the old protocol (``ledger``,
``contract``, ``history``, ``heads``, ``reputation``, ``global_params``,
``_shard_pool``, …) resolves onto the task or the node. With one task,
every block hash, proof, election, penalty, and payout is bit-identical
to the pre-refactor sharded driver — the single-task tick seals the exact
single-tenant block layout (property-tested in
``tests/test_multi_task_node.py`` and pinned by the serial-vs-threaded
equivalence tests).

Pipelining semantics are unchanged: ``run_round`` dispatches round r's
step, hands round r−1's host chain work to the node's settler
(``fed.pipeline_depth``; 0 settles inline, reproducing the serial
reference driver), and blocks only where round r's on-chain randomness
consumes round r−1's block head. Settled state (ledger blocks, contract
balances, reputation, per-round ``penalties``/``model_cid``/
``settle_time``) is written by the settler thread; read it after
``flush()`` (idempotent, safe mid-queue), or rely on rounds ≤ r−1 being
settled once ``run_round(r)`` returns whenever head rotation consumes
chain heads. Settler exceptions re-raise on the training thread at the
next ``run_round``/``flush`` (now as ``TaskSettlementError``, naming the
task and the failing round).

Sparse settlement rides the same API: with ``fed.sparse_settlement`` the
``participation`` mask passed to ``run_round`` doubles as the round's
settlement *changed set* — only participating workers' records re-hash
into the block's delta commit (see ``chain.contract``), while every block
still commits and proves the full population. ``ipfs_owner_quota_bytes``
caps this task's logical bytes on the artifact store (``QuotaExceeded``
surfaces as a ``TaskSettlementError``).

Event-driven mode: construct with ``fed.async_mode=True`` and
``arrival_profiles`` (one ``async_sim.WorkerProfile`` per worker), then
drive with ``run_events(batch_fn, events=N)`` — the single-task view of
``ChainNode.run_events`` (arrival frontier → staleness-weighted aggregate
→ cohort seal; see ``repro_torch.core.node``).

Device: ``SDFLBProtocol(..., device=None)`` runs on ``cuda`` unless the
caller passes another device (``"cpu"`` for the tests); it raises when no
CUDA device is present and none was asked for.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import FederationConfig, ModelConfig, \
    TrainConfig
# re-exports: these classes lived here before the multi-tenant refactor
from repro_torch.core.node import (ChainNode, FederatedTask, RoundRecord,
                                   ShardWorkerPool, TaskSettlementError,
                                   _PendingRound, _SettlerPool)

__all__ = ["SDFLBProtocol", "ChainNode", "FederatedTask", "RoundRecord",
           "ShardWorkerPool", "TaskSettlementError", "_PendingRound",
           "_SettlerPool"]


class SDFLBProtocol:
    """One federated task on a private single-tenant ``ChainNode``.
    ``use_blockchain=False`` reproduces the paper's Fig. 2 ablation
    (identical learning dynamics, no chain work)."""

    def __init__(self, cfg: ModelConfig, fed: FederationConfig,
                 tc: TrainConfig, *, use_blockchain: bool = True,
                 seed: int = 0,
                 adversary=None,
                 reputation_leaders: bool = False,
                 ipfs_owner_quota_bytes: int = 0,
                 arrival_profiles=None,
                 device=None) -> None:
        self._node = ChainNode(use_blockchain=use_blockchain,
                               pipeline_depth=fed.pipeline_depth,
                               settler_pool_size=fed.settler_pool_size,
                               ipfs_owner_quota_bytes=ipfs_owner_quota_bytes,
                               device=device)
        self._task = self._node.create_task(
            fed.task_id, cfg, fed, tc, seed=seed, adversary=adversary,
            reputation_leaders=reputation_leaders,
            profiles=arrival_profiles)

    # everything the old monolithic protocol exposed lives on the task
    # (model/contract/history/reputation/...) or the node (ledger/ipfs/
    # _shard_pool/...) — resolve attribute reads AND writes there, task
    # first, so post-construction tweaks like `proto.fed = replace(...)`
    # or `proto.adversary = fn` keep reaching the state the driver reads
    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        d = self.__dict__
        for obj in (d.get("_task"), d.get("_node")):
            if obj is not None and hasattr(obj, name):
                return getattr(obj, name)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    def __setattr__(self, name: str, value) -> None:
        if not name.startswith("_"):
            d = self.__dict__
            for obj in (d.get("_task"), d.get("_node")):
                # forward plain instance attributes only (properties like
                # .ledger live on the class and stay read-only)
                if obj is not None and name in getattr(obj, "__dict__", {}):
                    setattr(obj, name, value)
                    return
        object.__setattr__(self, name, value)

    @property
    def node(self) -> ChainNode:
        """The underlying (single-tenant) chain node."""
        return self._node

    @property
    def task(self) -> FederatedTask:
        """The underlying task handle."""
        return self._task

    # -- one full protocol round ----------------------------------------------

    def run_round(self, batch: Dict[str, np.ndarray],
                  participation: Optional[np.ndarray] = None) -> RoundRecord:
        """batch leaves: (W, B, ...) — a single local step per round
        (paper's setup). One single-task node tick."""
        tid = self._task.task_id
        recs = self._node.run_tick(
            {tid: batch},
            participation=None if participation is None
            else {tid: participation})
        return recs[tid]

    def run_events(self, batch_fn, *, events: int) -> list:
        """Event-driven driver (``ChainNode.run_events``) for this one
        task: needs ``fed.async_mode`` and ``arrival_profiles`` at
        construction. ``batch_fn(round_index) → batch`` is called lazily
        per event. Returns this task's new ``RoundRecord`` list."""
        tid = self._task.task_id
        return self._node.run_events({tid: batch_fn}, events=events)[tid]

    def flush(self) -> None:
        """Settle every round still in flight: hand off the trailing
        pending round and drain the settler queue. Idempotent and safe to
        call mid-queue (no-op when nothing is pending)."""
        self._node.flush()

    # -- evaluation ------------------------------------------------------------

    def evaluate(self, eval_batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        return self._task.evaluate(eval_batch)

    def evaluate_per_worker(self, batch_w: Dict[str, np.ndarray]):
        """Per-worker eval accuracy of the *global* model on each worker's
        local shard (the per-worker curves of Figs. 5/6)."""
        return self._task.evaluate_per_worker(batch_w)

    def finalize(self) -> Dict[str, float]:
        payouts = self._task.finalize(
            timestamp=float(len(self._task.history) + 1))
        self._node.close()         # stops the settler and shard workers
        return payouts
