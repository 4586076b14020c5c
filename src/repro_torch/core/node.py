"""ChainNode — a multi-tenant chain node serving N concurrent federated
tasks on one ledger with fair cross-task settlement.

The paper's SDFL-B design treats the blockchain layer as shared
infrastructure: many collaborative learning tasks settle on the same
chain. This module is that substrate, split into two layers:

``ChainNode`` owns the chain-side singletons — the ``Ledger``, the
``IPFSStore``, one shared ``ShardWorkerPool`` of shard-hashing threads,
and the cross-task settlement scheduler (``_SettlerPool``). A per-task
``FederatedTask`` handle owns everything task-scoped: model/optimizer
state, the round function, its ``TrustContract`` (deployed on the
node's ledger under its ``task_id``), reputation, cluster exchange, and
round history. ``repro_torch.core.protocol.SDFLBProtocol`` is a thin one-task
compatibility wrapper over a private node.

Ticks and blocks. The node is driven in *ticks*: ``run_tick(batches)``
runs one round for every task that fires this tick (tasks may run at
independent, asynchronous cadences — simply omit a task from a tick), and
all rounds of one tick settle into ONE block committing the canonical
``task_id → super-root`` map (``MultiTaskCommit`` in ``chain.ledger``).
Settlement proofs are three-level — chunk-in-shard, shard-in-task,
task-in-block — and ``verify_chain(deep=True)`` recurses through tasks.
A tick in which a single task fires seals a bit-identical block to the
single-tenant driver (no ``task_roots`` in the hashed body, no ``task``
tag on transactions), so an N=1 node reproduces the single-task sharded driver's
chain byte for byte (property-tested).

Fairness and determinism. Within a tick, tasks are processed in canonical
(sorted ``task_id``) order and their contract-shard thunks are interleaved
round-robin — shard 0 of every task, then shard 1, … — through the shared
pool, so no task's settlement starves behind a bigger co-tenant. Ticks
drain FIFO through a bounded queue (``pipeline_depth``), so every
submitted round settles within its tick: ordering is seed-reproducible
and starvation-free by construction. Each task's round-r head rotation
consumes the head of the block that settled *its own* round r−1
(published per (task, round) by the scheduler), never the racy live
chain head.

Failure isolation. A failing shard aborts only its own task's round:
shard thunks are pure, so the failing task's state and commit are simply
excluded from the tick's block while co-tenant tasks settle normally.
The failure is sticky *per task* — the task's later queued rounds are
drained and discarded, and every subsequent interaction with that task
raises a ``TaskSettlementError`` carrying the failing ``task_id`` and
round index. Only a failure of the shared block seal itself (after every
surviving task's merge) poisons the whole node.

Event-driven settlement (the paper's §III.E async pillar, first-class).
``run_events`` replaces the lockstep tick cadence with an *arrival
frontier*: each async task owns an ``async_sim.AsyncScheduler`` (its
per-task simulated clock — heavy-tailed speeds, jitter, dropout), and the
node repeatedly pops the task whose next aggregation event is earliest in
simulated time, then runs ONE round for THAT task only: arrival frontier →
staleness-weighted aggregate → cohort seal. The arrived cohort is the
round's participation mask, the round weights it by trust ×
``(1+staleness)^-alpha`` (``core.async_agg``), and settlement seals
exactly that cohort — under ``sparse_settlement`` as a ``DeltaCommit``
whose changed set is the cohort, so idle workers stay proof-covered while
the seal costs O(cohort), not O(W). Each worker's pre-round staleness is
mirrored host-side (``FederatedTask.staleness``, kept in lockstep with the
device ``AsyncState``) and recorded in the on-chain settlement records, so
staleness-discounted penalties and payouts are auditable. Slow tasks never
stall fast ones: a straggling co-tenant simply has later event times, and
every event seals independently through the same settler pipeline as
``run_tick``. The degenerate case — every worker arrives every event,
staleness identically 0 — is bit-identical to driving ``run_tick`` with
full participation (property-tested: block hashes, penalties, payouts,
elections).

Device side (the port). The round runs eagerly on the node's ``device``
(``cuda`` unless the caller passes ``device="cpu"``): each task draws its
dropout masks from a ``torch.Generator`` seeded per task, batches go to the
card through pinned ``non_blocking`` copies, and the round's scores,
weights and losses come back through pinned ``non_blocking`` copies behind
one recorded CUDA event, which ``_finish_round`` waits on — the only
training-path sync point. The chain side is the reference's, copied,
with its ``repro_torch.serve`` / ``repro_torch.net`` seams
(``read_server``, ``add_seal_listener``, ``ingest_peer_blocks``).
"""
from __future__ import annotations

import heapq
import os
import queue
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.chain.contract import RoundPrep, ShardSettlement, \
    TrustContract
from repro_torch.chain.ipfs import IPFSStore
from repro_torch.chain.ledger import Ledger
from repro_torch.configs.base import FederationConfig, ModelConfig, \
    TrainConfig
from repro_torch.core import async_agg, fl_step
from repro_torch.core.async_sim import AsyncScheduler, WorkerProfile
from repro_torch.core.gossip import ClusterExchange
from repro_torch.core.reputation import ReputationBook
from repro_torch.device import resolve_device
from repro_torch.models import api


class TaskSettlementError(RuntimeError):
    """One task's round failed to settle. Carries the failing ``task_id``
    and ``round_index``; co-tenant tasks on the same node are unaffected
    (their rounds keep settling), while this task's later rounds are
    discarded and every further interaction with it re-raises."""

    def __init__(self, task_id: str, round_index: int,
                 note: str = "background chain settlement failed") -> None:
        super().__init__(
            f"task {task_id!r} round {round_index}: {note}; the task's "
            f"settler lane has stopped (its unsettled rounds were "
            f"discarded)")
        self.task_id = task_id
        self.round_index = round_index


@dataclass
class RoundRecord:
    round_index: int
    scores: np.ndarray
    weights: np.ndarray
    losses: np.ndarray
    penalties: np.ndarray          # (W,) settlement penalties; zeros until
                                   # the round is settled (pipelined driver)
    heads: List[int]
    model_cid: str                 # "" until settled
    wall_time: float
    chain_time: float              # chain work charged to the training
                                   # thread during this tick (threaded
                                   # settler: the queue handoff only)
    participation: Optional[np.ndarray] = None
    staleness: Optional[np.ndarray] = None  # (W,) pre-round staleness of each
                                   # worker's update (event-driven rounds;
                                   # None on sync rounds) — what the
                                   # settlement records commit on-chain
    sim_time: float = 0.0          # simulated event time this round sealed
                                   # at (run_events; 0.0 under run_tick)
    arrival_times: Optional[np.ndarray] = None  # (W,) simulated arrival
                                   # instant of each cohort update (NaN off
                                   # the cohort); sim_time - arrival_times
                                   # is per-update settlement latency
    settled: bool = False
    settle_time: float = 0.0       # host chain work on the settler thread
                                   # (contract + Merkle + IPFS); set when
                                   # the round settles


@dataclass
class _PendingRound:
    record: RoundRecord
    params: Any                    # round's resulting global params (device);
                                   # None when running without a chain
    scores: np.ndarray


@dataclass
class _TickPending:
    """One tick's worth of rounds awaiting settlement: the unit the
    scheduler queues, settles, and seals into one block."""
    tick: int
    entries: List[Tuple[str, _PendingRound]]   # (task_id, pending), sorted


@dataclass
class _StartedRound:
    """A dispatched-but-unfinished round: the device is computing, the
    host has not yet rotated heads or synced scores."""
    round_index: int
    out: Any
    t0: float
    participation: Optional[np.ndarray]
    staleness: Optional[np.ndarray] = None   # pre-round host staleness mirror
    host: Optional[Dict[str, torch.Tensor]] = None   # scores/weights/losses
                                   # landing in host memory (pinned on CUDA)
    ready: Optional[Any] = None    # CUDA event recorded after those copies


class ShardWorkerPool:
    """N shard-worker threads, each draining its own task queue.

    ``map`` fans one batch of shard thunks out — thunk i always lands on
    queue i mod N, so with the node's round-robin interleave consecutive
    thunks (= different tasks' shards) spread across workers and a given
    slot stays FIFO across rounds — and blocks at the merge barrier until
    every thunk finished, then re-raises the lowest-index failure
    (deterministic, whichever thread hit it first). ``map_collect``
    returns per-thunk ``("ok", value)`` / ``("err", exc)`` outcomes
    instead of raising, which is what lets a multi-task node fail one
    task's shards without discarding its co-tenants' results. Thunks must
    be pure compute (the contract's ``settle_shard`` mutates nothing), so
    dropping a failed task's sibling results is safe.

    Workers hold only a weak reference to the pool and wake periodically
    while idle, so an abandoned (never-finalized) node's shard threads
    exit instead of living for the rest of the process."""

    _IDLE_POLL_S = 2.0

    def __init__(self, num_threads: int) -> None:
        self.num_threads = max(1, int(num_threads))
        self._queues: List["queue.Queue"] = [queue.Queue()
                                             for _ in range(self.num_threads)]
        self._stopped = False
        ref = weakref.ref(self)
        self._threads = [
            threading.Thread(target=self._work, args=(q, ref), daemon=True,
                             name=f"sdflb-shard-worker-{i}")
            for i, q in enumerate(self._queues)]
        for t in self._threads:
            t.start()

    @staticmethod
    def _work(q: "queue.Queue", pool_ref: "weakref.ref") -> None:
        while True:
            try:
                item = q.get(timeout=ShardWorkerPool._IDLE_POLL_S)
            except queue.Empty:
                if pool_ref() is None:         # owner got collected
                    return
                continue
            if item is None:                   # stop sentinel
                return
            fn, i, out, cv, remaining = item
            try:
                out[i] = ("ok", fn())
            except BaseException as e:
                out[i] = ("err", e)
            finally:
                del fn, item                   # don't pin results while idle
                with cv:
                    remaining[0] -= 1
                    cv.notify_all()

    def start_collect(self, thunks):
        """Enqueue ``thunks[i]`` on worker i mod N and return immediately
        with a handle for ``finish_collect`` — lets the caller overlap its
        own work with the pool's."""
        if self._stopped:
            raise RuntimeError("shard pool already stopped")
        thunks = list(thunks)
        out: list = [None] * len(thunks)
        cv = threading.Condition()
        remaining = [len(thunks)]
        for i, fn in enumerate(thunks):
            self._queues[i % self.num_threads].put((fn, i, out, cv,
                                                    remaining))
        return out, cv, remaining

    @staticmethod
    def finish_collect(handle) -> list:
        """Block at the merge barrier of a ``start_collect`` handle; return
        the in-order list of per-thunk outcomes ``("ok", value)`` /
        ``("err", exception)`` (never raises for a thunk failure)."""
        out, cv, remaining = handle
        with cv:
            cv.wait_for(lambda: remaining[0] == 0)
        return out

    def map_collect(self, thunks) -> list:
        """``start_collect`` + ``finish_collect`` in one call."""
        return self.finish_collect(self.start_collect(thunks))

    def map(self, thunks) -> list:
        """Like ``map_collect`` but returns the bare results, raising the
        first (by index) failure after all thunks finished."""
        out = self.map_collect(thunks)
        for tag, val in out:
            if tag == "err":
                raise val
        return [val for _, val in out]

    def stop(self) -> None:
        """Terminate the workers (idempotent); outstanding queue items run
        first since the sentinel sits behind them."""
        if self._stopped:
            return
        self._stopped = True
        for q in self._queues:
            q.put(None)
        for t in self._threads:
            t.join()


# -- cross-task block settlement ----------------------------------------------


@dataclass
class TaskRoundWork:
    """One task's round as handed to ``settle_tasks_block``: the contract,
    the validated score vector, and the (already published) model cid."""
    task_id: str
    contract: TrustContract
    round_index: int
    scores: np.ndarray
    model_cid: str = ""
    worker_ids: Optional[np.ndarray] = None
    staleness: Optional[np.ndarray] = None   # aligned with scores


def _interleave_shard_thunks(task_order: List[str],
                             preps: Dict[str, RoundPrep]
                             ) -> List[Tuple[str, int, Callable]]:
    """Round-robin schedule across tasks: shard 0 of every task (in
    canonical task order), then shard 1, … — the fairness rule that keeps
    a small task's settlement from starving behind a big co-tenant."""
    sched: List[Tuple[str, int, Callable]] = []
    depth = 0
    while True:
        layer = [(tid, depth, preps[tid].thunks[depth])
                 for tid in task_order if depth < len(preps[tid].thunks)]
        if not layer:
            return sched
        sched.extend(layer)
        depth += 1


def settle_tasks_block(ledger: Ledger, work: List[TaskRoundWork],
                       timestamp: Optional[float] = None,
                       pool: Optional[ShardWorkerPool] = None
                       ) -> Tuple[Optional[Any], Dict[str, np.ndarray],
                                  Dict[str, BaseException]]:
    """Settle several tasks' rounds into ONE multi-task block.

    Per task: prepare (validation + pure shard thunks) → shard fan-out →
    deterministic merge → one shared block seal committing every surviving
    task's super-root under the canonical ``task_id → super-root`` map.
    Shard thunks of tasks whose leaves clear the contract's GIL gate are
    interleaved round-robin through the shared ``pool`` (deterministic
    results either way — the pool only changes who hashes); the rest run
    inline on the calling thread.

    Shard re-planning: the node owns the fan-out budget. When N tasks
    share the pool, each pooled task's shard count is re-planned to
    ``min(its settlement_shards, ceil(2·pool_threads / N))`` so the total
    thunk count stays matched to the pool — cross-task parallelism
    replaces within-task parallelism as N grows, instead of N·S micro
    thunks convoying on the GIL. This is consensus-invisible: shard
    boundaries are subtree-aligned, so the committed super-roots, proofs,
    and block hashes are identical for every execution granularity
    (property-tested).

    Failure isolation: a task failing in prepare or in any of its shard
    thunks is excluded from the block with *nothing* of it applied or
    committed (shard thunks are pure; its merge never runs), while the
    surviving tasks settle normally. Returns ``(block, penalties_by_task,
    errors_by_task)`` — ``block`` is None when no task survived. With one
    task in ``work`` the sealed block is bit-identical to that task's
    ``settle_round_batch``. Only a failure of the shared seal itself
    raises (node-fatal)."""
    work = sorted(work, key=lambda w: w.task_id)
    if len({w.task_id for w in work}) != len(work):
        raise ValueError("duplicate task_id in one settlement block")
    errors: Dict[str, BaseException] = {}
    preps: Dict[str, RoundPrep] = {}
    results: Dict[str, List[ShardSettlement]] = {}
    pooled: List[str] = []
    inline: List[str] = []
    # fan-out budget: tasks that want the pool split ~2 thunks per worker
    # thread between them (consensus-invisible — see the docstring)
    pool_wanting = [w.task_id for w in work
                    if pool is not None
                    and w.contract.settlement_shards > 1
                    and w.contract.parallel_leaf_ok()]
    eff_shards: Dict[str, int] = {}
    if pool_wanting:
        per = max(1, -(-2 * pool.num_threads // len(pool_wanting)))
        for w in work:
            if w.task_id in pool_wanting:
                eff_shards[w.task_id] = min(w.contract.settlement_shards,
                                            per)
    for w in work:
        try:
            preps[w.task_id] = w.contract.prepare_round_batch(
                w.round_index, w.scores, w.worker_ids,
                shards=eff_shards.get(w.task_id),
                staleness=w.staleness)
        except BaseException as e:
            errors[w.task_id] = e
            continue
        if w.task_id in eff_shards:
            pooled.append(w.task_id)   # even a 1-thunk task: parallel
        else:                          # ACROSS tasks through the pool
            inline.append(w.task_id)

    # enqueue the pooled fan-out first, run the inline tasks' thunks on
    # the calling thread while the workers hash, then collect at the merge
    # barrier: tick latency is max(pool, inline), not their sum
    sched = _interleave_shard_thunks(pooled, preps) if pooled else []
    handle = pool.start_collect([t for _, _, t in sched]) if sched else None
    for tid in inline:
        try:
            results[tid] = [t() for t in preps[tid].thunks]
        except BaseException as e:
            errors[tid] = e
    if handle is not None:
        out = pool.finish_collect(handle)
        shard_res: Dict[str, List[Optional[ShardSettlement]]] = {
            tid: [None] * len(preps[tid].thunks) for tid in pooled}
        shard_err: Dict[str, Tuple[int, BaseException]] = {}
        for (tid, i, _), (tag, val) in zip(sched, out):
            if tag == "ok":
                shard_res[tid][i] = val
            elif tid not in shard_err or i < shard_err[tid][0]:
                shard_err[tid] = (i, val)      # lowest-shard-index failure
        for tid in pooled:
            if tid in shard_err:
                errors[tid] = shard_err[tid][1]
            else:
                results[tid] = shard_res[tid]

    survivors = [w for w in work if w.task_id in results]
    penalties: Dict[str, np.ndarray] = {}
    seals = {}
    for w in survivors:
        seal = w.contract.finish_round_batch(
            preps[w.task_id], results[w.task_id], model_cid=w.model_cid)
        seals[w.task_id] = seal
        penalties[w.task_id] = seal.penalties
    if not seals:
        return None, penalties, errors
    if len(seals) == 1:
        # single-task tick: the exact single-tenant block layout (no task
        # tags, no task_roots map) — bit-identical to settle_round_batch
        (tid, seal), = seals.items()
        blk = ledger.append_block(
            seal.txs, timestamp=timestamp,
            record_shards=seal.shards or None,
            shard_trees=seal.trees or None,
            record_delta=seal.delta,
            chunk_size=seal.chunk_size, task_id=tid)
    else:
        txs = [{**tx, "task": tid}
               for tid, seal in seals.items() for tx in seal.txs]
        # a sparse task contributes its prebuilt incremental commit;
        # dense co-tenants build theirs from the shard parts as before
        commits = {tid: seal.delta if seal.delta is not None
                   else Ledger._build_commit(None, seal.shards or None,
                                             seal.trees or None,
                                             seal.chunk_size)
                   for tid, seal in seals.items()}
        blk = ledger.append_multi_block(txs, timestamp, commits)
    # O(1) integrity check of the block just sealed (linkage + recomputed
    # hash) — a full verify_chain here would be O(R^2) over a run
    if blk.prev_hash != ledger.blocks[blk.index - 1].hash \
            or blk.hash != blk.compute_hash():
        raise RuntimeError(f"block {blk.index} failed verification "
                           f"after sealing tick settlement")
    for w in survivors:
        w.contract.note_block(w.round_index, preps[w.task_id].ids, blk.index)
    return blk, penalties, errors


# -- the cross-task settlement scheduler --------------------------------------


_FATAL_NOTE = ("chain node settlement failed; the settler has stopped "
               "(unsettled rounds were discarded)")


class _SettlerPool:
    """Background cross-task settlement scheduler: a coordinator daemon
    thread consuming a bounded FIFO queue of pending *ticks*, settling
    each tick's tasks through ``ChainNode._settle_tick`` (which fans every
    task's contract shards round-robin through the shared
    ``ShardWorkerPool`` and seals one block at the merge barrier), and
    publishing the resulting chain head per (task, round).

    The training thread interacts through ``submit`` (the queue handoff —
    blocks only when ``depth`` ticks are already in flight),
    ``wait_task(task_id, r)`` (returns the head of the block that settled
    that task's round r — the only point the pipeline couples back to
    chain state, because round r+1's on-chain randomness needs it), and
    ``flush``. With ``depth == 0`` there is no thread: ``submit`` settles
    the tick inline on the caller (the serial reference driver).

    Failures are sticky *per task*: a task whose round failed keeps its
    co-tenants settling, but its own later rounds are drained and
    discarded and every interaction with it raises a
    ``TaskSettlementError`` naming the task and the failing round. A
    failure of the shared seal itself (raised out of ``_settle_tick``) is
    node-fatal and poisons every interaction.

    The node is held through a weak reference and the worker wakes
    periodically while idle, so an abandoned (never-closed) node is still
    garbage-collectable and its settler thread exits instead of pinning
    params/ledger for the life of the process."""

    _IDLE_POLL_S = 2.0

    def __init__(self, settle_fn: Callable[["_TickPending"], list],
                 depth: int) -> None:
        # weak: the thread must not keep the owning node alive
        self._settle = weakref.WeakMethod(settle_fn)
        self._threaded = depth > 0
        self._cv = threading.Condition()
        self._submitted_tick = -1
        self._settled_tick = -1
        self._task_settled: Dict[str, int] = {}
        self._task_heads: Dict[str, Dict[int, str]] = {}
        self._task_errors: Dict[str, Tuple[int, BaseException]] = {}
        self._error: Optional[BaseException] = None
        self._stopped = False
        self._thread = None
        if self._threaded:
            self._q: "queue.Queue" = queue.Queue(maxsize=depth)
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="sdflb-settler-coordinator")
            self._thread.start()

    def register_task(self, task_id: str,
                      initial_head: Optional[str]) -> None:
        """Seed a task's head bookkeeping: its round −1 'head' is the chain
        head at registration (genesis on a fresh node) — what round 0's
        rotation consumes."""
        with self._cv:
            self._task_settled[task_id] = -1
            self._task_heads[task_id] = ({-1: initial_head}
                                         if initial_head is not None else {})

    # -- worker side ---------------------------------------------------------

    def _mark_discarded(self, tp: "_TickPending") -> None:
        with self._cv:
            for tid, p in tp.entries:
                self._task_settled[tid] = max(
                    self._task_settled.get(tid, -1), p.record.round_index)
            self._settled_tick = max(self._settled_tick, tp.tick)
            self._cv.notify_all()

    def _apply(self, tick: int, outcomes: list) -> None:
        with self._cv:
            for tid, ridx, head, err in outcomes:
                if err is not None and tid not in self._task_errors:
                    self._task_errors[tid] = (ridx, err)
                self._task_settled[tid] = max(
                    self._task_settled.get(tid, -1), ridx)
                if head is not None:
                    self._task_heads.setdefault(tid, {})[ridx] = head
            self._settled_tick = max(self._settled_tick, tick)
            self._cv.notify_all()

    def _settle_or_poison(self, tp: "_TickPending") -> None:
        """Run one tick through the node's settle, recording per-task
        outcomes; an exception escaping the settle itself is node-fatal."""
        settle = self._settle()
        if settle is None:                     # owner got collected
            self._mark_discarded(tp)
            return
        with self._cv:
            fatal = self._error is not None
        if fatal:
            # after a node-fatal failure drain-and-discard: never commit
            # later ticks on top of a half-settled chain, but keep waking
            # flush()/wait callers
            self._mark_discarded(tp)
            return
        try:
            outcomes = settle(tp)
        except BaseException as e:             # sticky; surfaced on the
            with self._cv:                     # training thread
                self._error = e
            self._mark_discarded(tp)
            return
        self._apply(tp.tick, outcomes)

    def _loop(self) -> None:
        while True:
            try:
                tp = self._q.get(timeout=self._IDLE_POLL_S)
            except queue.Empty:
                if self._settle() is None:     # owner got collected
                    return
                continue
            if tp is None:                     # stop sentinel
                return
            try:
                self._settle_or_poison(tp)
            finally:
                # frame locals survive across iterations — dropping them
                # keeps the idle thread from pinning the node (and settled
                # rounds' params) against garbage collection
                del tp

    # -- training-thread side ------------------------------------------------

    def _check_fatal(self) -> None:
        if self._error is not None:
            raise RuntimeError(_FATAL_NOTE) from self._error

    def _check_task(self, task_id: str) -> None:
        if task_id in self._task_errors:
            ridx, e = self._task_errors[task_id]
            raise TaskSettlementError(task_id, ridx) from e

    def check_task(self, task_id: str) -> None:
        """Raise this task's sticky settlement error (or the node-fatal
        one) if any; no-op for a healthy task."""
        with self._cv:
            self._check_fatal()
            self._check_task(task_id)

    def task_error(self, task_id: str
                   ) -> Optional[Tuple[int, BaseException]]:
        with self._cv:
            return self._task_errors.get(task_id)

    def submit(self, tp: "_TickPending") -> None:
        with self._cv:
            self._check_fatal()
            if self._stopped:
                raise RuntimeError("settler already stopped")
            self._submitted_tick = tp.tick
        if self._threaded:
            self._q.put(tp)                    # bounded: backpressure
        else:
            self._settle_or_poison(tp)         # inline reference driver
            with self._cv:
                fatal = self._error is not None
            if fatal:
                self._check_fatal()

    def wait_task(self, task_id: str, round_index: int) -> Optional[str]:
        """Block until the task's ``round_index`` is settled; return the
        hash of the block that settled it (None when running without a
        ledger)."""
        with self._cv:
            self._cv.wait_for(
                lambda: self._task_settled.get(task_id, -1) >= round_index
                or task_id in self._task_errors or self._error is not None)
            self._check_fatal()
            self._check_task(task_id)
            heads = self._task_heads.setdefault(task_id, {})
            head = heads.get(round_index)
            # prune heads no one can ask for again (heads are consumed in
            # round order; keep the latest two for idempotent re-reads)
            for k in [k for k in heads if k < round_index - 1]:
                del heads[k]
            return head

    def flush(self, check: Optional[str] = "__all__") -> None:
        """Drain the queue: block until everything submitted has settled.
        ``check`` selects which sticky errors re-raise afterwards — a
        task_id for that task only, ``"__all__"`` for any (node-fatal
        always re-raises), None for node-fatal only (the multi-task
        driver's drain: per-task errors stay with their tasks)."""
        with self._cv:
            self._cv.wait_for(lambda: self._settled_tick
                              >= self._submitted_tick
                              or self._error is not None)
            self._check_fatal()
            if check == "__all__":
                if self._task_errors:
                    self._check_task(sorted(self._task_errors)[0])
            elif check is not None:
                self._check_task(check)

    def stop(self) -> None:
        """Drain best-effort (never raises), then terminate the
        coordinator (idempotent)."""
        with self._cv:
            self._cv.wait_for(lambda: self._settled_tick
                              >= self._submitted_tick
                              or self._error is not None)
            if self._stopped:
                return
            self._stopped = True
        if self._thread is not None:
            self._q.put(None)
            self._thread.join()


# -- per-task handle ----------------------------------------------------------


class FederatedTask:
    """One federated learning task on a (possibly multi-tenant)
    ``ChainNode``: model + optimizer state, the eager round function, a
    ``TrustContract`` deployed on the node's ledger under this
    ``task_id``, reputation, cluster exchange, and round history. Create
    through ``ChainNode.create_task``; drive through
    ``ChainNode.run_tick``."""

    def __init__(self, node: "ChainNode", task_id: str, cfg: ModelConfig,
                 fed: FederationConfig, tc: TrainConfig, *, seed: int = 0,
                 adversary: Optional[Callable] = None,
                 reputation_leaders: bool = False,
                 profiles: Optional[List[WorkerProfile]] = None) -> None:
        self.node = node
        self.task_id = task_id
        self.cfg, self.fed, self.tc = cfg, fed, tc
        self.use_blockchain = node.use_blockchain
        self.W = fl_step.num_workers(fed)
        self.device = node.device
        self.np_rng = np.random.default_rng(seed)
        self.adversary = adversary    # fn(worker_batch dict, round) -> batch

        # weights from a CPU generator (the same for a seed on every
        # device); dropout masks from the task's own generator on the device
        self.global_params = api.init(
            cfg, torch.Generator().manual_seed(seed), self.device)
        self.rng = torch.Generator(device=self.device)
        self.rng.manual_seed(seed)
        self.opt_state = fl_step.init_worker_opt(self.global_params, fed, tc)
        self._round_fn = fl_step.make_fl_round(cfg, fed, tc,
                                               device=self.device)
        self._loss_fn = api.loss_fn(cfg)

        self.async_state = None
        self.scheduler = None
        # event-driven state: this task's arrival frontier (its per-task
        # simulated clock) and the host-side mirror of the device
        # AsyncState's staleness — the pre-round snapshot the settlement
        # records commit on-chain without a device sync
        self.arrival: Optional[AsyncScheduler] = None
        self.staleness: Optional[np.ndarray] = None
        if fed.async_mode:
            # pending-buffer layout must match the path make_fl_round takes
            # (flat (W_pad, D_pad) matrix on the fused path, pytree otherwise)
            self.async_state = fl_step.init_async_state_for(
                cfg, fed, self.global_params, self.W)
            self.staleness = np.zeros(self.W, np.int64)
            if profiles is not None:
                if len(profiles) != self.W:
                    raise ValueError(
                        f"{len(profiles)} arrival profiles for {self.W} "
                        f"workers")
                self.arrival = AsyncScheduler(
                    profiles, seed=seed, task_id=task_id,
                    buffer_size=fed.buffer_size, max_wait=fed.max_wait)
        elif profiles is not None:
            raise ValueError("arrival profiles need fed.async_mode=True")

        self.contract: Optional[TrustContract] = None
        self.exchange: Optional[ClusterExchange] = None
        if node.use_blockchain:
            self.contract = TrustContract(
                node.ledger, requester_deposit=fed.requester_deposit,
                worker_stake=fed.worker_stake, penalty_pct=fed.penalty_pct,
                trust_threshold=fed.trust_threshold, top_k=fed.top_k_rewarded,
                merkle_chunk_size=fed.merkle_chunk_size,
                settlement_shards=fed.settlement_shards,
                sparse_settlement=fed.sparse_settlement,
                sparse_rebase_every=fed.sparse_rebase_every,
                staleness_alpha=(fed.staleness_alpha if fed.async_mode
                                 else 0.0),
                task_id=task_id)
            self.contract.join_batch(self.W)   # integer ids, one batch tx
            self.exchange = ClusterExchange(node.ipfs, node.ledger,
                                            fed.num_clusters)
        self.history: List[RoundRecord] = []
        self.heads = [0] * fed.num_clusters
        # reputation (EMA of scores + penalty history) drives head election
        # when reputation_leaders=True — addresses the paper's §VI.E
        # bad-leader concern while keeping rotation stochastic
        self.reputation = ReputationBook(self.W)
        self.reputation_leaders = reputation_leaders

    # -- chain-side conveniences ---------------------------------------------

    @property
    def ledger(self) -> Optional[Ledger]:
        return self.node.ledger

    @property
    def ipfs(self) -> Optional[IPFSStore]:
        return self.node.ipfs

    @property
    def round_index(self) -> int:
        return len(self.history)

    # -- head rotation from on-chain randomness ------------------------------

    def _rotate_heads(self, round_index: int,
                      head_hash: Optional[str] = None) -> List[int]:
        """``head_hash``: the chain head the rotation must see — the block
        that settled *this task's* round r−1, published per (task, round)
        by the node's scheduler; defaults to the live ledger head (only
        reachable for a task driven outside ``run_tick``)."""
        if self.use_blockchain:
            if head_hash is None:
                head_hash = self.node.ledger.head.hash
            seed = Ledger.randomness_from(head_hash, round_index)
        else:
            seed = (self.fed.head_rotation_seed * 1_000_003 + round_index)
        wpc = self.fed.workers_per_cluster
        if self.reputation_leaders:
            self.heads = [
                self.reputation.elect(range(c * wpc, (c + 1) * wpc),
                                      rng_seed=seed + c)
                for c in range(self.fed.num_clusters)]
        else:
            rng = np.random.default_rng(seed)
            self.heads = [int(rng.integers(0, wpc))
                          for _ in range(self.fed.num_clusters)]
        return self.heads

    # -- one round, split around the tick's settlement handoff ---------------

    def _dispatch_round(self, batch: Dict[str, np.ndarray],
                        participation: Optional[np.ndarray]
                        ) -> _StartedRound:
        """Dispatch this round's step — asynchronous on CUDA, no barrier.
        batch leaves: (W, B, ...) numpy — a single local step per round
        (paper's setup); copied to the device and reshaped to
        (W, 1, B, ...) for the step function."""
        t0 = time.monotonic()
        ridx = len(self.history)
        batch = {k: self._to_device(v)[:, None] for k, v in batch.items()}
        if self.adversary is not None:
            batch = self.adversary(batch, ridx)
        part = (None if participation is None
                else self._to_device(np.asarray(participation, np.int32)))
        stale = None
        if self.fed.async_mode:
            if participation is not None:
                # snapshot the pre-round staleness (what the round's
                # discount sees) for the settlement records, then age the
                # host mirror by the same rule the device applies
                stale = self.staleness.copy()
                self.staleness = async_agg.host_staleness_update(
                    self.staleness, participation)
            out, self.async_state = self._round_fn(
                self.global_params, self.opt_state, batch, self.rng,
                part, self.async_state)
        else:
            out = self._round_fn(self.global_params, self.opt_state, batch,
                                 self.rng, part)
        self.global_params, self.opt_state = out.global_params, out.opt_state
        # start the device→host copies of the round's per-worker vectors
        host = {"scores": out.scores, "weights": out.weights,
                "losses": out.losses}
        ready = None
        if self.device.type == "cuda":
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    .copy_(v, non_blocking=True) for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record()
        return _StartedRound(ridx, out, t0, participation, stale, host,
                             ready)

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        """Host array → device tensor; a pinned ``non_blocking`` copy on
        CUDA, so the copy overlaps whatever the device is still running."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _finish_round(self, st: _StartedRound, chain_time: float
                      ) -> Tuple[RoundRecord, _PendingRound]:
        """Rotate heads for this round and sync its scores. On-chain
        randomness needs the block that settled this task's round r−1 (and
        reputation election its scores), so this is the one point the
        pipeline consumes settled state: block on the scheduler's
        published per-task head. Without chain or reputation election the
        rotation seed is settlement-free and rounds run arbitrarily deep
        into the queue."""
        head_hash = None
        if self.use_blockchain or self.reputation_leaders:
            head_hash = self.node._settler.wait_task(self.task_id,
                                                     st.round_index - 1)
        heads = self._rotate_heads(st.round_index, head_hash)
        # the only training-path sync point: this round's scores
        if st.ready is not None:
            st.ready.synchronize()
        scores = st.host["scores"].numpy()
        # the tick's settlement handoff ran between dispatch and here —
        # charge it to chain_time, not the training time
        train_time = time.monotonic() - st.t0 - chain_time
        rec = RoundRecord(
            round_index=st.round_index, scores=scores,
            weights=st.host["weights"].numpy(),
            losses=st.host["losses"].numpy(),
            penalties=np.zeros(self.W, np.float64), heads=heads,
            model_cid="", wall_time=train_time + chain_time,
            chain_time=chain_time,
            participation=None if st.participation is None
            else np.asarray(st.participation),
            staleness=st.staleness)
        # chainless settlement only reads scores — don't pin up to
        # pipeline_depth extra param trees in the queue for nothing
        pending = _PendingRound(
            rec, self.global_params if self.use_blockchain else None, scores)
        self.history.append(rec)
        return rec, pending

    # -- settle-side hooks (run on the scheduler thread) ----------------------

    def _pre_settle(self, p: _PendingRound) -> str:
        """IPFS publication + cross-cluster cid registration for one round
        (paper §III.A): one put of the (identical) global tree; every
        cluster head registers the cid for the hash exchange."""
        ridx = p.record.round_index
        cid = self.node.ipfs.put_tree(p.params, owner=self.task_id)
        for c in range(self.fed.num_clusters):
            self.exchange.register(ridx, c, cid)
        self.contract.pending.extend(self.exchange.round_transactions(ridx))
        return cid

    def _post_settle(self, p: _PendingRound,
                     penalties: Optional[np.ndarray], model_cid: str,
                     t0: float) -> None:
        """Reputation update + record bookkeeping once the round's block
        (if any) is sealed."""
        if self.use_blockchain:
            p.record.model_cid = model_cid
            bad = p.scores < self.contract.T
            if penalties is not None and len(penalties) != self.W:
                # sparse round: scatter the participants' penalties back
                # into a (W,) vector; idle workers owe nothing this round
                mask = np.asarray(p.record.participation).astype(bool)
                full = np.zeros(self.W, np.float64)
                full[mask] = penalties
                penalties = full
                bad &= mask            # idle workers were not judged
            p.record.penalties = penalties
        else:
            bad = np.zeros(self.W, bool)
        self.reputation.update(p.scores, penalized=bad)
        p.record.settle_time = time.monotonic() - t0
        p.record.settled = True

    # -- evaluation ------------------------------------------------------------

    @torch.no_grad()
    def evaluate(self, eval_batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        batch = {k: self._to_device(v)[None] for k, v in eval_batch.items()}
        _, metrics = self._loss_fn(api.stack(self.global_params), batch)
        return {k: float(v[0]) for k, v in metrics.items()}

    @torch.no_grad()
    def evaluate_per_worker(self, batch_w: Dict[str, np.ndarray]):
        """Per-worker eval metrics of the *global* model on each worker's
        local shard (the per-worker curves of Figs. 5/6): accuracy and loss
        for the CNN, loss and aux for a decoder."""
        batch = {k: self._to_device(v) for k, v in batch_w.items()}
        W = batch["labels"].shape[0]
        _, metrics = self._loss_fn(api.stack(self.global_params, W), batch)
        return {k: v.cpu().numpy() for k, v in metrics.items()}

    def finalize(self, timestamp: Optional[float] = None
                 ) -> Dict[str, float]:
        """Drain this task's in-flight rounds (re-raising its sticky error
        if any), then run Algorithm 1's finalization (refunds + top-k
        rewards) in its own single-task block."""
        self.node._flush_for(self.task_id)
        if self.contract is not None:
            if timestamp is None:
                timestamp = float(len(self.history) + 1)
            return self.contract.finalize(timestamp=timestamp)
        return {}


# -- the node -----------------------------------------------------------------


class ChainNode:
    """One chain node serving N concurrent federated tasks on one ledger.

    Owns the shared chain substrate — ``Ledger``, ``IPFSStore``, one
    ``ShardWorkerPool``, and the cross-task settlement scheduler — while
    per-task state lives in ``FederatedTask`` handles registered through
    ``create_task``. Drive with ``run_tick({task_id: batch, ...})``; tasks
    run at independent cadences by simply not firing every tick. See the
    module docstring for the tick/block layout, fairness, and failure
    isolation rules.

    Read path (``read_server()``): proof serving is lock-free by design,
    so readers never block — or wait on — the settler write path. The
    invariants that make this safe: ``Ledger._seal`` registers a block's
    commit *before* publishing the block (so any block a reader can see
    has resolvable proofs), sealed commits/blocks are immutable, and the
    contract's round bookkeeping (``note_block``) is written only after
    the seal — a reader that cannot resolve a round yet simply treats it
    as not-yet-settled and retries after its next head sync. Readers
    resolve tasks by key lookup on ``tasks`` (never iteration), so
    concurrent ``create_task`` registration is safe too.

    ``device``: where every task's rounds run — ``cuda`` unless the
    caller passes another (``"cpu"`` for the tests); without a CUDA device
    and without an explicit request, construction raises."""

    def __init__(self, *, use_blockchain: bool = True,
                 pipeline_depth: int = 2,
                 settler_pool_size: int = 0,
                 ipfs_owner_quota_bytes: int = 0,
                 device=None) -> None:
        # every task's rounds run here: cuda unless the caller asks for
        # another device (raises when CUDA is absent and none was asked)
        self.device = resolve_device(device)
        self.use_blockchain = use_blockchain
        self.pipeline_depth = pipeline_depth
        self.settler_pool_size = settler_pool_size
        self.ledger = Ledger() if use_blockchain else None
        # per-owner (task) byte quota on the shared artifact store: a
        # tenant publishing past it fails its own rounds (QuotaExceeded
        # surfaces as that task's TaskSettlementError) without touching
        # co-tenants — the storage half of multi-tenant fairness
        self.ipfs = IPFSStore(owner_quota_bytes=ipfs_owner_quota_bytes) \
            if use_blockchain else None
        self.tasks: Dict[str, FederatedTask] = {}
        self._tick = 0
        self._pending: Optional[_TickPending] = None
        # event-driven frontier: task_id → (next event sim-time, cohort
        # mask) already drawn from the task's arrival scheduler but not yet
        # run — kept across run_events calls so resuming never skips or
        # re-draws an event
        self._event_frontier: Dict[
            str, Tuple[float, np.ndarray, np.ndarray]] = {}
        # shard workers spawn lazily at task registration, only when some
        # task's settlement is sharded, the driver is threaded, and the
        # contract's leaf-size gate could ever feed them (an explicit
        # settler_pool_size forces the spawn) — the shard *partition* (and
        # hence every block hash) is identical either way, the pool only
        # changes who hashes it
        self._shard_pool: Optional[ShardWorkerPool] = None
        # seal-broadcast hooks (repro_torch.net): called with each freshly
        # sealed block + its commit, on the settler thread
        self._seal_listeners: List[Callable] = []
        self._settler = _SettlerPool(self._settle_tick, pipeline_depth)
        self._closed = False

    # -- task registry --------------------------------------------------------

    def create_task(self, task_id: str, cfg: ModelConfig,
                    fed: FederationConfig, tc: TrainConfig, *, seed: int = 0,
                    adversary: Optional[Callable] = None,
                    reputation_leaders: bool = False,
                    profiles: Optional[List[WorkerProfile]] = None
                    ) -> FederatedTask:
        """Register a new federated task (deploys its ``TrustContract`` on
        the shared ledger). Tasks may join a running node; in-flight ticks
        are drained first so the joining task's round-0 randomness derives
        from a deterministic chain head (every round run before the
        registration, never a racing settler append). ``profiles`` (one
        ``async_sim.WorkerProfile`` per worker; needs ``fed.async_mode``)
        attaches the task's arrival frontier so ``run_events`` can drive it
        event-by-event."""
        if self._closed:
            raise RuntimeError("chain node already closed")
        if task_id in self.tasks:
            raise ValueError(f"task {task_id!r} already registered")
        self.drain()
        task = FederatedTask(self, task_id, cfg, fed, tc, seed=seed,
                             adversary=adversary,
                             reputation_leaders=reputation_leaders,
                             profiles=profiles)
        self.tasks[task_id] = task
        self._settler.register_task(
            task_id, self.ledger.head.hash if self.ledger is not None
            else None)
        self._maybe_spawn_pool(task)
        return task

    def _maybe_spawn_pool(self, task: FederatedTask) -> None:
        if self.pipeline_depth <= 0 or task.contract is None \
                or task.fed.settlement_shards <= 1:
            return
        size = self.settler_pool_size or min(
            max(t.fed.settlement_shards for t in self.tasks.values()),
            os.cpu_count() or 1)
        if size <= 1 or not (self.settler_pool_size > 0
                             or task.contract.parallel_fanout_possible()):
            return
        if self._shard_pool is None or self._shard_pool.num_threads < size:
            # drain in-flight ticks before swapping the pool the scheduler
            # reads (cheap: no-op unless a later task registration grows it
            # mid-run)
            self._settler.flush(check=None)
            old, self._shard_pool = self._shard_pool, ShardWorkerPool(size)
            if old is not None:
                old.stop()

    @property
    def task_errors(self) -> Dict[str, Tuple[int, BaseException]]:
        """Sticky per-task settlement failures: task_id → (round, error)."""
        return {tid: err for tid in sorted(self.tasks)
                if (err := self._settler.task_error(tid)) is not None}

    def add_seal_listener(self, fn: Callable) -> None:
        """Register ``fn(block, commit)`` to run after every block this
        node seals — the broadcast hook a ``repro_torch.net`` gossip layer
        attaches to flood freshly sealed blocks to peers. Listeners run
        on the settler thread, after the block is published on the
        ledger; a listener exception is node-fatal (like any settler
        fault), so broadcast hooks should catch their own transport
        errors."""
        self._seal_listeners.append(fn)

    def ingest_peer_blocks(self, blocks, commits=None) -> int:
        """Adopt externally sealed blocks (gossiped by a peer node) onto
        this node's chain head, oldest-first, after draining in-flight
        local ticks so the adoption races no settler append. ``commits``
        maps block index → ``MultiTaskCommit`` for blocks that commit
        records (shipped alongside the block over the wire). Each block
        is verified on receipt by ``Ledger.adopt_block`` (linkage, hash
        recomputation, commit super-root). Returns how many blocks were
        adopted. Per-contract account state is *not* replayed here —
        that is ``repro_torch.net.SettlementNode``'s job; this hook is for
        proof-serving replicas that track a remote chain."""
        if self._closed:
            raise RuntimeError("chain node already closed")
        if self.ledger is None:
            raise RuntimeError("blockchain disabled on this node")
        self.drain()
        commits = commits or {}
        n = 0
        for blk in blocks:
            self.ledger.adopt_block(blk, commits.get(blk.index))
            n += 1
        return n

    def read_server(self, **kwargs) -> "object":
        """A ``repro_torch.serve.ChainReadServer`` over this live node:
        head-sync handshakes, batched settlement-proof fetch, and
        checkpoint streaming for light clients, served lock-free off the
        published chain state (see the class docstring's read-path
        invariants) while the ``_SettlerPool`` keeps sealing."""
        from repro_torch.serve import ChainReadServer
        return ChainReadServer(self, **kwargs)

    # -- one node tick ---------------------------------------------------------

    def run_tick(self, batches: Dict[str, Dict[str, np.ndarray]],
                 participation: Optional[Dict[str, np.ndarray]] = None
                 ) -> Dict[str, RoundRecord]:
        """Run one round for every task in ``batches`` (canonical sorted
        order) and queue them to settle together in this tick's block.
        Tasks at slower cadences simply don't appear every tick. Raises a
        poisoned task's ``TaskSettlementError`` up front — drop that task
        from ``batches`` to keep driving the others (their rounds from a
        partially-failed tick are already recorded in their histories and
        settle normally)."""
        participation = participation or {}
        tids = sorted(batches)
        for tid in tids:
            if tid not in self.tasks:
                raise KeyError(f"unknown task {tid!r}")
            self._settler.check_task(tid)
        tick = self._tick
        self._tick += 1
        # 1. dispatch every firing task's round — async, no barrier
        started = {tid: self.tasks[tid]._dispatch_round(
            batches[tid], participation.get(tid)) for tid in tids}
        # 2. hand the previous tick's rounds to the settler (threaded: a
        #    queue put; depth 0: settle inline) — either way it overlaps
        #    this tick's device compute
        tc0 = time.monotonic()
        self._hand_off_pending()
        chain_time = time.monotonic() - tc0
        # 3. per task: rotate heads (blocking only on the settled head of
        #    its *own* previous round) and sync scores. A task poisoned
        #    mid-tick raises out of its wait — finish every OTHER task
        #    first (their rounds are recorded and queued normally; only
        #    the poisoned task's dispatched round is dropped), then
        #    re-raise the failure
        recs: Dict[str, RoundRecord] = {}
        entries: List[Tuple[str, _PendingRound]] = []
        failures: List[BaseException] = []
        for tid in tids:
            try:
                rec, pending = self.tasks[tid]._finish_round(started[tid],
                                                             chain_time)
            except BaseException as e:
                failures.append(e)
                continue
            recs[tid] = rec
            entries.append((tid, pending))
        if entries:
            self._pending = _TickPending(tick, entries)
        if failures:
            raise failures[0]
        return recs

    def run_events(self, batch_fns: Dict[str, Callable[[int], Dict]],
                   *, events: int) -> Dict[str, List[RoundRecord]]:
        """Drive the node event-by-event for ``events`` aggregation events
        across the tasks in ``batch_fns`` (each ``task_id → fn(round_index)
        → batch`` — called lazily, only when that task's event fires).

        Every task must be async (``fed.async_mode``) with an arrival
        frontier attached (``create_task(..., profiles=...)``). The node
        repeatedly pops the task whose next aggregation event is earliest
        in simulated time (ties break on task_id — deterministic) and runs
        one ``run_tick`` round for that task alone: participation = the
        arrived cohort, aggregation staleness-weighted on device,
        settlement sealing exactly that cohort through the normal settler
        pipeline (one block per event). An event whose window closed with
        an empty cohort (every arrival lost) still consumes simulated time
        but runs no round. Records carry ``sim_time`` (the event's
        simulated seal time) and ``staleness`` (the cohort's pre-round
        staleness, also committed in the on-chain records).

        Returns ``task_id → [RoundRecord, ...]`` for the rounds run (tasks
        whose events never fired within the budget map to ``[]``).
        Frontier state persists on the node, so consecutive calls continue
        the same simulation; a poisoned task raises its
        ``TaskSettlementError`` out of its event exactly like ``run_tick``.
        """
        tids = sorted(batch_fns)
        for tid in tids:
            if tid not in self.tasks:
                raise KeyError(f"unknown task {tid!r}")
            if self.tasks[tid].arrival is None:
                raise ValueError(
                    f"task {tid!r} has no arrival frontier — register it "
                    f"with create_task(..., profiles=[...]) and "
                    f"fed.async_mode=True to drive it event-by-event")
        heap: List[Tuple[float, str]] = []
        for tid in tids:
            if tid not in self._event_frontier:
                arrival = self.tasks[tid].arrival
                t, mask, _ = arrival.next_aggregation()
                self._event_frontier[tid] = (t, mask,
                                             arrival.arrival_times().copy())
            heap.append((self._event_frontier[tid][0], tid))
        heapq.heapify(heap)
        out: Dict[str, List[RoundRecord]] = {tid: [] for tid in tids}
        for _ in range(int(events)):
            if not heap:
                break
            t, tid = heapq.heappop(heap)
            _, mask, at = self._event_frontier.pop(tid)
            task = self.tasks[tid]
            if mask.sum() > 0:
                rec = self.run_tick(
                    {tid: batch_fns[tid](task.round_index)},
                    participation={tid: mask})[tid]
                rec.sim_time = t
                rec.arrival_times = at
                out[tid].append(rec)
            nt, nmask, _ = task.arrival.next_aggregation()
            self._event_frontier[tid] = (nt, nmask,
                                         task.arrival.arrival_times().copy())
            heapq.heappush(heap, (nt, tid))
        return out

    def _hand_off_pending(self) -> None:
        tp, self._pending = self._pending, None
        if tp is not None:
            self._settler.submit(tp)       # queue handoff; work happens on
                                           # the settler thread (depth > 0)

    # -- settlement of one tick (runs on the scheduler thread) ----------------

    def _settle_tick(self, tp: _TickPending) -> list:
        """Settle one tick: per task IPFS publication + contract
        settlement, all surviving tasks sealed into one multi-task block
        at logical (tick-indexed) time. Returns per-task outcomes
        ``(task_id, round_index, head, error)``; raising is node-fatal."""
        outcomes: list = []
        live: List[Tuple[FederatedTask, _PendingRound, float]] = []
        work: List[TaskRoundWork] = []
        for tid, p in tp.entries:
            ridx = p.record.round_index
            if self._settler.task_error(tid) is not None:
                # drain-and-discard: never settle later rounds of a task
                # on top of its half-settled lane
                outcomes.append((tid, ridx, None, None))
                continue
            task = self.tasks[tid]
            t0 = time.monotonic()
            if not self.use_blockchain:
                task._post_settle(p, None, "", t0)
                outcomes.append((tid, ridx, None, None))
                continue
            try:
                cid = task._pre_settle(p)
            except BaseException as e:
                outcomes.append((tid, ridx, None, e))
                continue
            live.append((task, p, t0))
            scores, wids = p.scores, None
            stale = p.record.staleness
            if task.contract.sparse_settlement \
                    and p.record.participation is not None:
                # sparse settlement: the round's *changed set* is the
                # participating workers — idle workers' records carry
                # over into the delta commit unhashed
                mask = np.asarray(p.record.participation).astype(bool)
                wids = np.nonzero(mask)[0].astype(np.int64)
                scores = p.scores[wids]
                if stale is not None:
                    stale = stale[wids]
            work.append(TaskRoundWork(tid, task.contract, ridx, scores,
                                      cid, worker_ids=wids, staleness=stale))
        if work:
            # logical timestamp: every node (and the serial reference
            # driver) seals byte-identical blocks for the same tick
            blk, pens, errors = settle_tasks_block(
                self.ledger, work, timestamp=float(tp.tick + 1),
                pool=self._shard_pool)
            for listener in self._seal_listeners:
                listener(blk, self.ledger._commits.get(blk.index))
            for (task, p, t0), w in zip(live, work):
                if w.task_id in errors:
                    outcomes.append((w.task_id, w.round_index, None,
                                     errors[w.task_id]))
                else:
                    task._post_settle(p, pens[w.task_id], w.model_cid, t0)
                    outcomes.append((w.task_id, w.round_index, blk.hash,
                                     None))
        return outcomes

    # -- draining / teardown ---------------------------------------------------

    def flush(self) -> None:
        """Settle every round still in flight: hand off the trailing
        pending tick and drain the scheduler queue. Idempotent and safe to
        call mid-queue. Re-raises the first sticky task error (for the
        multi-task drain that leaves per-task errors with their tasks,
        use ``drain``)."""
        self._hand_off_pending()
        self._settler.flush()

    def drain(self) -> None:
        """Like ``flush`` but re-raises only a node-fatal error — a
        poisoned task keeps its ``TaskSettlementError`` for its own
        interactions while co-tenants proceed."""
        self._hand_off_pending()
        self._settler.flush(check=None)

    def _flush_for(self, task_id: str) -> None:
        self._hand_off_pending()
        self._settler.flush(check=task_id)

    def finalize_task(self, task_id: str,
                      timestamp: Optional[float] = None) -> Dict[str, float]:
        return self.tasks[task_id].finalize(timestamp)

    def finalize(self) -> Dict[str, Dict[str, float]]:
        """Drain, finalize every healthy task (refunds + top-k payouts,
        one block each), close the node. Poisoned tasks are skipped —
        inspect ``task_errors``. Returns per-task payout maps."""
        self.drain()
        payouts: Dict[str, Dict[str, float]] = {}
        for tid in sorted(self.tasks):
            task = self.tasks[tid]
            if self._settler.task_error(tid) is not None:
                continue
            if task.contract is not None and task.contract.closed:
                continue
            payouts[tid] = task.finalize()
        self.close()
        return payouts

    def close(self) -> None:
        """Stop the scheduler and shard workers (drains best-effort,
        never raises; idempotent)."""
        self._closed = True
        self._settler.stop()
        if self._shard_pool is not None:
            self._shard_pool.stop()
            self._shard_pool = None
