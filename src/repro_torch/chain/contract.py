"""Smart-contract state machine executing the paper's Algorithm 1.

Steps (paper §III.E):
  1. Requester deploys, depositing D (task reward pool).
  2. Each worker joins by staking F.
  3. Per round: workers submit evaluation scores S(w).
  4. BadWorkers = {w | S(w) < T}.
     Pen(w) = F · P / 100, deducted from the stake.
  5. D(w) = F − Pen(w).
  6. Refund(w) = D(w) at task end.
  7. Collected penalties transfer to the requester.
  8. TopKWorkers split the reward pool: Reward(w) = R_total / k.

Array-native state: accounts are a struct-of-arrays (numpy ``stake`` /
``balance`` / ``penalized_rounds`` / ``score_sum`` / ``score_count``
vectors indexed by integer worker id), so a round settles in O(1) Python
ops and O(W) vectorized numpy — ``settle_round_batch`` computes BadWorkers,
penalties, and the requester transfer without a per-worker loop, and
``finalize`` ranks top-k via ``argpartition``. Each settlement block
commits to the round's canonically-encoded per-worker records through a
chunked Merkle root (see ``chain.ledger``): records are encoded as one
contiguous fixed-width buffer (``RecordBatch``) and committed
``merkle_chunk_size`` records per leaf, so the commit hashes ~2·W/k nodes
instead of ~2·W while balances stay fully auditable — per-worker via
O(log(W/k) + k) proofs (``settlement_proof``: the record's chunk plus the
node path) rather than per-worker embedded transactions.

Sharded settlement (``settlement_shards`` > 1): a round is partitioned
into contiguous slices of the struct-of-arrays state — each shard's
``settle_shard`` computes its slice's BadWorkers mask, penalties and
chunked Merkle subtree *without mutating contract state*, so slices run
concurrently on a settler pool. A deterministic merge (shard order ==
worker-id order) then applies the state transition from the concatenated
per-shard results and seals the block over the cross-shard super-root.
Shard boundaries are subtree-aligned (``plan_shard_bounds``), making the
super-root — and hence every block hash, proof, election and penalty —
bit-identical across shard counts and to the unsharded path; and because
no state is touched until every shard succeeded, a failing shard leaves
the contract and chain exactly as before the round (no half-settled
super-root is ever committed).

Multi-tenant settlement (``task_id``): several ``TrustContract`` tasks can
share one ledger on a chain node. The round settlement is split into three
composable phases so a node can co-commit many tasks' rounds into one
multi-task block: ``prepare_round_batch`` (validation + per-shard compute
thunks, pure), ``finish_round_batch`` (the deterministic merge — state
transition + transactions + commit parts), and ``note_block`` (audit
bookkeeping once the block is sealed). ``settle_round_batch`` composes the
three over a single-task block exactly as before, so the single-tenant
path is bit-identical. Proofs are task-scoped: ``settlement_proof`` walks
chunk-in-shard, shard-in-task, and task-in-block levels (the last empty on
single-task blocks) and verifies against the block's combined root.

Sparse settlement (``sparse_settlement=True``): the million-worker path.
The contract keeps a persistent full-population record buffer (every
worker's latest settlement record; genesis rows for the never-settled)
and commits each round as a ``DeltaCommit`` (see ``chain.ledger``): a
dense anchor on the first round / after enrollment growth / at full
participation / every ``sparse_rebase_every`` rounds, and otherwise an
incremental commit that re-hashes only the chunks the round's *changed
set* dirtied — O(C·log(W/k)) instead of O(W/k) per round, so settlement
cost scales with activity, not population. Every block still commits the
full population's root: ``settlement_proof`` covers idle workers (record
index == worker id), and ``verify_chain(deep=True)`` detects tampering
with inherited records exactly like with fresh ones. Algorithm 1
semantics (penalties, stakes, transfers) are unchanged — only the commit
strategy differs.

Staleness-aware settlement (``staleness_alpha`` > 0): the event-driven
node (``core.node.ChainNode.run_events``) settles whatever cohort arrived
at each aggregation event, and each settled record carries the update's
*staleness* (rounds since it was computed) in the canonical record
encoding — committed under the block's Merkle root, so the discount a
worker received is auditable on-chain. Penalties and payout credit scale
by ``(1+staleness)^-alpha`` (the same discount ``trust.staleness_discount``
applies to aggregation weight): a late-but-honest update is discounted,
not punished at full freshness weight. ``alpha=0`` — the default and the
synchronous path — is bit-identical to staleness-unaware settlement.

The documented surface is the batch API (``join_batch`` /
``settle_round_batch``) plus the typed proof surface (``proof`` returning
``repro_torch.chain.proofs.SettlementProof``, verified with
``SettlementProof.verify(head)``). The legacy scalar API (``join`` /
``settle_round`` with a score dict / dict-like ``workers`` access) lives
behind the explicit ``contract.legacy`` namespace — still a thin wrapper
over the batch path, so Algorithm 1 semantics are provably unchanged (see
the batch-vs-scalar equivalence property test in ``tests/test_chain.py``);
calling ``join``/``settle_round`` directly warns ``DeprecationWarning``.
Likewise ``settlement_proof``/``verify_settlement`` remain as deprecated
dict-shaped wrappers emitting bit-identical proofs.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.chain.ledger import (DeltaCommit, Ledger, MerkleTree, RecordBatch,
                                gathered_leaf_digests, plan_shard_bounds)
from repro_torch.chain.proofs import SettlementProof, build_settlement_proof


class ContractError(RuntimeError):
    pass


# GIL economics of parallel settlement: a leaf hash releases the GIL only
# for updates of >= 2048 bytes (CPython's HASHLIB_GIL_MINSIZE — below that
# pure-CPython parallel hashing is architecturally impossible), and each
# release/acquire handoff costs more than a small leaf's hash. The framed
# batched hasher (``chain.ledger.batch_leaf_digests``) issues exactly one
# C call per leaf, halving the handoffs of the old two-``update`` path and
# dropping the measured pooled-fanout crossover from ~32 KiB to ~4 KiB per
# leaf on a 2-core host. Below the gate the sharded commit still runs
# (same bytes, same root), just on the calling thread. Env-overridable
# fallback for unusual hosts: SDFLB_MIN_PARALLEL_LEAF_BYTES.
MIN_PARALLEL_LEAF_BYTES = int(
    os.environ.get("SDFLB_MIN_PARALLEL_LEAF_BYTES", 4096))


_RECORD_DTYPE = np.dtype([("round", "<i8"), ("worker", "<i8"),
                          ("score", "<f8"), ("penalty", "<f8"),
                          ("stake_after", "<f8"), ("staleness", "<i8")])


def encode_settlement_records(round_index: int, worker_ids: np.ndarray,
                              scores: np.ndarray, penalties: np.ndarray,
                              stakes_after: np.ndarray,
                              staleness: Optional[np.ndarray] = None
                              ) -> RecordBatch:
    """Canonical fixed-width binary encoding of per-worker settlement
    records — the Merkle-committed data of a settlement block. Built
    vectorized into one contiguous buffer; the returned ``RecordBatch``
    wraps a memoryview straight onto the array's memory (no ``tobytes``
    copy — the commit hashes leaves out of the buffer zero-copy) and
    indexes like a list of per-record bytes. ``staleness`` (rounds since
    the worker's update was computed, 0 = fresh) defaults to zeros — the
    synchronous path."""
    n = len(worker_ids)
    rec = np.empty(n, dtype=_RECORD_DTYPE)
    rec["round"] = round_index
    rec["worker"] = worker_ids
    rec["score"] = scores
    rec["penalty"] = penalties
    rec["stake_after"] = stakes_after
    rec["staleness"] = 0 if staleness is None else staleness
    return RecordBatch(memoryview(rec).cast("B"), _RECORD_DTYPE.itemsize)


def decode_settlement_record(leaf: bytes) -> Dict[str, float]:
    rec = np.frombuffer(leaf, dtype=_RECORD_DTYPE)[0]
    return {"round": int(rec["round"]), "worker": int(rec["worker"]),
            "score": float(rec["score"]), "penalty": float(rec["penalty"]),
            "stake_after": float(rec["stake_after"]),
            "staleness": int(rec["staleness"])}


@dataclass
class ShardSettlement:
    """One shard's slice of a round, computed by ``settle_shard`` without
    mutating contract state: the merge barrier applies mutations only after
    every shard of the round succeeded."""
    start: int                     # slice [start, stop) of the round's ids
    stop: int
    penalties: np.ndarray          # (stop-start,) Pen(w), stake-capped
    stake_after: np.ndarray        # (stop-start,) post-penalty stakes
    records: RecordBatch           # canonical encodings of this slice
    tree: Optional[MerkleTree]     # chunked Merkle subtree over the slice
    #                                (None on the sparse path — the delta
    #                                commit re-hashes dirty chunks instead)


@dataclass
class RoundPrep:
    """Validated inputs + per-shard compute thunks for one round — the
    pure (no state mutation) first phase of a settlement, so a multi-task
    node can fan many tasks' shard thunks out through one shared pool."""
    round_index: int
    ids: np.ndarray                # participating worker ids, id order
    scores: np.ndarray             # aligned scores, float64
    thunks: List[Callable[[], ShardSettlement]] = field(default_factory=list)
    sparse: bool = False           # settle as a delta commit
    # permutation s.t. ids == original_ids[order] when sparse settlement
    # had to sort the caller's ids into canonical record order (None when
    # they already were); penalties are unpermuted back before returning
    order: Optional[np.ndarray] = None
    staleness: Optional[np.ndarray] = None  # aligned with ids (None = fresh)


@dataclass
class RoundSeal:
    """The deterministic merge's output — everything a block needs from
    one task's round: drained transactions, per-shard commit parts (dense
    path) or the prebuilt incremental commit (sparse path), and the
    penalty vector. State has already transitioned when this exists."""
    txs: List[dict]
    shards: List[RecordBatch]
    trees: List[MerkleTree]
    chunk_size: int
    penalties: np.ndarray
    delta: Optional[DeltaCommit] = None


class WorkerAccount:
    """Read/write *view* onto one worker's slice of the struct-of-arrays
    state — preserves the legacy ``contract.workers[wid].stake`` API."""

    __slots__ = ("_c", "_i")

    def __init__(self, contract: "TrustContract", index: int) -> None:
        self._c = contract
        self._i = index

    @property
    def stake(self) -> float:
        return float(self._c.stake[self._i])

    @stake.setter
    def stake(self, v: float) -> None:
        self._c.stake[self._i] = v

    @property
    def balance(self) -> float:
        return float(self._c.balance[self._i])

    @balance.setter
    def balance(self, v: float) -> None:
        self._c.balance[self._i] = v

    @property
    def penalized_rounds(self) -> int:
        return int(self._c.penalized_rounds[self._i])

    @property
    def scores(self) -> List[float]:
        """Score history of this worker across settled rounds (only rounds
        the worker was scored in)."""
        return self._c._worker_scores(self._i)


class _WorkersView(Mapping):
    """Mapping façade over the array state: accepts integer worker ids or
    registered string names (``"worker-3"``), yields account views."""

    def __init__(self, contract: "TrustContract") -> None:
        self._c = contract

    def _index(self, key) -> int:
        if isinstance(key, (int, np.integer)):
            if not 0 <= int(key) < self._c.num_workers:
                raise KeyError(key)
            return int(key)
        try:
            return self._c._index[key]
        except KeyError:
            raise KeyError(key) from None

    def __getitem__(self, key) -> WorkerAccount:
        return WorkerAccount(self._c, self._index(key))

    def __contains__(self, key) -> bool:
        try:
            self._index(key)
            return True
        except KeyError:
            return False

    def __iter__(self) -> Iterator[str]:
        return iter(self._c._names)

    def __len__(self) -> int:
        return self._c.num_workers

    def values(self):
        return (WorkerAccount(self._c, i)
                for i in range(self._c.num_workers))

    def items(self):
        return ((n, WorkerAccount(self._c, i))
                for i, n in enumerate(self._c._names))


class TrustContract:
    """One deployed FL task. Mirrors Algorithm 1 exactly — array-native."""

    def __init__(self, ledger: Ledger, *, requester_deposit: float,
                 worker_stake: float, penalty_pct: float,
                 trust_threshold: float, top_k: int,
                 merkle_chunk_size: int = 64,
                 settlement_shards: int = 1,
                 sparse_settlement: bool = False,
                 sparse_rebase_every: int = 0,
                 staleness_alpha: float = 0.0,
                 task_id: Optional[str] = None) -> None:
        if requester_deposit <= 0:
            raise ContractError("deployment requires a positive deposit")
        if merkle_chunk_size < 1:
            raise ContractError("merkle_chunk_size must be >= 1")
        if settlement_shards < 1:
            raise ContractError("settlement_shards must be >= 1")
        if sparse_rebase_every < 0:
            raise ContractError("sparse_rebase_every must be >= 0")
        if staleness_alpha < 0:
            raise ContractError("staleness_alpha must be >= 0")
        self.ledger = ledger
        self.task_id = task_id         # name on a multi-tenant chain node
        self.F = worker_stake
        self.P = penalty_pct
        self.T = trust_threshold
        self.k = top_k
        # staleness-aware economics (event-driven settlement): a worker
        # settled with staleness s has penalty and payout-credit scaled by
        # (1+s)^-alpha — a late-but-honest update is discounted, not
        # punished at full freshness weight. alpha=0 (the default, and the
        # sync path) is bit-identical to staleness-unaware settlement.
        self.staleness_alpha = float(staleness_alpha)
        self.merkle_chunk_size = merkle_chunk_size
        self.settlement_shards = settlement_shards
        self.sparse_settlement = bool(sparse_settlement)
        self.sparse_rebase_every = int(sparse_rebase_every)
        self.min_parallel_leaf_bytes = MIN_PARALLEL_LEAF_BYTES
        # sparse-path state: the persistent full-population record buffer
        # (every worker's latest settlement record, genesis rows for the
        # never-settled), the chain's latest commit to overlay against,
        # and the delta depth since the last dense anchor
        self._pop_records: Optional[np.ndarray] = None
        self._last_commit: Optional[DeltaCommit] = None
        self._rounds_since_base = 0
        self._round_full_cover: Dict[int, bool] = {}
        self.reward_pool = requester_deposit
        self.requester_balance = 0.0
        # struct-of-arrays account state (amortized-doubling capacity)
        self.stake = np.zeros(0, np.float64)
        self.balance = np.zeros(0, np.float64)
        self.penalized_rounds = np.zeros(0, np.int64)
        self.score_sum = np.zeros(0, np.float64)
        self.score_count = np.zeros(0, np.int64)
        self._names: List[str] = []
        self._index: Dict[str, int] = {}
        # audit trails: append-only settlement log (score history) plus
        # round → (block, settled ids) for O(log W) settlement proofs
        self._score_log: List[Tuple[np.ndarray, np.ndarray]] = []
        self._round_blocks: Dict[int, int] = {}
        self._round_ids: Dict[int, np.ndarray] = {}
        self.pending: List[dict] = [{"type": "deploy",
                                     "deposit": requester_deposit,
                                     "F": worker_stake, "P": penalty_pct,
                                     "T": trust_threshold, "k": top_k}]
        self.closed = False

    # -- enrollment ---------------------------------------------------------

    @property
    def num_workers(self) -> int:
        return len(self._names)

    @property
    def workers(self) -> _WorkersView:
        return _WorkersView(self)

    def _grow(self, n: int) -> None:
        old = len(self.stake)
        for attr in ("stake", "balance", "penalized_rounds",
                     "score_sum", "score_count"):
            arr = getattr(self, attr)
            out = np.zeros(old + n, arr.dtype)
            out[:old] = arr
            setattr(self, attr, out)

    def join_batch(self, count: int, *, name_prefix: str = "worker-",
                   start: Optional[int] = None) -> np.ndarray:
        """Enroll ``count`` workers in one vectorized transition (O(count)
        numpy, O(count) name registration). Returns their integer ids.
        The whole batch is a single on-chain join transaction."""
        if self.closed:
            raise ContractError("task closed")
        if count <= 0:
            raise ContractError("join_batch needs a positive count")
        base = self.num_workers
        start = base if start is None else start
        names = [f"{name_prefix}{start + i}" for i in range(count)]
        dup = [n for n in names if n in self._index]
        if dup:
            raise ContractError(f"already joined: {dup[:3]}")
        self._grow(count)
        self.stake[base:] = self.F
        for i, n in enumerate(names):
            self._index[n] = base + i
        self._names.extend(names)
        self.pending.append({"type": "join_batch", "count": count,
                             "first_id": base, "stake_each": self.F})
        return np.arange(base, base + count)

    def _join_scalar(self, worker_id: str) -> None:
        if self.closed:
            raise ContractError("task closed")
        if worker_id in self._index:
            raise ContractError(f"{worker_id} already joined")
        base = self.num_workers
        self._grow(1)
        self.stake[base] = self.F
        self._index[worker_id] = base
        self._names.append(worker_id)
        self.pending.append({"type": "join", "worker": worker_id,
                             "stake": self.F})

    def join(self, worker_id: str) -> None:
        """Deprecated scalar enrollment — use ``join_batch`` (or, for
        intentionally per-worker demos, ``contract.legacy.join``)."""
        warnings.warn(
            "TrustContract.join is deprecated; use join_batch "
            "(or contract.legacy.join)", DeprecationWarning, stacklevel=2)
        self._join_scalar(worker_id)

    @property
    def legacy(self) -> "LegacyContractAPI":
        """The sanctioned namespace for the scalar per-worker API."""
        return LegacyContractAPI(self)

    def worker_id(self, name: str) -> int:
        return self._index[name]

    def worker_name(self, index: int) -> str:
        return self._names[index]

    # -- per-round settlement (Alg. 1 steps 3-7), batch path ------------------

    def shard_bounds(self, num_records: int,
                     shards: Optional[int] = None) -> List[int]:
        """Subtree-aligned record boundaries splitting a round of
        ``num_records`` settlements into ≤ ``shards`` slices (default:
        this contract's ``settlement_shards``). Because boundaries are
        subtree-aligned, the committed super-root — and every proof and
        block hash — is identical for every shard count: callers (e.g. a
        multi-tenant node balancing N tasks over one pool) may re-plan
        execution granularity freely."""
        return plan_shard_bounds(num_records, self.merkle_chunk_size,
                                 self.settlement_shards
                                 if shards is None else shards)

    def parallel_fanout_possible(self) -> bool:
        """Whether ``settle_round_batch`` could ever hand shards to a pool:
        more than one shard configured AND chunk leaves clear the GIL
        threshold. Lets callers skip spawning worker threads that the gate
        would never feed."""
        return self.settlement_shards > 1 and self.parallel_leaf_ok()

    def settle_shard(self, round_index: int, ids: np.ndarray, s: np.ndarray,
                     start: int, stop: int, build_tree: bool = True,
                     staleness: Optional[np.ndarray] = None
                     ) -> ShardSettlement:
        """Compute one contract shard's slice [start, stop) of a round —
        BadWorkers mask, stake-capped penalties, canonical records, chunked
        Merkle subtree — reading the struct-of-arrays state but mutating
        nothing, so shards of one round run concurrently on a settler pool
        (their id slices are disjoint, and the merge applies all mutations
        afterwards on one thread). The sparse path passes
        ``build_tree=False``: the slice's records become the *changed set*
        of a delta commit, whose incremental update replaces the per-slice
        subtree. ``staleness`` (aligned with ``ids``) makes penalties
        staleness-discounted and is committed in the records, so the
        event-driven node's economics are auditable on-chain."""
        sl_ids = ids[start:stop]
        sl_s = s[start:stop]
        bad = sl_s < self.T                               # BadWorkers
        stake_sel = self.stake[sl_ids]
        full_pen = self.F * self.P / 100.0
        sl_st = None
        if staleness is not None:
            sl_st = staleness[start:stop]
            if self.staleness_alpha:
                # a stale update was honest work against an old global —
                # penalize it at its (discounted) evidentiary weight
                full_pen = full_pen * self._staleness_discount(sl_st)
        pen = np.where(bad, np.minimum(full_pen, stake_sel),
                       0.0)                               # Pen(w), stake-capped
        stake_after = stake_sel - pen
        records = encode_settlement_records(round_index, sl_ids, sl_s, pen,
                                            stake_after, staleness=sl_st)
        return ShardSettlement(start, stop, pen, stake_after, records,
                               MerkleTree(records, self.merkle_chunk_size)
                               if build_tree else None)

    def _staleness_discount(self, staleness: np.ndarray) -> np.ndarray:
        """(1+s)^-alpha — the same discount ``core.trust.staleness_discount``
        applies inside the jitted round, here on the settlement side."""
        return (1.0 + staleness.astype(np.float64)) ** (-self.staleness_alpha)

    def prepare_round_batch(self, round_index: int, scores: np.ndarray,
                            worker_ids: Optional[np.ndarray] = None,
                            shards: Optional[int] = None,
                            staleness: Optional[np.ndarray] = None
                            ) -> RoundPrep:
        """Phase 1 of a settlement: validate inputs and build the per-shard
        compute thunks (pure — no contract state is touched until
        ``finish_round_batch``), so a multi-tenant node can interleave many
        tasks' thunks through one shared worker pool. ``shards`` overrides
        the execution granularity (consensus-invisible: subtree-aligned
        boundaries commit the identical root for every shard count).
        ``staleness`` (aligned with ``scores``) is recorded on-chain and —
        with ``staleness_alpha > 0`` — discounts penalties and payout
        credit. A failure here, or in any thunk, aborts the round with
        nothing applied and nothing committed."""
        if self.closed:
            raise ContractError("task closed")
        s = np.asarray(scores, np.float64).reshape(-1)
        if worker_ids is None:
            if len(s) != self.num_workers:
                raise ContractError(
                    f"expected {self.num_workers} scores, got {len(s)}")
            ids = np.arange(self.num_workers)
        else:
            ids = np.asarray(worker_ids, np.int64).reshape(-1)
            if len(ids) != len(s):
                raise ContractError("worker_ids/scores length mismatch")
            if len(ids) and (ids.min() < 0 or ids.max() >= self.num_workers):
                bad = ids[(ids < 0) | (ids >= self.num_workers)]
                raise ContractError(
                    f"scores from non-participants: {set(bad.tolist())}")
            if len(np.unique(ids)) != len(ids):
                raise ContractError("duplicate worker ids in settlement")
        st = None
        if staleness is not None:
            st = np.asarray(staleness, np.int64).reshape(-1)
            if len(st) != len(s):
                raise ContractError("staleness/scores length mismatch")
            if len(st) and st.min() < 0:
                raise ContractError("staleness must be >= 0")
        if self.sparse_settlement:
            # canonical record order is id order (record index == worker
            # id in the population commit); remember the permutation so
            # penalties return aligned with the caller's score order
            order = None
            if worker_ids is not None and len(ids) > 1 \
                    and (np.diff(ids) < 0).any():
                order = np.argsort(ids, kind="stable")
                ids, s = ids[order], s[order]
                if st is not None:
                    st = st[order]
            # one slice: the delta commit replaces the per-shard subtrees,
            # so there is no per-slice tree to fan out
            bounds = [0, len(ids)] if len(ids) else [0]
            kw = {} if st is None else {"staleness": st}
            thunks = [lambda a=a, b=b: self.settle_shard(
                round_index, ids, s, a, b, build_tree=False, **kw)
                for a, b in zip(bounds, bounds[1:])]
            return RoundPrep(round_index, ids, s, thunks, sparse=True,
                             order=order, staleness=st)
        bounds = self.shard_bounds(len(ids), shards)
        # staleness rides as a kwarg only when present: the sync path keeps
        # the legacy settle_shard call signature
        kw = {} if st is None else {"staleness": st}
        thunks = [lambda a=a, b=b: self.settle_shard(round_index, ids, s,
                                                     a, b, **kw)
                  for a, b in zip(bounds, bounds[1:])]
        return RoundPrep(round_index, ids, s, thunks, staleness=st)

    def parallel_leaf_ok(self) -> bool:
        """The GIL gate for this contract's leaves: fan shard thunks out to
        a pool only when one chunk leaf amortizes the release/acquire
        handoff (see ``MIN_PARALLEL_LEAF_BYTES``)."""
        return (self.merkle_chunk_size * _RECORD_DTYPE.itemsize
                >= self.min_parallel_leaf_bytes)

    def finish_round_batch(self, prep: RoundPrep,
                           results: List[ShardSettlement],
                           model_cid: str = "") -> RoundSeal:
        """Phase 2: the deterministic merge. Applies the state transition
        from the concatenated per-shard results (shard order == id order,
        so every reduction is bit-identical to the unsharded path), drains
        the pending transactions, and returns the block commit parts. Runs
        only after *every* shard of the round succeeded."""
        ids, s = prep.ids, prep.scores
        round_index = prep.round_index
        bad = s < self.T
        if results:
            pen = np.concatenate([r.penalties for r in results])
            stake_after = np.concatenate([r.stake_after for r in results])
        else:
            pen = np.zeros(0, np.float64)
            stake_after = np.zeros(0, np.float64)
        self.stake[ids] = stake_after
        self.penalized_rounds[ids] += bad
        self.requester_balance += float(pen.sum())        # step 7
        if prep.staleness is not None and self.staleness_alpha:
            # stale contributions earn payout credit at the same
            # (1+s)^-alpha discount the aggregation gave their update
            self.score_sum[ids] += s * self._staleness_discount(prep.staleness)
        else:
            self.score_sum[ids] += s
        self.score_count[ids] += 1
        self._score_log.append((ids, s))

        txs = self.pending
        self.pending = []
        txs.append({"type": "settlement_batch", "round": round_index,
                    "workers": int(len(ids)), "bad_count": int(bad.sum()),
                    "total_penalty": float(pen.sum())})
        if model_cid:
            txs.append({"type": "model", "round": round_index,
                        "cid": model_cid})
        if prep.sparse:
            self._round_full_cover[round_index] = True
            delta = self._sparse_commit(round_index, ids, results)
            pen_out = pen
            if prep.order is not None:      # back to the caller's order
                pen_out = np.empty_like(pen)
                pen_out[prep.order] = pen
            return RoundSeal(txs, [], [], self.merkle_chunk_size, pen_out,
                             delta=delta)
        return RoundSeal(txs, [r.records for r in results],
                         [r.tree for r in results],
                         self.merkle_chunk_size, pen)

    def _sparse_commit(self, round_index: int, ids: np.ndarray,
                       results: List[ShardSettlement]
                       ) -> Optional[DeltaCommit]:
        """Fold this round's changed records into the persistent
        full-population buffer and commit: a dense anchor
        (``DeltaCommit.full``) on the first round, after enrollment grew
        the population, at full participation, or every
        ``sparse_rebase_every`` rounds — an incremental
        ``DeltaCommit.delta`` (dirty chunks re-hashed from the population
        buffer in one batched pass, O(C·log(W/k)) interior updates)
        otherwise."""
        W = self.num_workers
        if W == 0:
            return None
        k = self.merkle_chunk_size
        itemsize = _RECORD_DTYPE.itemsize
        rebase = False
        if self._pop_records is None or len(self._pop_records) != W:
            # (re)build the population buffer: genesis rows (round -1,
            # zero score/penalty, current stake) for workers without a
            # settlement record in the buffer's lifetime
            pop = np.empty(W, dtype=_RECORD_DTYPE)
            pop["round"] = -1
            pop["worker"] = np.arange(W)
            pop["score"] = 0.0
            pop["penalty"] = 0.0
            pop["stake_after"] = self.stake
            pop["staleness"] = 0
            self._pop_records = pop
            rebase = True
        pop = self._pop_records
        if results:
            new_rows = np.concatenate(
                [np.frombuffer(r.records.buf, _RECORD_DTYPE)
                 for r in results])
        else:
            new_rows = np.empty(0, dtype=_RECORD_DTYPE)
        pop[ids] = new_rows                 # scatter this round's records
        self._rounds_since_base += 1
        if (self._last_commit is None or rebase or len(ids) == W
                or (self.sparse_rebase_every
                    and self._rounds_since_base >= self.sparse_rebase_every)):
            snap = pop.copy()               # the anchor owns its snapshot
            commit = DeltaCommit.full(
                RecordBatch(memoryview(snap).cast("B"), itemsize), k)
            self._rounds_since_base = 0
        else:
            digests = gathered_leaf_digests(
                RecordBatch(memoryview(pop).cast("B"), itemsize), k,
                np.unique(ids // k))
            commit = DeltaCommit.delta(
                self._last_commit, ids.copy(),
                RecordBatch(memoryview(new_rows).cast("B"), itemsize),
                leaf_digests=digests)
        self._last_commit = commit
        return commit

    def note_block(self, round_index: int, ids: np.ndarray,
                   block_index: int) -> None:
        """Phase 3: audit bookkeeping once the round's block is sealed —
        keys ``settlement_proof`` to the block that committed it."""
        self._round_blocks[round_index] = block_index
        self._round_ids[round_index] = ids

    def settle_round_batch(self, round_index: int, scores: np.ndarray,
                           worker_ids: Optional[np.ndarray] = None,
                           model_cid: str = "",
                           timestamp: Optional[float] = None,
                           pool=None,
                           staleness: Optional[np.ndarray] = None
                           ) -> np.ndarray:
        """Vectorized settlement: BadWorkers mask, stake-capped penalties,
        requester transfer, and the Merkle-committed round block — no
        per-worker Python loop. ``worker_ids`` defaults to all workers (the
        common full-participation round). ``timestamp`` lets the protocol
        seal blocks at logical (round-indexed) time so every node — and the
        threaded vs serial drivers — computes identical block hashes.
        ``pool`` (any object with ``map(list_of_thunks)``, e.g.
        ``repro_torch.core.node.ShardWorkerPool``) runs the per-shard slices
        concurrently; the result is bit-identical with or without it.
        Composes prepare → shard fan-out → merge → seal over a single-task
        block, which is exactly the pre-multi-tenant settlement path.
        Returns the (len(scores),) penalty vector aligned with ``scores``."""
        prep = self.prepare_round_batch(round_index, scores, worker_ids,
                                        staleness=staleness)
        # fan the round out across contract shards (pure compute, no state
        # mutation — a shard failure aborts the round with nothing applied
        # and nothing committed)
        if pool is not None and len(prep.thunks) > 1 \
                and self.parallel_leaf_ok():
            results: List[ShardSettlement] = pool.map(prep.thunks)
        else:
            results = [t() for t in prep.thunks]
        seal = self.finish_round_batch(prep, results, model_cid=model_cid)
        blk = self.ledger.append_block(
            seal.txs, timestamp=timestamp,
            record_shards=seal.shards or None,
            shard_trees=seal.trees or None,
            record_delta=seal.delta,
            chunk_size=seal.chunk_size, task_id=self.task_id)
        self.note_block(round_index, prep.ids, blk.index)
        return seal.penalties

    def settle_round(self, round_index: int, scores: Dict[str, float],
                     model_cid: str = "") -> Dict[str, float]:
        """Deprecated scalar settlement — use ``settle_round_batch`` (or
        ``contract.legacy.settle_round`` for intentionally scalar
        callers)."""
        warnings.warn(
            "TrustContract.settle_round is deprecated; use "
            "settle_round_batch (or contract.legacy.settle_round)",
            DeprecationWarning, stacklevel=2)
        return self._settle_round_scalar(round_index, scores, model_cid)

    def _settle_round_scalar(self, round_index: int,
                             scores: Dict[str, float],
                             model_cid: str = "") -> Dict[str, float]:
        """Legacy scalar API: score dict in, penalties dict out (bad workers
        only, matching the original loop). Thin wrapper over the batch path;
        dict order is normalized exactly like the original ``sorted`` loop."""
        unknown = set(scores) - set(self._index)
        if unknown:
            raise ContractError(f"scores from non-participants: {unknown}")
        names = sorted(scores)
        ids = np.asarray([self._index[n] for n in names], np.int64)
        s = np.asarray([float(scores[n]) for n in names], np.float64)
        pen = self.settle_round_batch(round_index, s, worker_ids=ids,
                                      model_cid=model_cid)
        bad = s < self.T
        return {n: float(p) for n, p, b in zip(names, pen, bad) if b}

    # -- task finalization (Alg. 1 steps 6 & 8), vectorized -------------------

    def finalize(self, timestamp: Optional[float] = None) -> Dict[str, float]:
        """Refund remaining stakes; pay top-k by mean score (``argpartition``
        selection, stable tie-break by join order). Returns payouts."""
        if self.closed:
            raise ContractError("already finalized")
        self.closed = True
        W = self.num_workers
        refund = self.stake.copy()                       # Refund(w) = D(w)
        self.balance += refund
        self.stake[:] = 0.0
        reward = np.zeros(W, np.float64)
        k = min(self.k, W)
        if W and k > 0:                                  # k<=0: refunds only
            mean = self.score_sum / np.maximum(self.score_count, 1)
            if k < W:
                # argpartition finds the k-th mean; membership is then made
                # tie-stable by hand (strictly-better workers + boundary
                # ties in join order) — matching the legacy stable sort
                kth = mean[np.argpartition(-mean, k - 1)[k - 1]]
                above = np.nonzero(mean > kth)[0]
                ties = np.nonzero(mean == kth)[0]
                top = np.concatenate([above, ties[: k - len(above)]])
            else:
                top = np.arange(W)
            share = self.reward_pool / k                 # R_total / k
            reward[top] = share
            self.balance += reward
            self.reward_pool = 0.0
        ids = np.arange(W)
        records = encode_settlement_records(-1, ids, np.zeros(W), -refund,
                                            np.zeros(W)) if W else None
        txs = self.pending
        self.pending = []
        txs.append({"type": "finalize_batch", "workers": W,
                    "refund_total": float(refund.sum()),
                    "reward_total": float(reward.sum()),
                    "top_k": int(min(self.k, W)) if W else 0})
        self.ledger.append_block(txs, timestamp=timestamp,
                                 record_batch=records,
                                 chunk_size=self.merkle_chunk_size,
                                 task_id=self.task_id)
        payout = refund + reward
        return {self._names[i]: float(payout[i]) for i in range(W)}

    # -- per-worker audit -----------------------------------------------------

    def record_position(self, round_index: int, worker_id: int) -> int:
        """Where a worker's record sits in the round's block commit: dense
        rounds commit only the participating records (the position is the
        worker's rank among the round's ids); sparse (delta) rounds commit
        the *full population* with record index == worker id — so idle
        workers are provable in every delta block too."""
        if self._round_full_cover.get(round_index):
            return int(worker_id)
        ids = self._round_ids[round_index]
        return int(np.nonzero(ids == worker_id)[0][0])

    def proof(self, round_index: int, worker) -> SettlementProof:
        """O(log(W/k) + k) typed proof that worker ``worker`` (id or name)
        was settled as recorded in ``round_index``'s block: the record's
        chunk (the k records sharing its Merkle leaf, ``offset`` locating
        the record within it), the node path to the block root —
        chunk-in-shard, shard-in-task, and (on multi-task blocks)
        task-in-block levels concatenated — and the decoded record view.
        Verify with ``proof.verify(head)`` against any trusted head (a
        ``Block``, a light client's ``BlockHeader``, or a root string)."""
        wid = worker if isinstance(worker, (int, np.integer)) \
            else self._index[worker]
        block_index = self._round_blocks[round_index]
        pos = self.record_position(round_index, int(wid))
        return build_settlement_proof(self.ledger, block_index, pos,
                                      task_id=self.task_id,
                                      decode=decode_settlement_record)

    def settlement_proof(self, round_index: int, worker) -> Dict:
        """Deprecated dict view of :meth:`proof` — bit-identical to the
        pre-redesign output (property-tested); new code should carry the
        typed ``SettlementProof``."""
        return self.proof(round_index, worker).as_legacy_dict()

    def verify_settlement(self, proof) -> bool:
        """Deprecated wrapper over ``SettlementProof.verify``: accepts the
        legacy proof dict (or a ``SettlementProof``) and checks it against
        this ledger's committed block head. Malformed (attacker-supplied)
        proofs are rejected, never raised on."""
        try:
            sp = proof if isinstance(proof, SettlementProof) \
                else SettlementProof.from_legacy(proof)
            head = self.ledger.blocks[sp.block_index]
        except (TypeError, ValueError, IndexError, KeyError):
            # any malformed shape — unsized chunk, non-buffer leaf, missing
            # keys, out-of-chain block index — is rejected, never raised on
            return False
        return sp.verify(head)

    def _worker_scores(self, index: int) -> List[float]:
        out = []
        for ids, s in self._score_log:
            pos = np.nonzero(ids == index)[0]
            if len(pos):
                out.append(float(s[pos[0]]))
        return out

    # -- fork support (repro_torch.net): state snapshot / restore ------------------

    def snapshot(self) -> Dict[str, object]:
        """Deep-enough copy of all consensus-visible contract state (plus
        the audit maps that keep ``proof``/``settlement_proof`` working),
        keyed for ``restore``. A network node snapshots after every
        applied block so a fork-choice reorg can roll state back to the
        common ancestor and replay the winning branch
        (``repro_torch.net.fork_choice``). O(W) per call — sized for the
        simulated-network harness, not the million-worker dense path."""
        return {
            "stake": self.stake.copy(),
            "balance": self.balance.copy(),
            "penalized_rounds": self.penalized_rounds.copy(),
            "score_sum": self.score_sum.copy(),
            "score_count": self.score_count.copy(),
            "reward_pool": self.reward_pool,
            "requester_balance": self.requester_balance,
            "closed": self.closed,
            "pending": list(self.pending),
            "score_log": list(self._score_log),
            "round_blocks": dict(self._round_blocks),
            "round_ids": dict(self._round_ids),
            "round_full_cover": dict(self._round_full_cover),
            "pop_records": None if self._pop_records is None
            else self._pop_records.copy(),
            "last_commit": self._last_commit,
            "rounds_since_base": self._rounds_since_base,
        }

    def restore(self, snap: Dict[str, object]) -> None:
        """Roll state back to a ``snapshot``. The snapshot stays valid
        (restoring copies again), so one ancestor snapshot can anchor
        several competing replays. Enrollment cannot be rolled back
        (names/ids are append-only): restoring across a population change
        raises."""
        if len(snap["stake"]) != self.num_workers:
            raise ContractError(
                f"snapshot covers {len(snap['stake'])} workers, contract "
                f"has {self.num_workers} — enrollment is not rollbackable")
        self.stake = snap["stake"].copy()
        self.balance = snap["balance"].copy()
        self.penalized_rounds = snap["penalized_rounds"].copy()
        self.score_sum = snap["score_sum"].copy()
        self.score_count = snap["score_count"].copy()
        self.reward_pool = snap["reward_pool"]
        self.requester_balance = snap["requester_balance"]
        self.closed = snap["closed"]
        self.pending = list(snap["pending"])
        self._score_log = list(snap["score_log"])
        self._round_blocks = dict(snap["round_blocks"])
        self._round_ids = dict(snap["round_ids"])
        self._round_full_cover = dict(snap["round_full_cover"])
        pop = snap["pop_records"]
        self._pop_records = None if pop is None else pop.copy()
        self._last_commit = snap["last_commit"]
        self._rounds_since_base = snap["rounds_since_base"]

    # -- conservation invariant (property tests) -----------------------------

    def total_value(self) -> float:
        """Money is conserved: pool + requester + stakes + balances."""
        return (self.reward_pool + self.requester_balance +
                float(self.stake.sum()) + float(self.balance.sum()))


class LegacyContractAPI:
    """Explicit namespace for the scalar per-worker contract API.

    ``contract.legacy.join(name)`` and ``contract.legacy.settle_round(r,
    scores_dict)`` keep the original single-worker semantics (thin,
    equivalence-tested wrappers over the batch path) for small demos and
    back-compat callers — without the ``DeprecationWarning`` that calling
    ``join``/``settle_round`` directly on the contract now emits. The
    documented surface is ``join_batch`` / ``settle_round_batch``."""

    __slots__ = ("_contract",)

    def __init__(self, contract: TrustContract) -> None:
        self._contract = contract

    def join(self, worker_id: str) -> None:
        """Scalar enrollment (one-row batch)."""
        self._contract._join_scalar(worker_id)

    def settle_round(self, round_index: int, scores: Dict[str, float],
                     model_cid: str = "") -> Dict[str, float]:
        """Scalar settlement: score dict in, bad-worker penalties out."""
        return self._contract._settle_round_scalar(round_index, scores,
                                                   model_cid)
