"""Multi-node semi-decentralized settlement (the `repro_torch.net` tentpole).

Each ``SettlementNode`` owns one cluster of workers plus a full local
replica of the chain: its own ``Ledger``, ``TrustContract`` (enrolling
the *whole* federation so every replica prices penalties identically),
``IPFSStore``/``ClusterExchange``, and a ``BlockTree`` for fork
tracking. Nodes exchange four gossip messages over ``repro_torch.net.sim``:

- ``ScoreGossip`` — a cluster head's trust scores for its own workers,
- ``AggregateGossip`` — the cluster aggregate's cid *plus the raw
  blob*, ingested content-verified into the receiver's store,
- ``BlockGossip`` — a sealed block with its record commit, flooded
  with per-hash dedup so every replica eventually sees every seal,
- ``ChainRequest``/``ChainResponse`` — post-partition catch-up (a node
  that receives an orphan block asks the sender for its chain).

Round protocol (driven by ``NetworkHarness``): at the round start every
node broadcasts its scores + aggregate; then proposer slots open in
candidate-rank order — rank 0 is the proposer drawn from the head-hash
randomness beacon (``Ledger.randomness_from``), rank j is the j-th
backup. A node proposes in its slot only if the round is still
unsettled on its chain, so under normal latency exactly one block per
partition side is sealed; lost proposals are healed by backups and the
resulting short forks by fork choice (``repro_torch.net.fork_choice``).

Byzantine behavior and its on-chain consequences:

- An **equivocating head** (``EquivocatingNode``) seals two different
  blocks for one (round, proposer) slot and ships one variant to half
  its peers. Replicas relay blocks, so some honest node sees both,
  records ``equivocation`` evidence (invalidating both variants and
  every descendant), relays the conflict, and blanket-rejects the
  offender's future seals. The evidence transaction lands in a later
  honest block; *applying* that block slashes the offender's head
  worker — trust penalization of head misbehavior, on-chain.
- A **tampering head** (``TamperingNode``) seals an honest block but
  gossips it with forged settlement records (an inflated stake). The
  receiver validates records semantically against its own replica state
  *before* applying (exact-float penalty/stake recomputation — the
  LightClient-style check on receipt), rejects the block, and records
  ``tampered_block`` evidence. The proposer's ``sync_head``-visible
  fork becomes a real reorg once the honest fork outgrows it.

Determinism: scores come from a seeded per-round generator shared by
all honest nodes, blocks are sealed at logical timestamps
(``float(round+1)``), and non-proposers apply settlement records with
the *same vectorized numpy ops in the same id order* as the proposer's
``finish_round_batch`` — so replica contract state is bit-equal to the
proposer's, and to a from-scratch replay of the winning chain
(``replay_chain``), which the property tests assert byte-for-byte.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.chain.contract import (_RECORD_DTYPE, TrustContract,
                                  encode_settlement_records)
from repro_torch.chain.ipfs import IPFSStore
from repro_torch.chain.ledger import (Block, DeltaCommit, Ledger, MultiTaskCommit,
                                RecordBatch, ShardedCommit)
from repro_torch.core.gossip import ClusterExchange
from repro_torch.net.fork_choice import BlockTree, seal_info
from repro_torch.net.sim import LinkSpec, Partition, SimNet

__all__ = ["ScoreGossip", "AggregateGossip", "BlockGossip", "HeadAnnounce",
           "ChainRequest",
           "ChainResponse", "SettlementNode", "EquivocatingNode",
           "TamperingNode", "NetworkHarness", "replay_chain",
           "settlement_records", "apply_block_state", "contract_fingerprint",
           "make_score_fn", "head_worker"]


# -- wire messages ----------------------------------------------------------

@dataclass(frozen=True)
class ScoreGossip:
    """A cluster head's trust scores for its own workers this round."""

    round_index: int
    cluster: int
    worker_ids: Tuple[int, ...]
    scores: Tuple[float, ...]


@dataclass(frozen=True)
class AggregateGossip:
    """A cluster aggregate: content address + the raw blob bytes (the
    receiver verifies blob-hash == cid before storing — §III.A's
    fetch-by-hash, pushed)."""

    round_index: int
    cluster: int
    cid: str
    blob: bytes


@dataclass(frozen=True)
class BlockGossip:
    """A sealed block plus its off-chain record commit."""

    block: Block
    commit: Optional[MultiTaskCommit]


@dataclass(frozen=True)
class HeadAnnounce:
    """Periodic head advertisement (sent at every round start and by
    ``NetworkHarness.sync``): a receiver that does not know the
    announced head chain-syncs from the sender — the retransmission
    path that heals blocks lost to message drops."""

    height: int
    head: str


@dataclass(frozen=True)
class ChainRequest:
    """Ask a peer for its canonical chain from ``from_index`` up."""

    from_index: int


@dataclass(frozen=True)
class ChainResponse:
    blocks: Tuple[Block, ...]
    commits: Tuple[Optional[MultiTaskCommit], ...]


# -- deterministic scoring ---------------------------------------------------

def make_score_fn(score_seed: int, population: int):
    """Every honest node draws the *same* per-round population scores
    (seeded by (score_seed, round)) and slices out its own cluster —
    the stand-in for "evaluate local updates against the shared task"
    that keeps replicas byte-reproducible."""

    def score_fn(round_index: int, ids: np.ndarray) -> np.ndarray:
        rng = np.random.default_rng([int(score_seed), int(round_index)])
        s = 0.3 + 0.7 * rng.random(population)
        return s[np.asarray(ids, np.int64)]

    return score_fn


def head_worker(round_index: int, proposer: int, workers_per_node: int) -> int:
    """The worker account slashed for a proposer's misbehavior evidence:
    head duty rotates over the proposer's own cluster by round."""
    return proposer * workers_per_node + round_index % workers_per_node


# -- record application (shared by replicas and replay) ----------------------

def settlement_records(commit: MultiTaskCommit,
                       round_index: int) -> np.ndarray:
    """The round's settlement record rows out of a block commit. Dense
    (``ShardedCommit``) commits must be entirely this round's rows;
    sparse (``DeltaCommit``) commits are the full population overlay, so
    the round's changed rows are filtered out by their round stamp."""
    c = commit.commit_for(None)
    if isinstance(c, DeltaCommit):
        batch = c.materialize()
        rows = np.frombuffer(batch.buf, _RECORD_DTYPE)
        return rows[rows["round"] == round_index]
    rows = np.concatenate([np.frombuffer(s.buf, _RECORD_DTYPE)
                           for s in c.shards])
    if not (rows["round"] == round_index).all():
        raise ValueError("commit contains rows from a foreign round")
    return rows


def apply_block_state(contract: TrustContract, block: Block,
                      commit: Optional[MultiTaskCommit],
                      onchain_evidence: Set[Tuple[int, int]],
                      workers_per_node: int) -> None:
    """Apply one adopted block's settlement records + evidence to a
    replica contract — the same vectorized transitions, in the same id
    order, as the proposer's ``finish_round_batch``, so replica state is
    bit-equal to the sealing node's."""
    info = seal_info(block)
    if info is None:
        return
    round_index, _proposer = info
    if commit is not None:
        rec = settlement_records(commit, round_index)
        ids = rec["worker"].astype(np.int64)
        s = rec["score"].astype(np.float64)
        bad = s < contract.T
        contract.stake[ids] = rec["stake_after"]
        contract.penalized_rounds[ids] += bad
        contract.requester_balance += float(rec["penalty"].sum())
        contract.score_sum[ids] += s
        contract.score_count[ids] += 1
        contract._score_log.append((ids, s))
        contract.note_block(round_index, ids, block.index)
    for tx in block.transactions:
        if not isinstance(tx, dict):
            continue
        if tx.get("type") in ("equivocation", "tampered_block"):
            key = (int(tx["round"]), int(tx["proposer"]))
            if key in onchain_evidence:
                continue
            w = int(tx["worker"])
            pen = min(contract.F * contract.P / 100.0,
                      float(contract.stake[w]))
            contract.stake[w] -= pen
            contract.requester_balance += pen
            contract.penalized_rounds[w] += 1
            onchain_evidence.add(key)


def contract_fingerprint(contract: TrustContract) -> Dict[str, bytes]:
    """Byte-exact digest of consensus-visible contract state, for
    bit-equality assertions across replicas and replays."""
    return {
        "stake": contract.stake.tobytes(),
        "balance": contract.balance.tobytes(),
        "penalized_rounds": contract.penalized_rounds.tobytes(),
        "score_sum": contract.score_sum.tobytes(),
        "score_count": contract.score_count.tobytes(),
        "requester_balance": np.float64(
            contract.requester_balance).tobytes(),
        "reward_pool": np.float64(contract.reward_pool).tobytes(),
    }


def replay_chain(blocks: Sequence[Block],
                 commits: Dict[int, Optional[MultiTaskCommit]],
                 workers_per_node: int,
                 merkle_chunk_size: int = 4
                 ) -> Tuple[Ledger, TrustContract]:
    """Single-node replay oracle: rebuild a fresh ledger + contract from
    a chain's own deployment block and apply every settlement record and
    evidence transaction. The property tests assert a live replica's
    state is bit-equal to this replay of its canonical chain."""
    ledger = Ledger()
    if not blocks or blocks[0].hash != ledger.head.hash:
        raise ValueError("chain does not start at the shared genesis")
    deploy_blk = blocks[1]
    deploy = next(tx for tx in deploy_blk.transactions
                  if tx.get("type") == "deploy")
    join = next(tx for tx in deploy_blk.transactions
                if tx.get("type") == "join_batch")
    contract = TrustContract(
        ledger, requester_deposit=deploy["deposit"],
        worker_stake=deploy["F"], penalty_pct=deploy["P"],
        trust_threshold=deploy["T"], top_k=deploy["k"],
        merkle_chunk_size=merkle_chunk_size)
    contract.join_batch(join["count"])
    contract.pending = []
    ledger.adopt_block(deploy_blk)
    onchain_evidence: Set[Tuple[int, int]] = set()
    for blk in blocks[2:]:
        commit = commits.get(blk.index)
        ledger.adopt_block(blk, commit)
        apply_block_state(contract, blk, commit, onchain_evidence,
                          workers_per_node)
    return ledger, contract


# -- the settlement node -----------------------------------------------------

class SettlementNode:
    """One cluster head + full chain replica on the simulated network."""

    def __init__(self, node_id: int, net: SimNet, *, num_nodes: int,
                 workers_per_node: int = 2, score_seed: int = 7,
                 requester_deposit: float = 1000.0,
                 worker_stake: float = 10.0, penalty_pct: float = 50.0,
                 trust_threshold: float = 0.5, top_k: int = 4,
                 merkle_chunk_size: int = 4, score_fn=None) -> None:
        self.node_id = int(node_id)
        self.net = net
        self.num_nodes = int(num_nodes)
        self.workers_per_node = int(workers_per_node)
        population = self.num_nodes * self.workers_per_node
        self.ledger = Ledger()
        self.contract = TrustContract(
            self.ledger, requester_deposit=requester_deposit,
            worker_stake=worker_stake, penalty_pct=penalty_pct,
            trust_threshold=trust_threshold,
            top_k=min(top_k, population),
            merkle_chunk_size=merkle_chunk_size)
        self.contract.join_batch(population)
        # identical deterministic deployment block on every node: the
        # shared 2-block base chain every fork descends from
        deploy_txs = list(self.contract.pending)
        self.contract.pending = []
        self.ledger.append_block(deploy_txs, timestamp=0.0)
        self.tree = BlockTree(list(self.ledger.blocks))
        self.exchange = ClusterExchange(IPFSStore(), self.ledger,
                                        num_clusters=self.num_nodes)
        self.score_fn = score_fn if score_fn is not None \
            else make_score_fn(score_seed, population)
        # per-height contract snapshots anchor reorg rollbacks
        self._onchain_evidence: Set[Tuple[int, int]] = set()
        self._snapshots: Dict[int, Tuple[dict, Set[Tuple[int, int]]]] = {}
        self._snapshot()
        # round state + misbehavior tracking
        self._scores: Dict[int, Dict[int, Tuple[np.ndarray, np.ndarray]]] = {}
        self._own_aggregate: Dict[int, object] = {}
        self._proposed_rounds: Set[int] = set()
        self._blocks_by_slot: Dict[Tuple[int, int], str] = {}
        self._equivocators: Set[int] = set()
        self._evidence_pool: List[dict] = []
        self._rejected_hashes: Set[str] = set()
        self._orphans: Dict[str, Tuple[Block, Optional[MultiTaskCommit]]] = {}
        self._relayed: Set[str] = set()
        self._sync_requested: Set[Tuple[int, int]] = set()
        self._mute_relay = False
        # observability counters (benchmarks + tests)
        self.reorgs = 0
        self.rejected_blocks = 0
        self.rejected_aggregates = 0
        self.stale_messages = 0
        self.malformed_messages = 0
        self.evidence_found = 0
        net.register(self.node_id, self.on_message)

    # -- identity ------------------------------------------------------------

    @property
    def cluster_ids(self) -> np.ndarray:
        base = self.node_id * self.workers_per_node
        return np.arange(base, base + self.workers_per_node)

    def candidate_rank(self, round_index: int) -> int:
        """This node's position in the round's proposer rotation, drawn
        from the randomness beacon over *this replica's* head — rank 0
        is the primary proposer, rank j the j-th backup."""
        primary = Ledger.randomness_from(
            self.ledger.head.hash, round_index) % self.num_nodes
        return (self.node_id - primary) % self.num_nodes

    def verify(self) -> bool:
        return self.ledger.verify_chain(deep=True)

    # -- round protocol ------------------------------------------------------

    def announce_head(self) -> None:
        """Advertise the canonical head; peers missing it will sync.
        Opens a fresh sync epoch (prior request dedup is cleared, so a
        lost ChainResponse is retried on the next announcement wave)."""
        self._sync_requested.clear()
        self.net.broadcast(self.node_id, HeadAnnounce(
            self.ledger.head.index, self.ledger.head.hash))

    def begin_round(self, round_index: int) -> None:
        """Score own cluster, publish the cluster aggregate, gossip both."""
        self.announce_head()
        ids = self.cluster_ids
        scores = np.asarray(self.score_fn(round_index, ids), np.float64)
        self._scores.setdefault(round_index, {})[self.node_id] = (ids, scores)
        aggregate = {"cluster_mean": np.asarray(
            [float(round_index), float(scores.mean())], np.float32)}
        self._own_aggregate[round_index] = aggregate
        cid = self.exchange.publish(round_index, self.node_id, aggregate)
        _, blob = self.exchange.blob(round_index, self.node_id)
        self.net.broadcast(self.node_id, ScoreGossip(
            round_index, self.node_id,
            tuple(int(i) for i in ids), tuple(float(x) for x in scores)))
        self.net.broadcast(self.node_id, AggregateGossip(
            round_index, self.node_id, cid, blob))

    def maybe_propose(self, round_index: int,
                      rank_slot: int) -> Optional[Block]:
        """Seal the round iff this node holds the slot's rank on its own
        chain and the round is still unsettled there. One proposal per
        round per node, ever — a mid-round reorg shifting ranks must not
        make an honest node equivocate."""
        if round_index in self._proposed_rounds:
            return None
        if round_index in self.contract._round_blocks:
            return None
        if self.candidate_rank(round_index) != rank_slot:
            return None
        return self._propose(round_index)

    def _propose(self, round_index: int) -> Block:
        clusters = sorted(self._scores.get(round_index, {}))
        ids = np.concatenate(
            [self._scores[round_index][c][0] for c in clusters])
        scores = np.concatenate(
            [self._scores[round_index][c][1] for c in clusters])
        evidence = [tx for tx in self._evidence_pool
                    if (tx["round"], tx["proposer"])
                    not in self._onchain_evidence]
        pend: List[dict] = list(evidence)
        pend.extend(self.exchange.round_transactions(round_index))
        pend.append({"type": "seal", "round": int(round_index),
                     "proposer": self.node_id,
                     "trust": float(scores.sum())})
        saved = list(self.contract.pending)
        self.contract.pending = saved + pend
        try:
            self.contract.settle_round_batch(
                round_index, scores, worker_ids=ids,
                timestamp=float(round_index + 1))
        except BaseException:
            self.contract.pending = saved
            raise
        self._proposed_rounds.add(round_index)
        blk = self.ledger.head
        commit = self.ledger.commit(blk.index)
        # settle applied the records; evidence is the remaining state delta
        for tx in evidence:
            key = (tx["round"], tx["proposer"])
            if key in self._onchain_evidence:
                continue
            w = int(tx["worker"])
            pen = min(self.contract.F * self.contract.P / 100.0,
                      float(self.contract.stake[w]))
            self.contract.stake[w] -= pen
            self.contract.requester_balance += pen
            self.contract.penalized_rounds[w] += 1
            self._onchain_evidence.add(key)
        self.tree.add(blk, commit)
        self._blocks_by_slot[(round_index, self.node_id)] = blk.hash
        self._snapshot()
        self._relay(BlockGossip(blk, commit))
        return blk

    # -- gossip ingest -------------------------------------------------------

    def on_message(self, src: int, msg) -> None:
        if isinstance(msg, ScoreGossip):
            self._on_scores(src, msg)
        elif isinstance(msg, AggregateGossip):
            self._on_aggregate(src, msg)
        elif isinstance(msg, BlockGossip):
            self._on_block(src, msg)
        elif isinstance(msg, HeadAnnounce):
            self._on_head_announce(src, msg)
        elif isinstance(msg, ChainRequest):
            self._on_chain_request(src, msg)
        elif isinstance(msg, ChainResponse):
            self._on_chain_response(src, msg)
        else:
            self.malformed_messages += 1

    def _on_scores(self, src: int, m: ScoreGossip) -> None:
        try:
            r = int(m.round_index)
            cluster = int(m.cluster)
            ids = np.asarray(m.worker_ids, np.int64)
            scores = np.asarray(m.scores, np.float64)
        except (TypeError, ValueError):
            self.malformed_messages += 1
            return
        lo = cluster * self.workers_per_node
        hi = lo + self.workers_per_node
        if (r < 0 or cluster != src or len(ids) != len(scores)
                or len(ids) == 0 or len(np.unique(ids)) != len(ids)
                or ids.min() < lo or ids.max() >= hi
                or not np.isfinite(scores).all()
                or scores.min() < 0.0 or scores.max() > 1.0):
            self.malformed_messages += 1
            return
        if r in self.contract._round_blocks:
            self.stale_messages += 1
            return
        order = np.argsort(ids, kind="stable")
        self._scores.setdefault(r, {})[cluster] = (ids[order], scores[order])

    def _on_aggregate(self, src: int, m: AggregateGossip) -> None:
        try:
            self.exchange.ingest(int(m.round_index), int(m.cluster),
                                 m.cid, m.blob)
        except (TypeError, ValueError):
            self.rejected_aggregates += 1

    def merged_aggregate(self, round_index: int):
        """Trust-weighted fold of peers' gossiped aggregates into this
        node's own (§III.A cross-cluster exchange over the network)."""
        like = self._own_aggregate[round_index]
        counts = np.maximum(self.contract.score_count, 1)
        mean = self.contract.score_sum / counts
        per_cluster = mean.reshape(self.num_nodes,
                                   self.workers_per_node).mean(axis=1)
        return self.exchange.merge(round_index, self.node_id, like,
                                   peer_trust=per_cluster)

    def _on_block(self, src: int, m: BlockGossip) -> None:
        blk, commit = m.block, m.commit
        if not isinstance(blk, Block):
            self.malformed_messages += 1
            return
        h = blk.hash
        if h in self.tree or h in self._rejected_hashes:
            return
        if blk.compute_hash() != h:
            self.rejected_blocks += 1
            self._rejected_hashes.add(h)
            return
        info = seal_info(blk)
        if info is None:
            self.rejected_blocks += 1
            self._rejected_hashes.add(h)
            return
        r, proposer = info
        if not (0 <= proposer < self.num_nodes) or r < 0:
            self.rejected_blocks += 1
            self._rejected_hashes.add(h)
            return
        if proposer in self._equivocators:
            self.rejected_blocks += 1
            self._rejected_hashes.add(h)
            return
        prev = self._blocks_by_slot.get((r, proposer))
        if prev is not None and prev != h:
            self._record_equivocation(r, proposer, prev, h, m)
            return
        if blk.prev_hash not in self.tree:
            self._orphans[h] = (blk, commit)
            self._request_sync(src)
            return
        self._admit(blk, commit, r, proposer)
        self._try_orphans()
        self._maybe_reorg()

    def _admit(self, blk: Block, commit, r: int, proposer: int) -> None:
        self.tree.add(blk, commit)
        self._blocks_by_slot[(r, proposer)] = blk.hash
        self._relay(BlockGossip(blk, commit))

    def _try_orphans(self) -> None:
        progress = True
        while progress:
            progress = False
            for h in list(self._orphans):
                blk, commit = self._orphans[h]
                info = seal_info(blk)
                if info is None or info[1] in self._equivocators \
                        or h in self._rejected_hashes:
                    del self._orphans[h]
                    continue
                if blk.prev_hash in self.tree:
                    del self._orphans[h]
                    self._admit(blk, commit, *info)
                    progress = True

    def _record_equivocation(self, r: int, proposer: int, prev_hash: str,
                             new_hash: str, m: BlockGossip) -> None:
        """Two distinct seals for one (round, proposer) slot: both become
        invalid, the offender is blanket-rejected from now on, and a
        slash-on-inclusion evidence transaction joins the pool."""
        self._equivocators.add(proposer)
        self.evidence_found += 1
        self.tree.invalidate(prev_hash)
        self._rejected_hashes.add(new_hash)
        self._add_evidence({
            "type": "equivocation", "round": int(r),
            "proposer": int(proposer),
            "worker": head_worker(r, proposer, self.workers_per_node),
            "blocks": sorted([prev_hash, new_hash])})
        self._relay(m)                 # let peers see the conflict too
        self._maybe_reorg()

    def _add_evidence(self, tx: dict) -> None:
        key = (tx["round"], tx["proposer"])
        for existing in self._evidence_pool:
            if (existing["round"], existing["proposer"]) == key:
                return
        self._evidence_pool.append(tx)

    def _on_head_announce(self, src: int, m: HeadAnnounce) -> None:
        try:
            head = str(m.head)
            height = int(m.height)
        except (TypeError, ValueError):
            self.malformed_messages += 1
            return
        if height < 0 or len(head) != 64:
            self.malformed_messages += 1
            return
        if head not in self.tree and head not in self._rejected_hashes:
            self._request_sync(src)

    def _request_sync(self, src: int) -> None:
        key = (src, self.ledger.head.index)
        if key in self._sync_requested:
            return
        self._sync_requested.add(key)
        self.net.send(self.node_id, src, ChainRequest(2))

    def _on_chain_request(self, src: int, m: ChainRequest) -> None:
        try:
            start = int(m.from_index)
        except (TypeError, ValueError):
            self.malformed_messages += 1
            return
        if start < 0:
            self.malformed_messages += 1
            return
        blocks = tuple(self.ledger.blocks[start:])
        commits = tuple(self.ledger._commits.get(b.index) for b in blocks)
        self.net.send(self.node_id, src, ChainResponse(blocks, commits))

    def _on_chain_response(self, src: int, m: ChainResponse) -> None:
        if len(m.blocks) != len(m.commits):
            self.malformed_messages += 1
            return
        for blk, commit in zip(m.blocks, m.commits):
            self._on_block(src, BlockGossip(blk, commit))

    def _relay(self, msg: BlockGossip) -> None:
        if self._mute_relay or msg.block.hash in self._relayed:
            return
        self._relayed.add(msg.block.hash)
        self.net.broadcast(self.node_id, msg)

    # -- fork choice + state transitions --------------------------------------

    def _snapshot(self) -> None:
        self._snapshots[self.ledger.head.index] = (
            self.contract.snapshot(), set(self._onchain_evidence))

    def _maybe_reorg(self) -> None:
        """Re-run fork choice; when the winner moves, roll contract +
        ledger back to the common ancestor's snapshot and replay the
        winning branch with full semantic validation per block. A branch
        whose block fails validation is invalidated (with evidence) and
        fork choice re-runs without it."""
        while True:
            best = self.tree.best_head()
            cur = self.ledger.head.hash
            if best == cur:
                return
            anc = self.tree.ancestor(cur, best)
            anc_index = self.tree.height(anc)
            root_index = self.tree.height(self.tree.root)
            path = self.tree.chain_to(best)[anc_index - root_index + 1:]
            snap, evidence = self._snapshots[anc_index]
            self.ledger.rollback_to(anc_index)
            self.contract.restore(snap)
            self._onchain_evidence = set(evidence)
            for i in list(self._snapshots):
                if i > anc_index:
                    del self._snapshots[i]
            if anc != cur:
                self.reorgs += 1
            clean = True
            for blk in path:
                commit = self.tree.commit(blk.hash)
                err = self._validate_block(blk, commit)
                if err is None:
                    try:
                        self.ledger.adopt_block(blk, commit)
                    except ValueError as exc:
                        err = str(exc)
                if err is not None:
                    self._flag_invalid(blk, err)
                    clean = False
                    break
                apply_block_state(self.contract, blk, commit,
                                  self._onchain_evidence,
                                  self.workers_per_node)
                self._register_block_cids(blk)
                self._snapshot()
            if clean:
                return

    def _validate_block(self, blk: Block, commit) -> Optional[str]:
        """Semantic validation against the replica's own state at the
        block's parent — the tampered-records check. Exact float
        equality is correct here: honest penalties/stakes are computed
        by the identical numpy expressions from identical inputs."""
        info = seal_info(blk)
        if info is None:
            return "missing seal"
        r, _proposer = info
        if r in self.contract._round_blocks:
            return f"round {r} already settled on this fork"
        has_settlement = any(
            isinstance(tx, dict) and tx.get("type") == "settlement_batch"
            for tx in blk.transactions)
        if not blk.records_root:
            return "settlement without records" if has_settlement else None
        if commit is None:
            return "records_root without a shipped commit"
        try:
            rec = settlement_records(commit, r)
        except (ValueError, KeyError) as exc:
            return f"bad commit: {exc}"
        ids = rec["worker"].astype(np.int64)
        s = rec["score"].astype(np.float64)
        if len(ids) == 0 or len(np.unique(ids)) != len(ids) \
                or (np.diff(ids) < 0).any():
            return "records not in canonical id order"
        if ids.min() < 0 or ids.max() >= self.contract.num_workers:
            return "records for unknown workers"
        if not np.isfinite(s).all():
            return "non-finite scores"
        stake_before = self.contract.stake[ids]
        full_pen = self.contract.F * self.contract.P / 100.0
        expect_pen = np.where(s < self.contract.T,
                              np.minimum(full_pen, stake_before), 0.0)
        if not np.array_equal(rec["penalty"], expect_pen):
            return "penalty mismatch (tampered records)"
        if not np.array_equal(rec["stake_after"], stake_before - expect_pen):
            return "stake mismatch (tampered records)"
        batch_tx = next(
            (tx for tx in blk.transactions if isinstance(tx, dict)
             and tx.get("type") == "settlement_batch"), None)
        if batch_tx is None:
            return "records without a settlement_batch tx"
        if (batch_tx.get("round") != r
                or batch_tx.get("workers") != len(ids)
                or batch_tx.get("bad_count")
                != int((s < self.contract.T).sum())
                or batch_tx.get("total_penalty")
                != float(expect_pen.sum())):
            return "settlement_batch tx mismatch"
        for tx in blk.transactions:
            if isinstance(tx, dict) \
                    and tx.get("type") in ("equivocation", "tampered_block"):
                try:
                    key = (int(tx["round"]), int(tx["proposer"]))
                    w = int(tx["worker"])
                except (KeyError, TypeError, ValueError):
                    return "malformed evidence tx"
                if key in self._onchain_evidence:
                    return "duplicate evidence"
                if not 0 <= w < self.contract.num_workers:
                    return "evidence against unknown worker"
        return None

    def _flag_invalid(self, blk: Block, err: str) -> None:
        self.rejected_blocks += 1
        self.tree.invalidate(blk.hash)
        info = seal_info(blk)
        if info is not None:
            r, proposer = info
            self._add_evidence({
                "type": "tampered_block", "round": int(r),
                "proposer": int(proposer),
                "worker": head_worker(r, proposer, self.workers_per_node),
                "block": blk.hash, "error": err})

    def _register_block_cids(self, blk: Block) -> None:
        for tx in blk.transactions:
            if isinstance(tx, dict) and tx.get("type") == "cluster_model":
                self.exchange.register(int(tx["round"]), int(tx["cluster"]),
                                       tx["cid"])


# -- byzantine heads ---------------------------------------------------------

class EquivocatingNode(SettlementNode):
    """A byzantine cluster head that seals *two* different blocks for
    every round it proposes and ships variant A to half its peers and
    variant B to the rest — the equivocation scenario the evidence path
    must catch for every seed."""

    def maybe_propose(self, round_index: int,
                      rank_slot: int) -> Optional[Block]:
        # always jump the rotation at slot 0 (a byzantine head does not
        # wait its turn), but still only once per round
        if rank_slot != 0 or round_index in self._proposed_rounds \
                or round_index in self.contract._round_blocks:
            return None
        self._mute_relay = True
        try:
            blk = self._propose(round_index)
        finally:
            self._mute_relay = False
        commit_a = self.tree.commit(blk.hash)
        blk_b, commit_b = self._forge_variant(blk, round_index)
        peers = [d for d in self.net.node_ids if d != self.node_id]
        for i, dst in enumerate(peers):
            variant = BlockGossip(blk, commit_a) if i % 2 == 0 \
                else BlockGossip(blk_b, commit_b)
            self.net.send(self.node_id, dst, variant)
        return blk

    def _forge_variant(self, blk: Block,
                       round_index: int) -> Tuple[Block, MultiTaskCommit]:
        """A second, *semantically valid* block for the same slot: same
        parent, same cohort, different scores for the offender's own
        cluster — so only equivocation detection (not record validation)
        can catch it."""
        parent_snap, _ = self._snapshots[blk.index - 1]
        rec = settlement_records(self.tree.commit(blk.hash), round_index)
        ids = rec["worker"].astype(np.int64)
        s = rec["score"].astype(np.float64).copy()
        own = (ids // self.workers_per_node) == self.node_id
        s[own] = np.clip(s[own] * 0.5, 0.0, 1.0)   # always != honest score
        stake_before = parent_snap["stake"][ids]
        full_pen = self.contract.F * self.contract.P / 100.0
        pen = np.where(s < self.contract.T,
                       np.minimum(full_pen, stake_before), 0.0)
        stake_after = stake_before - pen
        records = encode_settlement_records(round_index, ids, s, pen,
                                            stake_after)
        commit = MultiTaskCommit({None: ShardedCommit(
            [records], self.contract.merkle_chunk_size)})
        txs = []
        for tx in blk.transactions:
            if isinstance(tx, dict) and tx.get("type") == "seal":
                tx = {**tx, "trust": float(s.sum())}
            elif isinstance(tx, dict) \
                    and tx.get("type") == "settlement_batch":
                tx = {**tx,
                      "bad_count": int((s < self.contract.T).sum()),
                      "total_penalty": float(pen.sum())}
            txs.append(tx)
        forged = Block(blk.index, blk.prev_hash, txs, blk.timestamp,
                       records_root=commit.root)
        forged.hash = forged.compute_hash()
        return forged, commit


class TamperingNode(SettlementNode):
    """A byzantine head that seals an honest block but gossips it with a
    *tampered commit* — settlement records inflating its own head
    worker's post-round stake. Receivers catch the mismatch in semantic
    validation (the super-root check on receipt) and slash it."""

    def maybe_propose(self, round_index: int,
                      rank_slot: int) -> Optional[Block]:
        if rank_slot != 0 or round_index in self._proposed_rounds \
                or round_index in self.contract._round_blocks:
            return None
        self._mute_relay = True
        try:
            blk = self._propose(round_index)
        finally:
            self._mute_relay = False
        rec = settlement_records(
            self.tree.commit(blk.hash), round_index).copy()
        me = head_worker(round_index, self.node_id, self.workers_per_node)
        mask = rec["worker"] == me
        rec["stake_after"] = np.where(mask, rec["stake_after"] + 5.0,
                                      rec["stake_after"])
        forged = MultiTaskCommit({None: ShardedCommit(
            [RecordBatch(memoryview(rec).cast("B"), _RECORD_DTYPE.itemsize)],
            self.contract.merkle_chunk_size)})
        self.net.broadcast(self.node_id, BlockGossip(blk, forged))
        return blk


# -- the multi-node harness --------------------------------------------------

class NetworkHarness:
    """Deterministic N-node scenario driver. One round =

    1. every node scores + publishes + gossips (``begin_round``),
    2. a gossip window for scores/aggregates to spread,
    3. N staggered proposer slots in candidate-rank order (each slot
       ends with the network draining its deliveries),
    4. a tail window for the sealed block to flood every replica.

    ``byzantine`` maps node id → ``"equivocate" | "tamper"``.
    ``partition_rounds`` are ``(start_round, stop_round, groups)``
    triples, converted to simulated-second ``Partition`` windows."""

    def __init__(self, num_nodes: int, workers_per_node: int = 2, *,
                 seed: int = 0, score_seed: int = 7,
                 link: Optional[LinkSpec] = None,
                 partition_rounds: Sequence[Tuple[int, int, tuple]] = (),
                 byzantine: Optional[Dict[int, str]] = None,
                 gossip_window: float = 0.25, slot_stagger: float = 0.25,
                 round_tail: float = 0.5, **node_kwargs) -> None:
        self.num_nodes = int(num_nodes)
        self.workers_per_node = int(workers_per_node)
        self.gossip_window = gossip_window
        self.slot_stagger = slot_stagger
        self.round_period = (gossip_window
                             + num_nodes * slot_stagger + round_tail)
        partitions = tuple(
            Partition(start * self.round_period, stop * self.round_period,
                      tuple(tuple(g) for g in groups))
            for start, stop, groups in partition_rounds)
        self.net = SimNet(
            seed=seed,
            default_link=link if link is not None
            else LinkSpec(latency=0.02, jitter=0.02),
            partitions=partitions)
        kinds = {"equivocate": EquivocatingNode, "tamper": TamperingNode}
        byzantine = byzantine or {}
        self.byzantine = dict(byzantine)
        self.nodes: List[SettlementNode] = [
            kinds.get(byzantine.get(i), SettlementNode)(
                i, self.net, num_nodes=num_nodes,
                workers_per_node=workers_per_node, score_seed=score_seed,
                **node_kwargs)
            for i in range(num_nodes)]
        self.rounds_run = 0

    def run_round(self) -> None:
        r = self.rounds_run
        t0 = r * self.round_period
        self.net.run(until=t0)
        for node in self.nodes:
            node.begin_round(r)
        self.net.run(until=t0 + self.gossip_window)
        for k in range(self.num_nodes):
            for node in self.nodes:
                node.maybe_propose(r, k)
            self.net.run(until=t0 + self.gossip_window
                         + (k + 1) * self.slot_stagger)
        self.net.run(until=(r + 1) * self.round_period)
        self.rounds_run += 1

    def run(self, rounds: int) -> None:
        for _ in range(rounds):
            self.run_round()

    def sync(self, max_waves: int = 5) -> int:
        """Post-run anti-entropy: head-announcement waves until every
        honest replica converges (or ``max_waves``). Heals blocks whose
        gossip was lost in the *final* round — mid-run losses already
        heal at the next round's announcements. Returns waves used."""
        for wave in range(max_waves):
            if self.converged():
                return wave
            for node in self.nodes:
                node.announce_head()
            self.net.run(until=self.net.now + self.round_period)
        return max_waves

    def honest_nodes(self) -> List[SettlementNode]:
        return [n for n in self.nodes if n.node_id not in self.byzantine]

    def heads(self) -> List[str]:
        return [n.ledger.head.hash for n in self.nodes]

    def chain_hashes(self, node: SettlementNode) -> List[str]:
        return [b.hash for b in node.ledger.blocks]

    def converged(self, honest_only: bool = True) -> bool:
        """All (honest) replicas hold byte-identical chains."""
        nodes = self.honest_nodes() if honest_only else self.nodes
        chains = [self.chain_hashes(n) for n in nodes]
        return all(c == chains[0] for c in chains[1:])
