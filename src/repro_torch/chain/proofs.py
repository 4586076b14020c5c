"""Unified settlement-proof surface + batched Merkle multiproofs.

This module is the single proof/verify surface of the chain stack. It
replaces four historically-separate entry points — ``MerkleTree.verify``
(the hashing primitive), ``Ledger.merkle_proof``/``verify_record`` (bare
node paths), ``TrustContract.settlement_proof``/``verify_settlement``
(untyped dicts), and the per-commit ``record_proof`` methods — with two
typed objects:

``SettlementProof``
    One record's claim against one block: the leaf chunk, the record's
    offset within it, the three-level ``(side, digest)`` node path
    (chunk-in-shard, shard-in-task, task-in-block — exactly the encoding
    every commit flavor emits), and the committed root. ``verify(head)``
    checks the whole claim against a trusted head (a ``Block``, a light
    client's ``BlockHeader``, or a bare root hex string) for every block
    flavor — dense, ``ShardedCommit``, ``DeltaCommit``, and
    ``MultiTaskCommit`` blocks all produce the same path encoding. The
    legacy dict/``verify_settlement`` shapes round-trip losslessly
    (``as_legacy_dict``/``from_legacy``), so the deprecated wrappers emit
    bit-identical proofs.

``ProofBatch``
    A batched multiproof for many records of one task in one block,
    deduplicating shared path structure: each distinct Merkle node is
    shipped (or computed) exactly once, so adjacent workers share all but
    O(log(W/k)) siblings and a 1k-worker batch ships far fewer digests
    than 1k independent proofs. The verifier (``verify_proof_batch``)
    recomputes the block root bottom-up with **one framed sha256 pass per
    tree level** (the ``batch_leaf_digests`` framing from
    ``chain.ledger`` — one packed uint8 matrix, one C call per node row)
    instead of per-record Python hash loops, then checks that every
    claimed record's leaf actually feeds the recomputed root
    (connectivity), and that the root matches the trusted header.
    Tampered or malformed batches are rejected (``False``), never raised
    on.

Wire model: a batch names interior nodes with small structural keys —
``("S", shard, level, pos)`` inside a shard subtree, ``("U", level, pos)``
on the cross-shard super levels, ``("T", level, pos)`` on the cross-task
level, and ``ROOT_KEY`` for the block root. ``plan`` is an ordered list
of levels whose entries are either ``("h", parent, left, right)`` (hash
two children) or ``("p", parent, child)`` (odd-node promotion / stage
alias). The verifier executes the plan level by level; because a node
value may never be redefined and parent links are only created by actual
hash/promotion steps, the recomputed root is fully determined by the
shipped chunks and siblings — there is no way to splice a forged record
into a verifying batch without a SHA-256 collision.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.chain.ledger import (_LEAF_PREFIX, _NODE_PREFIX, Block,
                                DeltaCommit, Ledger, MerkleTree,
                                RecordBatch, _framed_digests)

__all__ = ["BlockHeader", "SettlementProof", "ProofBatch", "ROOT_KEY",
           "build_proof_batch", "verify_proof_batch", "header_of",
           "build_settlement_proof"]


# -- light-client headers ------------------------------------------------------


@dataclass(frozen=True)
class BlockHeader:
    """What a light client holds per block: the consensus-visible block
    body (transactions are O(tasks) summaries — settlement data lives
    off-chain behind ``records_root``) plus the sealed hash. Hashing
    delegates to ``Block.compute_hash`` so header hashes are bit-identical
    to full-node block hashes by construction."""

    index: int
    prev_hash: str
    transactions: Tuple[dict, ...]
    timestamp: float
    records_root: str
    task_roots: Optional[Dict[str, str]]
    hash: str

    def compute_hash(self) -> str:
        return Block(self.index, self.prev_hash, list(self.transactions),
                     self.timestamp, records_root=self.records_root,
                     task_roots=dict(self.task_roots)
                     if self.task_roots else None).compute_hash()


def header_of(blk: Block) -> BlockHeader:
    """The serving-side projection of a sealed block."""
    return BlockHeader(blk.index, blk.prev_hash, tuple(blk.transactions),
                       blk.timestamp, blk.records_root,
                       dict(blk.task_roots) if blk.task_roots else None,
                       blk.hash)


def _expected_root(head: Union[str, Block, BlockHeader]) -> Optional[str]:
    """The records root a head vouches for (None → unusable head)."""
    root = head if isinstance(head, str) else getattr(head, "records_root",
                                                      None)
    return root if isinstance(root, str) and root else None


# -- single-record unified proof -----------------------------------------------


@dataclass(frozen=True)
class SettlementProof:
    """One settlement record's typed, self-contained audit claim.

    ``chunk`` is the k records sharing the Merkle leaf, ``offset`` the
    record's position within it (``leaf`` resolves the record bytes);
    ``path`` is the full node path to the block's ``records_root`` and
    ``root`` the claimed root. ``record`` optionally carries the decoded
    human-readable view (part of the claim — it must re-decode from the
    leaf bytes). ``verify(head)`` is the single verification entry point
    for every block flavor."""

    block_index: int
    leaf_index: int
    chunk: Tuple[bytes, ...]
    offset: int
    path: Tuple[Tuple[str, str], ...]
    root: str
    task_id: Optional[str] = None
    record: Optional[Dict[str, Any]] = None

    @property
    def leaf(self) -> bytes:
        """The proven record's bytes."""
        return self.chunk[self.offset]

    def verify(self, head: Union[str, Block, BlockHeader]) -> bool:
        """Check the whole claim against a trusted ``head``: the decoded
        ``record`` view (when present) must match the leaf bytes, the
        chunk must hash to ``root`` through ``path`` (one hashing rule —
        ``MerkleTree.verify`` — for dense/sharded/delta/multi-task
        blocks), and ``root`` must equal the head's commitment (with the
        head's block index matching, when it carries one). Malformed
        proofs are rejected, never raised on."""
        try:
            if not (isinstance(self.offset, int)
                    and 0 <= self.offset < len(self.chunk)):
                return False
            if self.record is not None:
                from repro_torch.chain.contract import decode_settlement_record
                if decode_settlement_record(self.leaf) != self.record:
                    return False
            if not MerkleTree.verify(b"".join(self.chunk), self.path,
                                     self.root):
                return False
            root = _expected_root(head)
            if root is None or self.root != root:
                return False
            if isinstance(head, str):    # bare root: no index to check
                return True
            idx = getattr(head, "index", self.block_index)
            return idx == self.block_index
        except (TypeError, ValueError, IndexError, KeyError):
            return False

    # -- legacy dict round-trip ------------------------------------------------

    def as_legacy_dict(self) -> Dict[str, Any]:
        """The exact pre-redesign ``settlement_proof`` dict (bit-identical
        keys and values) — what the deprecated wrappers return."""
        return {"block_index": self.block_index,
                "leaf_index": self.leaf_index,
                "leaf": self.leaf,
                "chunk": list(self.chunk),
                "offset": self.offset,
                "proof": [tuple(p) for p in self.path],
                "root": self.root,
                "record": self.record}

    @classmethod
    def from_legacy(cls, proof: Dict[str, Any],
                    task_id: Optional[str] = None) -> "SettlementProof":
        """Adopt a legacy proof dict, preserving its defaulting rules
        (``chunk`` defaults to ``[leaf]``, ``offset`` to 0). Raises on
        shapes the legacy verifier rejected structurally (the caller
        converts to a ``False`` verdict)."""
        chunk = proof.get("chunk", [proof["leaf"]])
        offset = proof.get("offset", 0)
        if not (isinstance(offset, int) and 0 <= offset < len(chunk)):
            raise ValueError("offset out of range")
        if chunk[offset] != proof["leaf"]:
            raise ValueError("leaf does not sit at its claimed offset")
        return cls(block_index=proof["block_index"],
                   leaf_index=proof.get("leaf_index", -1),
                   chunk=tuple(chunk), offset=offset,
                   path=tuple(tuple(p) for p in proof["proof"]),
                   root=proof["root"], task_id=task_id,
                   record=proof.get("record"))


def build_settlement_proof(ledger: Ledger, block_index: int,
                           record_index: int,
                           task_id: Optional[str] = None,
                           decode=None) -> SettlementProof:
    """The canonical single-record proof builder every wrapper delegates
    to: chunk + offset + three-level path + committed root, straight off
    the block's stored commit. ``decode`` (optional ``leaf → dict``)
    attaches the decoded record view to the claim."""
    commit = ledger.commit(block_index)
    chunk, offset = commit.record_chunk(record_index, task_id)
    return SettlementProof(
        block_index=block_index, leaf_index=record_index,
        chunk=tuple(chunk), offset=offset,
        path=tuple(commit.record_proof(record_index, task_id)),
        root=ledger.blocks[block_index].records_root,
        task_id=commit._resolve(task_id),
        record=decode(chunk[offset]) if decode is not None else None)


# -- batched multiproofs -------------------------------------------------------


ROOT_KEY: Tuple = ("R",)

NodeKey = Tuple  # ("S", shard, lvl, pos) | ("U", lvl, pos) | ("T", lvl, pos)


@dataclass
class ProofBatch:
    """A deduplicated multiproof for ``records`` of one task in one block.

    ``records`` holds ``(record_index, leaf_key, offset)`` per requested
    record; ``chunks`` ships each referenced leaf chunk once (records in
    the same chunk share the entry); ``siblings`` ships each off-path
    digest once; ``plan`` is the level-ordered recomputation schedule (see
    module docstring). ``worker_ids``/``round_index`` are serving-side
    convenience labels — the cryptographic claim is the records' decoded
    contents against the recomputed root."""

    block_index: int
    task_id: Optional[str]
    root: str
    record_size: int
    records: List[Tuple[int, NodeKey, int]]
    chunks: Dict[NodeKey, bytes]
    siblings: Dict[NodeKey, str]
    plan: List[List[Tuple]]
    worker_ids: Optional[List[int]] = None
    round_index: Optional[int] = None

    def __len__(self) -> int:
        return len(self.records)

    @property
    def num_digests(self) -> int:
        """Digests shipped over the wire — the dedup win vs. the sum of
        independent path lengths."""
        return len(self.siblings)

    def record_bytes(self, i: int) -> bytes:
        """The i-th requested record's raw bytes, sliced out of its
        (verified) leaf chunk."""
        _, key, off = self.records[i]
        rs = self.record_size
        return bytes(self.chunks[key][off * rs:(off + 1) * rs])

    def decoded(self, i: int) -> Dict[str, Any]:
        """The i-th record's human-readable settlement view."""
        from repro_torch.chain.contract import decode_settlement_record
        return decode_settlement_record(self.record_bytes(i))


def _walk_levels(levels: Sequence[List[bytes]], active: Dict[int, NodeKey],
                 keyf, top_key: NodeKey,
                 siblings: Dict[NodeKey, str]) -> List[List[Tuple]]:
    """Plan the lift of ``active`` (position → node key at ``levels[0]``)
    to the stage's single ``top_key`` node, recording off-path sibling
    digests in ``siblings``. Mirrors ``_combine``'s pairing rule exactly
    (odd nodes promote unpaired), so the client's replay reproduces the
    committed digests bit for bit."""
    plan: List[List[Tuple]] = []
    cur = dict(active)
    if len(levels) == 1:
        # single-node stage (one leaf / one shard / one task): the stage's
        # only node IS its top — alias it so the next stage can consume it
        plan.append([("p", top_key, cur[0])])
        return plan
    for lvl in range(len(levels) - 1):
        level = levels[lvl]
        top = lvl == len(levels) - 2
        entries: List[Tuple] = []
        nxt: Dict[int, NodeKey] = {}
        for pos in sorted(cur):
            sib = pos ^ 1
            if sib in cur and sib < pos:
                continue                     # the left partner handles us
            parent = pos // 2
            pkey = top_key if top else keyf(lvl + 1, parent)
            if sib >= len(level):            # odd node promoted unpaired
                entries.append(("p", pkey, cur[pos]))
            else:
                if sib in cur:
                    skey = cur[sib]
                else:
                    skey = keyf(lvl, sib)
                    if skey not in siblings:
                        siblings[skey] = level[sib].hex()
                left, right = ((cur[pos], skey) if pos % 2 == 0
                               else (skey, cur[pos]))
                entries.append(("h", pkey, left, right))
            nxt[parent] = pkey
        plan.append(entries)
        cur = nxt
    return plan


def build_proof_batch(ledger: Ledger, block_index: int,
                      record_indices: Sequence[int],
                      task_id: Optional[str] = None,
                      worker_ids: Optional[Sequence[int]] = None,
                      round_index: Optional[int] = None) -> ProofBatch:
    """Build one task's deduplicated multiproof for ``record_indices`` in
    block ``block_index``, resolving through whichever commit flavor the
    block stored (dense/sharded single tree, incremental ``DeltaCommit``
    overlay, multi-task third level). Read-only over sealed state — safe
    to call from reader threads while the settler appends new blocks."""
    mtc = ledger.commit(block_index)
    blk = ledger.blocks[block_index]
    tid = mtc._resolve(task_id)
    commit = mtc.commits[tid]
    k = commit.chunk_size
    if isinstance(commit, DeltaCommit):
        trees = {0: commit.tree}
        sup: Sequence[List[bytes]] = [[commit.root_digest]]

        def locate(ri: int) -> Tuple[int, int]:
            if not 0 <= ri < commit.num_records:
                raise IndexError(f"record index {ri} out of range")
            return 0, ri
    else:
        trees = dict(enumerate(commit.trees))
        sup = commit.super_levels
        locate = commit._locate

    shards = getattr(commit, "shards", None)
    chunks: Dict[NodeKey, bytes] = {}
    records: List[Tuple[int, NodeKey, int]] = []
    by_shard: Dict[int, Dict[int, NodeKey]] = {}
    record_size = 0
    for ri in record_indices:
        ri = int(ri)
        s, local = locate(ri)
        leaf_pos = local // k
        key = ("S", s, 0, leaf_pos)
        if key not in chunks:
            shard = None if shards is None else shards[s]
            if isinstance(shard, RecordBatch):
                # fixed-width contiguous storage: the whole leaf chunk is
                # one zero-copy buffer slice (the batched-build fast path)
                stop = min(leaf_pos * k + k, len(shard))
                chunks[key] = bytes(shard.chunk_bytes(leaf_pos * k, stop))
                record_size = record_size or shard.itemsize
            else:
                chunk_list, off = commit.record_chunk(ri)
                chunks[key] = b"".join(chunk_list)
                record_size = record_size or len(chunk_list[off])
        records.append((ri, key, local % k))
        by_shard.setdefault(s, {})[leaf_pos] = key

    siblings: Dict[NodeKey, str] = {}
    # shard stages merge level-aligned: level l of every involved shard
    # lands in one plan level (they are independent, and the verifier
    # hashes each plan level in a single framed pass)
    plan: List[List[Tuple]] = []
    for s in sorted(by_shard):
        stage = _walk_levels(trees[s].levels, by_shard[s],
                             lambda lvl, pos, s=s: ("S", s, lvl, pos),
                             ("U", 0, s), siblings)
        for i, entries in enumerate(stage):
            if i == len(plan):
                plan.append([])
            plan[i].extend(entries)
    tpos = mtc.task_ids.index(tid)
    plan += _walk_levels(sup, {s: ("U", 0, s) for s in by_shard},
                         lambda lvl, pos: ("U", lvl, pos),
                         ("T", 0, tpos), siblings)
    plan += _walk_levels(mtc.task_levels, {tpos: ("T", 0, tpos)},
                         lambda lvl, pos: ("T", lvl, pos),
                         ROOT_KEY, siblings)
    return ProofBatch(block_index=block_index, task_id=tid,
                      root=blk.records_root, record_size=record_size,
                      records=records, chunks=chunks, siblings=siblings,
                      plan=plan,
                      worker_ids=None if worker_ids is None
                      else [int(w) for w in worker_ids],
                      round_index=round_index)


def verify_proof_batch(batch: ProofBatch,
                       head: Union[str, Block, BlockHeader]) -> bool:
    """Client-side batch verification against a trusted ``head``.

    Recomputes every leaf digest and every interior level with one framed
    sha256 pass per level, forbids node redefinition (shipped siblings
    may never override computed values and vice versa), requires the
    recomputed ``ROOT_KEY`` to equal the head's ``records_root``, and
    checks each claimed record slices validly out of its chunk *and* that
    its leaf is connected to the root through actual hash/promotion steps.
    Any tampered or malformed batch returns ``False`` — never raises."""
    try:
        root = _expected_root(head)
        if root is None or batch.root != root:
            return False
        if not isinstance(head, str) and \
                getattr(head, "index", batch.block_index) != batch.block_index:
            return False
        values: Dict[NodeKey, bytes] = {}
        # leaf digests: one framed pass per chunk-length class
        by_len: Dict[int, List[Tuple[NodeKey, bytes]]] = {}
        for key, chunk in batch.chunks.items():
            chunk = bytes(chunk)
            if not chunk:
                return False
            by_len.setdefault(len(chunk), []).append((key, chunk))
        for ln, items in by_len.items():
            framed = np.empty((len(items), 1 + ln), np.uint8)
            framed[:, 0] = _LEAF_PREFIX[0]
            for i, (_, chunk) in enumerate(items):
                framed[i, 1:] = np.frombuffer(chunk, np.uint8)
            for (key, _), d in zip(items, _framed_digests(framed)):
                if key in values:
                    return False
                values[key] = d
        for key, hx in batch.siblings.items():
            d = bytes.fromhex(hx)
            if len(d) != 32 or key in values:
                return False
            values[key] = d
        # interior levels: one framed 65-byte-row pass per plan level
        parent: Dict[NodeKey, NodeKey] = {}
        for entries in batch.plan:
            hsteps = [e for e in entries if e[0] == "h"]
            if hsteps:
                framed = np.empty((len(hsteps), 65), np.uint8)
                framed[:, 0] = _NODE_PREFIX[0]
                for i, (_, _, lk, rk) in enumerate(hsteps):
                    framed[i, 1:33] = np.frombuffer(values[lk], np.uint8)
                    framed[i, 33:65] = np.frombuffer(values[rk], np.uint8)
                for (_, pk, lk, rk), d in zip(hsteps,
                                              _framed_digests(framed)):
                    if pk in values:
                        return False
                    values[pk] = d
                    parent[lk] = pk
                    parent[rk] = pk
            for e in entries:
                if e[0] == "p":
                    _, pk, ck = e
                    if pk in values:
                        return False
                    values[pk] = values[ck]
                    parent[ck] = pk
                elif e[0] != "h":
                    return False
        if ROOT_KEY not in values or values[ROOT_KEY].hex() != root:
            return False
        # per-record claims: valid slice + leaf connected to the root
        rs = batch.record_size
        if not (isinstance(rs, int) and rs > 0):
            return False
        limit = len(parent) + 1
        for _, key, off in batch.records:
            chunk = batch.chunks[key]
            if not (isinstance(off, int) and 0 <= off
                    and (off + 1) * rs <= len(chunk)):
                return False
            cur, steps = key, 0
            while cur != ROOT_KEY:
                cur = parent[cur]        # KeyError: unconnected → reject
                steps += 1
                if steps > limit:
                    return False
        return True
    except (TypeError, ValueError, IndexError, KeyError):
        return False
