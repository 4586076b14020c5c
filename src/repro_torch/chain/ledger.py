"""Hash-chained ledger — the simulated permissioned blockchain.

Not a stub: blocks are really SHA-256 hash-chained over canonically-encoded
transaction payloads, and ``verify_chain`` actually detects tampering. What
is simulated away (consensus latency, gossip) is accounted for by
``work_units`` so the with/without-blockchain wall-time comparison (paper
Fig. 2) has a mechanism-faithful cost model.

Batched settlement (the array-native chain path): instead of embedding one
score/penalty transaction dict per worker — O(W) Python dicts hashed into
every round block — a block *commits* to the round's per-worker settlement
records through a Merkle root over their canonical encodings
(``Block.records_root``, part of the block hash). The records themselves
live in the ledger's off-chain availability layer (``record_batch`` per
block); any single worker's settlement stays auditable via an
O(log(W/k) + k) ``merkle_proof`` / ``verify_record`` without rehashing the
whole round. ``verify_chain(deep=True)`` additionally recomputes every
stored batch's root, so tampering with an individual record is detected
exactly like tampering with an embedded transaction used to be.

Chunked leaves: a commit may pack ``chunk_size`` consecutive records into
each Merkle leaf (leaf bytes = the records' concatenation), so a W-record
commit hashes ~2·W/k nodes instead of ~2·W — the per-leaf SHA-256 was the
last O(W) host cost on the settlement path. Auditing one record then needs
its chunk (k records, fixed-width so the offset is unambiguous) plus the
O(log(W/k)) node path; ``chunk_size=1`` reproduces the per-record tree
bit-for-bit. ``work_units`` counts the batched cost model: 1 + |txs| per
block plus the ~2·ceil(n/k)−1 Merkle hashes of an n-record commit.

Sharded commits: a block may commit S per-shard record batches at once
(``ShardedCommit``). Shard boundaries produced by ``plan_shard_bounds``
are *subtree-aligned* — every shard but the last covers exactly 2^m chunk
leaves — so the cross-shard super-root (shard subtree roots combined
pairwise bottom-up with the same interior-node rule) is bit-identical to
the flat tree over the concatenated records, for every shard count.
Sharding is therefore a node-local execution detail (subtrees build in
parallel on a settler pool) rather than a consensus-visible change: S=1,
S=4 and the unsharded commit all seal byte-identical blocks, and a
record's ``merkle_proof`` — its chunk path inside the shard followed by
the shard path to the super-root — is the same ``(side, digest)`` list
the flat tree emits, verified by the unchanged ``MerkleTree.verify``.
``verify_chain(deep=True)`` recurses through shards, rebuilding every
subtree and the super-root from the stored batches.

Multi-task commits (the multi-tenant chain layout): one chain node may
serve N concurrent federated tasks, and a block may commit several tasks'
rounds at once. ``MultiTaskCommit`` layers a third Merkle level over the
per-task commit roots — task roots combine pairwise in canonical (sorted
``task_id``) order with the same interior-node rule into the block root,
and multi-task blocks additionally carry the canonical
``task_id → super-root`` map (``Block.task_roots``, part of the block
hash). A settlement proof is then three-level — chunk path in shard,
shard path in task, task path in block — still one ``(side, digest)``
list consumed by the unchanged ``MerkleTree.verify``. With a single task
the task level is a lone root: the block root equals the task's
super-root, the task path is empty, and ``task_roots`` is omitted from
the hashed body, so single-task blocks are bit-identical to the
pre-multi-tenant layout. ``verify_chain(deep=True)`` recurses through
every task's shards and the task level, and corrupting one task's stored
records never invalidates another task's proofs (its sibling digests are
the stored task roots, not the corrupted bytes).

Two commit paths — dense and delta. Everything above describes the
*dense* path: a block commits a fresh tree over every record the round
produced, and its cost is O(W/k) hashes per round. ``DeltaCommit`` is the
*sparse* path for huge, mostly-idle populations (the million-worker
regime): the commit always covers the **full population's** latest
settlement records, but only the records that changed this round are
re-hashed. A base (anchor) commit snapshots the whole population once;
each subsequent delta commit references its predecessor, stores only the
changed rows, clones the predecessor's tree level lists (pointer copies,
O(W/k) references not hashes), re-digests the dirty chunk leaves, and
bubbles the O(C·log(W/k)) dirty interior paths up via
``MerkleTree.update_leaves`` — the resulting root is bit-identical to a
full rebuild over the same records (property-tested). Proof semantics are
unchanged and population-wide: an *idle* worker's record is committed by
every delta block, so its proof verifies (and tampering with it is
detected) without the worker having been active for rounds.
``verify_chain(deep=True)`` treats a delta block like any other: the
overlay chain is materialized back to its base and the root recomputed
from scratch. ``work_units`` charges a delta block its actual hashing
(dirty leaves + dirty interior nodes), so the cost model scales with
activity, not population.

Batched leaf hashing: leaf digests for contiguous record buffers are
computed by framing each chunk into one packed buffer (a ``\\x00``
domain-separation prefix byte before each chunk's records, laid out
contiguously) and issuing one ``hashlib.sha256`` call per leaf over the
framed row — byte-identical digests to the incremental two-``update``
path, but a single C call per leaf that releases the GIL once instead of
twice. This both speeds up serial hashing (~1.15x at small chunk sizes)
and lowers the chunk-size floor at which pooled shard fan-out wins (see
``MIN_PARALLEL_LEAF_BYTES`` in ``chain.contract``).
"""
from __future__ import annotations

import hashlib
import json
import time
from bisect import bisect_right
from dataclasses import dataclass
from typing import (Any, Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np


def canonical(obj: Any) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str).encode()


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


# -- Merkle commitment over per-worker settlement records ---------------------

_LEAF_PREFIX = b"\x00"   # domain separation: leaf vs interior node hashing
_NODE_PREFIX = b"\x01"   # (prevents second-preimage/extension confusions)


class RecordBatch(Sequence):
    """Fixed-width records backed by one contiguous buffer.

    The batch settlement path encodes a whole round as a single structured
    numpy buffer; wrapping it (instead of slicing W small ``bytes`` objects
    up front) keeps the commit zero-copy — chunk leaves are direct buffer
    slices and per-record access materializes only the record asked for.
    ``buf`` may be any bytes-like object (a ``memoryview`` straight onto
    the numpy array's memory avoids even the one up-front copy).
    """

    __slots__ = ("buf", "itemsize")

    def __init__(self, buf, itemsize: int) -> None:
        if itemsize <= 0 or len(buf) % itemsize:
            raise ValueError("buffer is not a whole number of records")
        self.buf = buf
        self.itemsize = itemsize

    def __len__(self) -> int:
        return len(self.buf) // self.itemsize

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if not -len(self) <= i < len(self):
            raise IndexError(i)
        i %= len(self)
        return self.buf[i * self.itemsize:(i + 1) * self.itemsize]

    def chunk_bytes(self, start: int, stop: int) -> bytes:
        return self.buf[start * self.itemsize:stop * self.itemsize]


Records = Union[RecordBatch, Sequence[bytes]]


def _chunk_bytes(records: Records, start: int, stop: int) -> bytes:
    if stop - start == 1:                     # per-record leaf (chunk_size=1)
        return records[start]
    if isinstance(records, RecordBatch):
        return records.chunk_bytes(start, stop)
    return b"".join(records[start:stop])


def _leaf_digest(chunk) -> bytes:
    """Domain-separated leaf hash. Two ``update`` calls instead of one
    ``_LEAF_PREFIX + chunk`` concatenation: the chunk may be a zero-copy
    ``memoryview`` onto the record buffer (bytes + memoryview would
    TypeError, and the concat would copy the leaf)."""
    h = hashlib.sha256(_LEAF_PREFIX)
    h.update(chunk)
    return h.digest()


def _framed_digests(framed: np.ndarray) -> List[bytes]:
    """One ``sha256`` call per framed row (prefix byte + chunk bytes laid
    out contiguously). A single C call per leaf releases the GIL once —
    the batched replacement for per-chunk ``_leaf_digest`` calls, with
    byte-identical output (same ``prefix || chunk`` preimage)."""
    rows, row_len = framed.shape
    flat = memoryview(framed).cast("B")
    sha = hashlib.sha256
    return [sha(flat[i * row_len:(i + 1) * row_len]).digest()
            for i in range(rows)]


def batch_leaf_digests(batch: RecordBatch, chunk_size: int) -> List[bytes]:
    """All leaf digests of a chunked tree over ``batch``, via one framed
    contiguous buffer and one hash call per leaf. The partial tail chunk
    (when ``len(batch)`` is not a multiple of ``chunk_size``) is hashed
    separately."""
    n, itemsize = len(batch), batch.itemsize
    leaf_bytes = chunk_size * itemsize
    full = n // chunk_size
    digests: List[bytes] = []
    if full:
        flat = np.frombuffer(batch.buf, dtype=np.uint8,
                             count=full * leaf_bytes)
        framed = np.empty((full, 1 + leaf_bytes), np.uint8)
        framed[:, 0] = _LEAF_PREFIX[0]
        framed[:, 1:] = flat.reshape(full, leaf_bytes)
        digests = _framed_digests(framed)
    if full * chunk_size < n:
        digests.append(_leaf_digest(batch.chunk_bytes(full * chunk_size, n)))
    return digests


def gathered_leaf_digests(batch: RecordBatch, chunk_size: int,
                          leaf_indices) -> Dict[int, bytes]:
    """Leaf digests for a *subset* of a chunked tree's leaves over
    ``batch`` — the dirty-chunk pass of a delta commit. The selected full
    chunks are gathered into one framed buffer (one vectorized copy) and
    hashed with one C call each; a selected partial tail chunk is hashed
    separately. Returns ``{leaf_index: digest}``."""
    n, itemsize = len(batch), batch.itemsize
    leaf_bytes = chunk_size * itemsize
    sel = np.asarray(leaf_indices, np.int64).reshape(-1)
    if len(sel) and (sel.min() < 0 or
                     sel.max() * chunk_size >= max(n, 1)):
        raise IndexError("leaf index out of range")
    out: Dict[int, bytes] = {}
    full_mask = (sel + 1) * chunk_size <= n
    fsel = sel[full_mask]
    if len(fsel):
        flat = np.frombuffer(batch.buf, dtype=np.uint8,
                             count=(n // chunk_size) * leaf_bytes)
        mat = flat.reshape(n // chunk_size, leaf_bytes)
        framed = np.empty((len(fsel), 1 + leaf_bytes), np.uint8)
        framed[:, 0] = _LEAF_PREFIX[0]
        framed[:, 1:] = mat[fsel]
        for li, d in zip(fsel.tolist(), _framed_digests(framed)):
            out[li] = d
    for li in sel[~full_mask].tolist():
        out[li] = _leaf_digest(batch.chunk_bytes(li * chunk_size, n))
    return out


def _combine(level: List[bytes]) -> Tuple[List[bytes], int]:
    """One level of pairwise interior hashing; the odd node is promoted
    unpaired. Returns (next level, interior hashes performed). Shared by
    the in-shard tree and the cross-shard super-root so there is exactly
    one hashing rule."""
    nxt = [hashlib.sha256(_NODE_PREFIX + level[i] + level[i + 1]).digest()
           for i in range(0, len(level) - 1, 2)]
    ops = len(nxt)
    if len(level) % 2:
        nxt.append(level[-1])
    return nxt, ops


def _path_through(levels: Sequence[List[bytes]],
                  index: int) -> List[Tuple[str, str]]:
    """Sibling path for ``index`` through pairwise-combined ``levels``
    (all levels below the root)."""
    path: List[Tuple[str, str]] = []
    for level in levels:
        sib = index ^ 1
        if sib < len(level):
            path.append(("L" if sib < index else "R", level[sib].hex()))
        index //= 2
    return path


class MerkleTree:
    """Binary Merkle tree over records, ``chunk_size`` records per leaf.

    A leaf's bytes are the concatenation of its chunk's records (with the
    default ``chunk_size=1`` this is exactly a per-record tree — same roots
    and proofs as always). Odd nodes are promoted unpaired (Bitcoin-style
    duplication would allow mutation by appending a copy of the last leaf;
    promotion does not). Proofs are lists of ``(side, sibling_digest_hex)``
    with side ``"L"`` if the sibling sits left of the running hash.
    """

    def __init__(self, records: Records, chunk_size: int = 1) -> None:
        if not len(records):
            raise ValueError("MerkleTree needs at least one record")
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        n = len(records)
        self.num_records = n
        self.chunk_size = chunk_size
        if isinstance(records, RecordBatch):
            # contiguous buffer: framed batched hashing, one C call per leaf
            level = batch_leaf_digests(records, chunk_size)
        else:
            level = [_leaf_digest(
                _chunk_bytes(records, i, min(i + chunk_size, n)))
                for i in range(0, n, chunk_size)]
        self.levels: List[List[bytes]] = [level]
        while len(level) > 1:
            level, _ = _combine(level)
            self.levels.append(level)
        # cost model: one hash per leaf + one per interior node
        self.hash_ops = sum(len(lv) for lv in self.levels[:-1]) + 1 \
            if len(self.levels) > 1 else 1

    @property
    def num_leaves(self) -> int:
        return len(self.levels[0])

    @property
    def root(self) -> str:
        return self.levels[-1][0].hex()

    def proof(self, index: int) -> List[Tuple[str, str]]:
        """Node path for leaf (= chunk) ``index``."""
        if not 0 <= index < self.num_leaves:
            raise IndexError(f"leaf index {index} out of range")
        return _path_through(self.levels[:-1], index)

    def record_proof(self, record_index: int) -> List[Tuple[str, str]]:
        """Node path for the chunk containing record ``record_index``."""
        if not 0 <= record_index < self.num_records:
            raise IndexError(f"record index {record_index} out of range")
        return self.proof(record_index // self.chunk_size)

    def clone(self) -> "MerkleTree":
        """Copy-on-write clone for incremental updates: the per-level digest
        lists are fresh (so ``update_leaves`` never mutates the original)
        but the digests themselves are shared — O(L) pointer copies, zero
        hashing."""
        t = object.__new__(MerkleTree)
        t.num_records = self.num_records
        t.chunk_size = self.chunk_size
        t.levels = [list(lv) for lv in self.levels]
        t.hash_ops = self.hash_ops
        return t

    def update_leaf_digests(self, digests: Mapping[int, bytes]) -> int:
        """Incremental in-place update from precomputed leaf digests:
        replace the given leaves and recompute only the dirty interior
        paths — O(|dirty|·log L) hashes instead of a full rebuild, with a
        root bit-identical to rebuilding from the updated records
        (property-tested). Returns the interior hashes performed."""
        leaves = self.levels[0]
        for i, d in digests.items():
            if not 0 <= i < len(leaves):
                raise IndexError(f"leaf index {i} out of range")
            leaves[i] = d
        dirty = {i // 2 for i in digests}
        ops = 0
        for li in range(1, len(self.levels)):
            below, cur = self.levels[li - 1], self.levels[li]
            for p in dirty:
                lo = 2 * p
                if lo + 1 < len(below):
                    cur[p] = hashlib.sha256(
                        _NODE_PREFIX + below[lo] + below[lo + 1]).digest()
                    ops += 1
                else:                         # odd node promoted unpaired
                    cur[p] = below[lo]
            dirty = {p // 2 for p in dirty}
        self.hash_ops += len(digests) + ops
        return ops

    def update_leaves(self, leaves: Mapping[int, bytes]) -> int:
        """Incremental update from whole leaf byte-strings (for a chunked
        tree, each value is the updated chunk's concatenated records). See
        ``update_leaf_digests``."""
        return self.update_leaf_digests(
            {i: _leaf_digest(b) for i, b in leaves.items()})

    @staticmethod
    def verify(leaf: bytes, proof: Sequence[Tuple[str, str]],
               root: str) -> bool:
        """``leaf`` is the full leaf byte-string (any bytes-like object) —
        for a chunked tree, the concatenation of the chunk's records.

        This is the low-level hashing primitive behind the unified
        ``repro_torch.chain.proofs.SettlementProof.verify`` — application code
        should verify whole ``SettlementProof`` claims, not bare paths."""
        h = _leaf_digest(leaf)
        for side, sib_hex in proof:
            sib = bytes.fromhex(sib_hex)
            pair = sib + h if side == "L" else h + sib
            h = hashlib.sha256(_NODE_PREFIX + pair).digest()
        return h.hex() == root


# -- sharded (two-level) commits ----------------------------------------------


def plan_shard_bounds(num_records: int, chunk_size: int,
                      shards: int) -> List[int]:
    """Record-index boundaries splitting ``num_records`` into at most
    ``shards`` contiguous ranges whose edges land on whole subtrees: every
    shard but the last covers exactly 2^m chunk leaves (the last takes the
    remainder), with m the smallest exponent giving ≤ ``shards`` ranges.
    This alignment is what makes the per-shard subtree roots combine to
    exactly the flat tree's root (see ``ShardedCommit``)."""
    if num_records < 0 or chunk_size < 1 or shards < 1:
        raise ValueError("need num_records >= 0, chunk_size/shards >= 1")
    if num_records == 0:
        return [0]
    leaves = -(-num_records // chunk_size)
    shards = min(shards, leaves)
    m = 0
    while (1 << m) * shards < leaves:      # smallest m: ceil(L/2^m) <= shards
        m += 1
    step = (1 << m) * chunk_size
    return list(range(0, num_records, step)) + [num_records]


class ShardedCommit(Sequence):
    """Two-level Merkle commitment over per-shard record batches.

    Level one: each shard's records get their own chunked subtree (built
    independently — in parallel on a settler pool when one is supplied).
    Level two: the shard subtree roots combine pairwise bottom-up with the
    same interior-node rule into the cross-shard *super-root*, which is
    what the block commits to. With subtree-aligned shard boundaries
    (``plan_shard_bounds``) the super-root and every record's proof are
    bit-identical to the flat single-tree commit, so shard count never
    changes block hashes — only who hashes which records.

    Indexing is over the concatenated record sequence, so the ledger's
    per-record audit surface is shard-agnostic.
    """

    __slots__ = ("shards", "trees", "chunk_size", "bounds", "super_levels",
                 "hash_ops")

    def __init__(self, shards: Sequence[Records], chunk_size: int = 1,
                 trees: Optional[Sequence[MerkleTree]] = None) -> None:
        if not shards or any(not len(s) for s in shards):
            raise ValueError("ShardedCommit needs non-empty shards")
        self.shards: List[Records] = list(shards)
        self.chunk_size = chunk_size
        if trees is None:
            trees = [MerkleTree(s, chunk_size) for s in self.shards]
        self.trees: List[MerkleTree] = list(trees)
        if len(self.trees) != len(self.shards):
            raise ValueError("one precomputed tree per shard required")
        bounds = [0]
        for s in self.shards:
            bounds.append(bounds[-1] + len(s))
        self.bounds = bounds
        level = [t.levels[-1][0] for t in self.trees]   # shard root digests
        self.super_levels: List[List[bytes]] = [level]
        super_ops = 0
        while len(level) > 1:
            level, ops = _combine(level)
            super_ops += ops
            self.super_levels.append(level)
        self.hash_ops = sum(t.hash_ops for t in self.trees) + super_ops

    # -- concatenated-record view --------------------------------------------

    def __len__(self) -> int:
        return self.bounds[-1]

    def _locate(self, record_index: int) -> Tuple[int, int]:
        if not 0 <= record_index < len(self):
            raise IndexError(f"record index {record_index} out of range")
        s = bisect_right(self.bounds, record_index) - 1
        return s, record_index - self.bounds[s]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        s, local = self._locate(i)
        return self.shards[s][local]

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def root(self) -> str:
        return self.super_levels[-1][0].hex()

    @property
    def root_digest(self) -> bytes:
        """Raw super-root digest — the task-level leaf of a multi-task
        commit (shared accessor across commit kinds)."""
        return self.super_levels[-1][0]

    def shard_roots(self) -> List[str]:
        return [t.root for t in self.trees]

    # -- two-level proofs -----------------------------------------------------

    def shard_path(self, shard_index: int) -> List[Tuple[str, str]]:
        """Sibling path from shard ``shard_index``'s subtree root to the
        super-root — the cross-shard half of a settlement proof."""
        if not 0 <= shard_index < self.num_shards:
            raise IndexError(f"shard index {shard_index} out of range")
        return _path_through(self.super_levels[:-1], shard_index)

    def record_proof(self, record_index: int) -> List[Tuple[str, str]]:
        """Chunk path inside the record's shard + the shard path to the
        super-root. ``MerkleTree.verify`` consumes it unchanged (both
        halves are the same ``(side, digest)`` encoding), and with aligned
        shards the concatenation is byte-equal to the flat tree's proof."""
        s, local = self._locate(record_index)
        return self.trees[s].record_proof(local) + self.shard_path(s)

    def record_chunk(self, record_index: int) -> Tuple[List[bytes], int]:
        """The record's leaf chunk (within its shard) and its offset."""
        s, local = self._locate(record_index)
        k = self.chunk_size
        start = (local // k) * k
        stop = min(start + k, len(self.shards[s]))
        return [bytes(self.shards[s][i]) for i in range(start, stop)], \
            local - start

    def tamper(self, record_index: int, leaf: bytes) -> None:
        """Test hook: corrupt one stored record in place."""
        s, local = self._locate(record_index)
        if isinstance(self.shards[s], RecordBatch):
            self.shards[s] = list(self.shards[s])
        self.shards[s][local] = leaf

    def rebuild(self) -> "ShardedCommit":
        """Fresh commit rebuilt from the stored batches."""
        return ShardedCommit(self.shards, self.chunk_size)

    def recompute_root(self) -> str:
        """Root rebuilt from the stored batches (deep verification —
        recurses through every shard subtree and the super levels)."""
        return self.rebuild().root


# -- delta (incremental) commits ----------------------------------------------


class DeltaCommit(Sequence):
    """Incremental full-population Merkle commitment.

    A *base* commit (``DeltaCommit.full``) snapshots and hashes the whole
    population's latest settlement records — one dense anchor. Each
    subsequent *delta* commit (``DeltaCommit.delta``) references its
    predecessor, stores only the rows that changed this round (sorted by
    record index), clones the predecessor's tree (pointer copies), and
    re-hashes only the dirty chunk leaves plus their O(C·log(W/k))
    interior paths via ``MerkleTree.update_leaf_digests`` — producing a
    root bit-identical to a dense rebuild over the same records.

    Indexing is population-wide: ``commit[i]`` resolves record ``i``
    through the overlay chain (this commit's changed rows, else the
    predecessor's, down to the base), so proofs and audits cover *idle*
    workers too — every block commits every worker's latest record, and
    ``record_proof``/``record_chunk``/``MerkleTree.verify`` behave exactly
    as on a single-shard dense commit (the tree is flat, so the proof is
    the flat tree's ``(side, digest)`` path).

    ``hash_ops`` counts only the hashing this commit actually performed
    (all leaves + interiors for a base; dirty leaves + dirty interiors for
    a delta), which is what ``Ledger.work_units`` charges — commit cost
    scales with activity, not population. ``recompute_root`` (deep
    verification) materializes the overlay back to the base and rebuilds
    from scratch, so tampering with any stored row — changed or inherited
    — is detected."""

    __slots__ = ("prev", "base_records", "changed", "new_records",
                 "chunk_size", "num_records", "tree", "hash_ops",
                 "_tampered", "depth")

    def __init__(self, *_a, **_k) -> None:
        raise TypeError(
            "use DeltaCommit.full(records, chunk_size) or "
            "DeltaCommit.delta(prev, changed, new_records)")

    @classmethod
    def full(cls, records: Records, chunk_size: int = 1) -> "DeltaCommit":
        """Dense base (anchor) commit over the full population."""
        c = object.__new__(cls)
        c.prev = None
        c.base_records = records
        c.changed = None
        c.new_records = None
        c.chunk_size = chunk_size
        c.num_records = len(records)
        c.tree = MerkleTree(records, chunk_size)
        c.hash_ops = c.tree.hash_ops
        c._tampered = {}
        c.depth = 0
        return c

    @classmethod
    def delta(cls, prev: "DeltaCommit", changed, new_records: Records,
              leaf_digests: Optional[Mapping[int, bytes]] = None
              ) -> "DeltaCommit":
        """Incremental commit: ``changed`` (strictly increasing record
        indices) and ``new_records`` (aligned updated rows) overlay
        ``prev``. ``leaf_digests`` optionally supplies the dirty chunks'
        precomputed digests (the batched fast path — the caller holds the
        up-to-date population buffer); otherwise dirty chunks are
        materialized through the overlay and hashed here."""
        changed = np.asarray(changed, np.int64).reshape(-1)
        if len(changed) != len(new_records):
            raise ValueError("changed/new_records length mismatch")
        if len(changed):
            if len(changed) > 1 and (np.diff(changed) <= 0).any():
                raise ValueError(
                    "changed indices must be strictly increasing")
            if changed[0] < 0 or changed[-1] >= prev.num_records:
                raise IndexError("changed record index out of range")
        c = object.__new__(cls)
        c.prev = prev
        c.base_records = None
        c.changed = changed
        c.new_records = new_records
        c.chunk_size = prev.chunk_size
        c.num_records = prev.num_records
        c._tampered = {}
        c.depth = prev.depth + 1
        c.tree = prev.tree.clone()
        if leaf_digests is None:
            k = c.chunk_size
            leaf_digests = {
                int(li): _leaf_digest(b"".join(c.record_chunk(int(li) * k)[0]))
                for li in np.unique(changed // k).tolist()}
        ops = c.tree.update_leaf_digests(leaf_digests)
        c.hash_ops = len(leaf_digests) + ops
        return c

    # -- population-wide record view -----------------------------------------

    def __len__(self) -> int:
        return self.num_records

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if not -len(self) <= i < len(self):
            raise IndexError(i)
        i %= len(self)
        c = self
        while c is not None:
            if i in c._tampered:
                return c._tampered[i]
            if c.changed is not None and len(c.changed):
                pos = int(np.searchsorted(c.changed, i))
                if pos < len(c.changed) and c.changed[pos] == i:
                    return c.new_records[pos]
            if c.prev is None:
                return c.base_records[i]
            c = c.prev
        raise IndexError(i)                   # unreachable

    @property
    def num_shards(self) -> int:
        return 1

    @property
    def root(self) -> str:
        return self.tree.root

    @property
    def root_digest(self) -> bytes:
        return self.tree.levels[-1][0]

    def shard_roots(self) -> List[str]:
        return [self.root]

    # -- proofs / audit (flat-tree semantics) --------------------------------

    def record_proof(self, record_index: int) -> List[Tuple[str, str]]:
        """Flat-tree node path for the chunk committing ``record_index`` —
        the same ``(side, digest)`` list a dense single-shard commit
        emits, valid for idle and active records alike."""
        return self.tree.record_proof(record_index)

    def record_chunk(self, record_index: int) -> Tuple[List[bytes], int]:
        """The record's leaf chunk, materialized through the overlay
        chain, and its offset within the chunk."""
        if not 0 <= record_index < self.num_records:
            raise IndexError(f"record index {record_index} out of range")
        k = self.chunk_size
        start = (record_index // k) * k
        stop = min(start + k, self.num_records)
        return [bytes(self[i]) for i in range(start, stop)], \
            record_index - start

    def tamper(self, record_index: int, leaf: bytes) -> None:
        """Test hook: corrupt one record of *this block's* stored view in
        place (works for inherited — idle-worker — records too)."""
        if not 0 <= record_index < self.num_records:
            raise IndexError(f"record index {record_index} out of range")
        self._tampered[record_index] = leaf

    def materialize(self) -> Records:
        """The full population's records with the overlay collapsed. One
        vectorized replay (base buffer copy + per-delta row scatter) when
        every layer is an untampered ``RecordBatch``; a per-record
        materialization otherwise (tampered rows may have any length)."""
        chain = [self]
        c = self
        while c.prev is not None:
            c = c.prev
            chain.append(c)
        base = chain[-1]
        fast = (isinstance(base.base_records, RecordBatch)
                and all(not layer._tampered for layer in chain)
                and all(isinstance(layer.new_records, RecordBatch)
                        for layer in chain[:-1]))
        if fast:
            itemsize = base.base_records.itemsize
            buf = np.frombuffer(base.base_records.buf, np.uint8).reshape(
                self.num_records, itemsize).copy()
            for layer in reversed(chain[:-1]):      # oldest delta first
                rows = np.frombuffer(layer.new_records.buf, np.uint8)
                buf[layer.changed] = rows.reshape(
                    len(layer.new_records), itemsize)
            return RecordBatch(memoryview(buf).cast("B"), itemsize)
        return [bytes(self[i]) for i in range(self.num_records)]

    def rebuild(self) -> "DeltaCommit":
        """Fresh dense commit over the materialized population."""
        return DeltaCommit.full(self.materialize(), self.chunk_size)

    def recompute_root(self) -> str:
        """Root rebuilt from scratch over the materialized population
        (deep verification — detects tampering with changed *and*
        inherited rows)."""
        return MerkleTree(self.materialize(), self.chunk_size).root


AnyCommit = Union[ShardedCommit, DeltaCommit]


# -- multi-task (three-level) commits -----------------------------------------


class MultiTaskCommit:
    """Third Merkle level over per-task commit roots.

    ``commits`` maps ``task_id`` (an arbitrary string; ``None`` names the
    anonymous single-task legacy path) to that task's commit — a dense
    ``ShardedCommit`` or an incremental ``DeltaCommit`` (tenants may mix
    freely; the task level only consumes each commit's ``root_digest``).
    Task roots combine pairwise bottom-up in canonical (sorted task id)
    order with the interior-node rule into the block root. A record proof
    is the task's own proof followed by the task path — with a single
    task the root equals the task's super-root and the task path is empty,
    so single-task commits are bit-identical to a bare commit. Each
    task's chunk size may differ (heterogeneous tenants)."""

    __slots__ = ("task_ids", "commits", "task_levels", "hash_ops")

    def __init__(self, commits: Dict[Optional[str], AnyCommit]) -> None:
        if not commits:
            raise ValueError("MultiTaskCommit needs at least one task commit")
        if len(commits) > 1 and any(t is None for t in commits):
            raise ValueError("anonymous task commit only allowed alone")
        self.task_ids: List[Optional[str]] = (
            sorted(commits) if len(commits) > 1 else list(commits))
        self.commits: Dict[Optional[str], AnyCommit] = {
            t: commits[t] for t in self.task_ids}
        level = [c.root_digest for c in self.commits.values()]
        self.task_levels: List[List[bytes]] = [level]
        task_ops = 0
        while len(level) > 1:
            level, ops = _combine(level)
            task_ops += ops
            self.task_levels.append(level)
        self.hash_ops = sum(c.hash_ops for c in self.commits.values()) \
            + task_ops

    @property
    def num_tasks(self) -> int:
        return len(self.task_ids)

    @property
    def root(self) -> str:
        return self.task_levels[-1][0].hex()

    def task_roots(self) -> Dict[Optional[str], str]:
        """The canonical ``task_id → super-root`` map this commit binds."""
        return {t: c.root for t, c in self.commits.items()}

    def _resolve(self, task_id: Optional[str]) -> Optional[str]:
        if task_id is None:
            if self.num_tasks == 1:
                return self.task_ids[0]
            raise KeyError(
                "block commits multiple tasks; a task_id is required")
        if task_id not in self.commits:
            raise KeyError(f"no commit for task {task_id!r}")
        return task_id

    def commit_for(self, task_id: Optional[str] = None) -> AnyCommit:
        """One task's commit (``task_id`` optional when the block commits
        a single task — the legacy single-tenant accessors)."""
        return self.commits[self._resolve(task_id)]

    def task_path(self, task_id: Optional[str] = None
                  ) -> List[Tuple[str, str]]:
        """Sibling path from a task's super-root to the block root — the
        cross-task (third) level of a settlement proof."""
        tid = self._resolve(task_id)
        return _path_through(self.task_levels[:-1], self.task_ids.index(tid))

    def record_proof(self, record_index: int,
                     task_id: Optional[str] = None) -> List[Tuple[str, str]]:
        """Three-level node path: chunk path inside the record's shard, the
        shard path to the task's super-root, then the task path to the
        block root. ``MerkleTree.verify`` consumes it unchanged."""
        tid = self._resolve(task_id)
        return self.commits[tid].record_proof(record_index) \
            + self.task_path(tid)

    def record_chunk(self, record_index: int,
                     task_id: Optional[str] = None
                     ) -> Tuple[List[bytes], int]:
        return self.commit_for(task_id).record_chunk(record_index)

    def tamper(self, record_index: int, leaf: bytes,
               task_id: Optional[str] = None) -> None:
        """Test hook: corrupt one task's stored record in place."""
        self.commit_for(task_id).tamper(record_index, leaf)

    def recompute_root(self) -> str:
        """Block root rebuilt from every task's stored records (deep
        verification — rebuilds each task's commit from scratch, its
        super levels, and the cross-task task level; delta commits
        materialize their overlay chain back to the base first)."""
        rebuilt = {t: c.rebuild() for t, c in self.commits.items()}
        return MultiTaskCommit(rebuilt).root


@dataclass
class Block:
    index: int
    prev_hash: str
    transactions: List[dict]
    timestamp: float
    records_root: str = ""    # Merkle root of the batch commit ("" if none)
    # canonical task_id → super-root map of a multi-task block; None when
    # the block commits at most one task (single-task hashes stay stable)
    task_roots: Optional[Dict[str, str]] = None
    hash: str = ""

    def compute_hash(self) -> str:
        body = {"index": self.index, "prev": self.prev_hash,
                "txs": self.transactions, "ts": self.timestamp}
        if self.records_root:       # keep genesis/legacy block hashes stable
            body["records_root"] = self.records_root
        if self.task_roots:         # multi-task layout only — a single-task
            body["task_roots"] = self.task_roots   # block hashes as before
        return sha256(canonical(body))


class Ledger:
    """Append-only block chain with one block per FL round (plus genesis)."""

    GENESIS_HASH = "0" * 64

    def __init__(self) -> None:
        genesis = Block(0, self.GENESIS_HASH, [{"type": "genesis"}], 0.0)
        genesis.hash = genesis.compute_hash()
        self.blocks: List[Block] = [genesis]
        self.work_units: int = 0          # hashing/verification operations done
        # off-chain data availability: per-block multi-task commit (per-task
        # batches + shard subtrees + super levels + the task level);
        # single-task single-shard commits additionally mirror their tree
        # into _record_trees (the pre-sharding introspection API)
        self._commits: Dict[int, MultiTaskCommit] = {}
        self._record_trees: Dict[int, MerkleTree] = {}

    @property
    def head(self) -> Block:
        return self.blocks[-1]

    @staticmethod
    def _build_commit(record_batch: Optional[Records],
                      record_shards: Optional[Sequence[Records]],
                      shard_trees: Optional[Sequence[MerkleTree]],
                      chunk_size: int) -> Optional[ShardedCommit]:
        """One task's sharded commit from either a flat batch or per-shard
        batches (with optional prebuilt trees); None when empty."""
        if record_shards is not None:
            if shard_trees is not None and \
                    len(shard_trees) != len(record_shards):
                raise ValueError("one precomputed tree per shard required")
            # drop empty shards and their trees in lockstep so the
            # shard↔tree pairing survives the filter
            keep = [i for i, s in enumerate(record_shards) if len(s)]
            if keep:
                return ShardedCommit(
                    [record_shards[i] for i in keep], chunk_size,
                    trees=None if shard_trees is None
                    else [shard_trees[i] for i in keep])
        elif record_batch is not None and len(record_batch):
            return ShardedCommit([record_batch], chunk_size)
        return None

    def _seal(self, transactions: List[dict], timestamp: Optional[float],
              commit: Optional[MultiTaskCommit]) -> Block:
        blk = Block(len(self.blocks), self.head.hash, list(transactions),
                    time.monotonic() if timestamp is None else timestamp,
                    records_root=commit.root if commit is not None else "",
                    task_roots={t: r for t, r in commit.task_roots().items()}
                    if commit is not None and commit.num_tasks > 1 else None)
        blk.hash = blk.compute_hash()
        # verification pass every append (each node re-hashes the new block);
        # batched commits add their ~2·ceil(n/k)−1 Merkle hashes per task
        self.work_units += 1 + len(transactions)
        if commit is not None:
            self.work_units += commit.hash_ops
            # Publication order is the read path's lock-free contract: the
            # block's commit is registered in `_commits` BEFORE the block
            # becomes visible in `blocks` (list append is atomic under the
            # GIL), and sealed commits are immutable — so a concurrent
            # reader (`repro_torch.serve.ChainReadServer`) that can see block i
            # can always resolve block i's proofs without taking any lock,
            # and never makes the settler thread wait.
            self._commits[blk.index] = commit
            if commit.num_tasks == 1:
                only = commit.commit_for()
                if isinstance(only, ShardedCommit) and only.num_shards == 1:
                    self._record_trees[blk.index] = only.trees[0]
        self.blocks.append(blk)
        return blk

    def append_block(self, transactions: List[dict],
                     timestamp: Optional[float] = None,
                     record_batch: Optional[Records] = None,
                     chunk_size: int = 1,
                     record_shards: Optional[Sequence[Records]] = None,
                     shard_trees: Optional[Sequence[MerkleTree]] = None,
                     record_delta: Optional[DeltaCommit] = None,
                     task_id: Optional[str] = None) -> Block:
        """Seal a single-task block. Canonically-encoded per-worker
        settlement records are Merkle-committed into the block hash via
        ``records_root`` with ``chunk_size`` records per leaf; the records
        themselves stay off-chain but per-record auditable
        (``merkle_proof`` / ``record_chunk``). Pass either ``record_batch``
        (one flat batch), ``record_shards`` (per-shard batches, optionally
        with their ``shard_trees`` prebuilt in parallel by a settler pool —
        with subtree-aligned shards both commit the identical root), or
        ``record_delta`` (a prebuilt incremental ``DeltaCommit`` — the
        sparse path; the block commits the full population's root while
        only the dirty paths were hashed). ``task_id`` names the
        committing task on a multi-tenant node; block hashes are task-id
        independent for single-task blocks."""
        commit: Optional[AnyCommit] = record_delta
        if commit is None:
            commit = self._build_commit(record_batch, record_shards,
                                        shard_trees, chunk_size)
        return self._seal(transactions, timestamp,
                          MultiTaskCommit({task_id: commit})
                          if commit is not None else None)

    def append_multi_block(self, transactions: List[dict],
                           timestamp: Optional[float],
                           task_commits: Dict[str, AnyCommit]) -> Block:
        """Seal a multi-task block committing several tasks' rounds at
        once: the canonical ``task_id → super-root`` map enters the block
        hash (``task_roots``) and the ``records_root`` is the cross-task
        combined root. With exactly one task this is bit-identical to
        ``append_block`` — co-tenancy, like shard count, only becomes
        consensus-visible when a block genuinely carries several tasks."""
        commits = {t: c for t, c in task_commits.items() if c is not None}
        return self._seal(transactions, timestamp,
                          MultiTaskCommit(commits) if commits else None)

    def verify_chain(self, deep: bool = False) -> bool:
        """Hash-chain integrity; ``deep=True`` additionally recurses through
        every stored commit — rebuilding each task's shard subtrees, its
        cross-shard super-root, and the cross-task task level — against the
        block commitment (including the ``task_roots`` map)."""
        prev = self.GENESIS_HASH
        for blk in self.blocks:
            if blk.prev_hash != prev or blk.hash != blk.compute_hash():
                return False
            if deep and blk.index in self._commits:
                commit = self._commits[blk.index]
                if commit.recompute_root() != blk.records_root:
                    return False
                if blk.task_roots is not None and \
                        blk.task_roots != commit.task_roots():
                    return False
            prev = blk.hash
        return True

    # -- fork tracking (repro_torch.net) --------------------------------------------

    def rollback_to(self, block_index: int) -> List[Block]:
        """Fork-choice rollback: drop every block *above* ``block_index``
        (which stays the new head) together with its registered commits.
        Returns the removed blocks oldest-first, so a caller that tracked
        them in a fork tree can re-adopt a competing branch. Contract
        state is *not* touched here — the network node restores its own
        snapshot for the surviving height and replays the winning branch
        through ``adopt_block`` (see ``repro_torch.net.fork_choice``)."""
        if not 0 <= block_index < len(self.blocks):
            raise ValueError(
                f"rollback_to({block_index}) outside chain of height "
                f"{len(self.blocks)}")
        removed = self.blocks[block_index + 1:]
        for blk in removed:
            self._commits.pop(blk.index, None)
            self._record_trees.pop(blk.index, None)
        del self.blocks[block_index + 1:]
        self.work_units += len(removed)
        return removed

    def adopt_block(self, block: Block,
                    commit: Optional[MultiTaskCommit] = None,
                    verify_commit: bool = True) -> Block:
        """Append an *externally sealed* block (gossiped by a peer node)
        after LightClient-style verification on receipt: index
        continuity, ``prev_hash`` linkage, full hash recomputation, and —
        when the block commits records — that the shipped commit really
        re-hashes to the block's ``records_root``/``task_roots`` (the
        tampered-super-root check; ``verify_commit=False`` downgrades it
        to a root-equality check for commits already verified upstream).
        Raises ``ValueError`` on any mismatch with nothing applied."""
        if block.index != len(self.blocks):
            raise ValueError(
                f"adopted block index {block.index} != chain height "
                f"{len(self.blocks)}")
        if block.prev_hash != self.head.hash:
            raise ValueError(
                f"adopted block {block.index} does not link to head "
                f"{self.head.hash[:12]}…")
        if block.compute_hash() != block.hash:
            raise ValueError(
                f"adopted block {block.index} hash does not recompute")
        self.work_units += 1 + len(block.transactions)
        if commit is None:
            if block.records_root:
                raise ValueError(
                    f"adopted block {block.index} commits records but no "
                    f"commit was supplied")
        else:
            root = commit.recompute_root() if verify_commit else commit.root
            if root != block.records_root:
                raise ValueError(
                    f"adopted block {block.index} commit root mismatch "
                    f"(tampered super-root?)")
            if block.task_roots is not None \
                    and block.task_roots != commit.task_roots():
                raise ValueError(
                    f"adopted block {block.index} task_roots mismatch")
            self.work_units += commit.hash_ops
            # same publication order as _seal: commit registered before
            # the block becomes visible (lock-free read-path contract)
            self._commits[block.index] = commit
            if commit.num_tasks == 1:
                only = commit.commit_for()
                if isinstance(only, ShardedCommit) and only.num_shards == 1:
                    self._record_trees[block.index] = only.trees[0]
        self.blocks.append(block)
        return block

    # -- per-record audit -----------------------------------------------------

    def commit(self, block_index: int) -> MultiTaskCommit:
        """The block's stored multi-task commit — the proof server's entry
        into off-chain data availability (read-only; sealed commits are
        immutable, so reader threads may hold one while the settler
        appends)."""
        return self._commits[block_index]

    def settlement_proof(self, block_index: int, record_index: int,
                         task_id: Optional[str] = None):
        """Typed unified proof (``repro_torch.chain.proofs.SettlementProof``)
        for one committed record — the modern replacement for the
        ``merkle_proof`` / ``record_chunk`` / ``verify_record`` triple;
        verify with ``proof.verify(head)`` against any trusted head."""
        from repro_torch.chain.proofs import build_settlement_proof
        return build_settlement_proof(self, block_index, record_index,
                                      task_id)

    def task_ids(self, block_index: int) -> List[Optional[str]]:
        """Tasks committed in a block, canonical order."""
        return list(self._commits[block_index].task_ids)

    def task_roots(self, block_index: int) -> Dict[Optional[str], str]:
        """The block's canonical ``task_id → super-root`` map."""
        return self._commits[block_index].task_roots()

    def record_batch(self, block_index: int,
                     task_id: Optional[str] = None) -> Records:
        """One task's committed records as one concatenated sequence
        (shard-agnostic view; single-shard commits return the batch; delta
        commits return the population-wide overlay view)."""
        commit = self._commits[block_index].commit_for(task_id)
        if isinstance(commit, DeltaCommit):
            return commit
        return commit.shards[0] if commit.num_shards == 1 else commit

    def record_chunk_size(self, block_index: int,
                          task_id: Optional[str] = None) -> int:
        return self._commits[block_index].commit_for(task_id).chunk_size

    def num_shards(self, block_index: int,
                   task_id: Optional[str] = None) -> int:
        return self._commits[block_index].commit_for(task_id).num_shards

    def shard_roots(self, block_index: int,
                    task_id: Optional[str] = None) -> List[str]:
        """Per-shard subtree roots under a task's super-root."""
        return self._commits[block_index].commit_for(task_id).shard_roots()

    def merkle_proof(self, block_index: int, record_index: int,
                     task_id: Optional[str] = None) -> List[Tuple[str, str]]:
        """O(log(n/k)) three-level node path — the chunk path inside the
        record's shard, the shard path to its task's super-root, and the
        task path to the block root (empty for single-task blocks) — for
        one settlement record of a batched block; auditing worker w never
        rehashes the round.

        Deprecated thin wrapper: the bare path is one field of the typed
        ``settlement_proof`` (property-tested identical to
        ``SettlementProof.path``); new code should carry the whole
        ``SettlementProof``."""
        return self._commits[block_index].record_proof(record_index, task_id)

    def record_chunk(self, block_index: int, record_index: int,
                     task_id: Optional[str] = None
                     ) -> Tuple[List[bytes], int]:
        """The chunk of records whose leaf commits ``record_index``, plus
        the record's offset within it — what an auditor ships alongside the
        node path so a verifier can recompute the leaf."""
        return self._commits[block_index].record_chunk(record_index, task_id)

    def verify_record(self, block_index: int, record_index: int,
                      leaf: Optional[bytes] = None,
                      proof: Optional[Sequence[Tuple[str, str]]] = None,
                      task_id: Optional[str] = None) -> bool:
        """Check one record against the on-chain root (record/proof default
        to the ledger's own stored copies; pass externally-held values to
        audit a third party's claim). The leaf is recomputed from the
        record's chunk with ``leaf`` substituted at the record's offset.

        Deprecated thin wrapper over ``SettlementProof.verify`` (the one
        verification rule for every block flavor)."""
        from repro_torch.chain.proofs import SettlementProof
        blk = self.blocks[block_index]
        if not blk.records_root:
            return False
        chunk, offset = self.record_chunk(block_index, record_index, task_id)
        if leaf is not None:
            chunk[offset] = leaf
        if proof is None:
            proof = self.merkle_proof(block_index, record_index, task_id)
        sp = SettlementProof(block_index=block_index,
                             leaf_index=record_index, chunk=tuple(chunk),
                             offset=offset,
                             path=tuple(tuple(p) for p in proof),
                             root=blk.records_root)
        return sp.verify(blk)

    def tamper_record(self, block_index: int, record_index: int,
                      leaf: bytes, task_id: Optional[str] = None) -> None:
        """Test hook: corrupt an off-chain settlement record in place."""
        self._commits[block_index].tamper(record_index, leaf, task_id)

    @staticmethod
    def randomness_from(head_hash: str, round_index: int) -> int:
        """Deterministic on-chain randomness (leader rotation seed) derived
        from a chain-head hash — every node derives the same leader. Static
        so a pipelined driver can consume a head published by the settler
        thread without racing live ledger state."""
        return int(sha256(f"{head_hash}:{round_index}".encode())[:16], 16)

    def randomness(self, round_index: int) -> int:
        return self.randomness_from(self.head.hash, round_index)

    def transactions_of_type(self, tx_type: str) -> List[dict]:
        return [tx for blk in self.blocks for tx in blk.transactions
                if tx.get("type") == tx_type]
