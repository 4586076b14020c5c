"""Content-addressed artifact store — the IPFS stand-in.

Model weights are serialized (msgpack of flattened numpy leaves,
compressed) and stored under their SHA-256 content hash; cluster heads
"publish" aggregates here and other clusters "fetch by hash", exactly the
paper's workflow. Retrieval verifies the hash (tamper evidence).

The port's trees are (nested) dicts of tensors or arrays, flattened in
sorted-key order; the payload's ``treedef`` names the leaf paths. The
cids are the port's own (the JAX package's treedef string differs).
``IPFSStore`` is a verbatim copy of the reference's.

Compression prefers zstd; containers without ``zstandard`` fall back to
stdlib zlib (same API, blobs stay self-consistent within a process/run).
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional

import msgpack
import numpy as np
import torch

try:
    import zstandard as _zstd

    def _compress(data: bytes) -> bytes:
        return _zstd.ZstdCompressor(level=3).compress(data)

    def _decompress(blob: bytes) -> bytes:
        return _zstd.ZstdDecompressor().decompress(blob)
except ModuleNotFoundError:
    import zlib

    def _compress(data: bytes) -> bytes:
        return zlib.compress(data, 6)

    def _decompress(blob: bytes) -> bytes:
        return zlib.decompress(blob)


def flatten_tree(tree: Any, prefix: str = ""):
    """(path, leaf) pairs of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten_tree(tree[k], f"{prefix}{k}."))
        return out
    return [(prefix[:-1], tree)]


def _host(x) -> "tuple[str, np.ndarray]":
    """(dtype name, contiguous numpy data); bf16 is stored as f32 data."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.float().numpy()
        return str(x.numpy().dtype), x.numpy()
    x = np.asarray(x)
    return str(x.dtype), x


def _pack_tree(tree: Any) -> bytes:
    pairs = flatten_tree(tree)
    leaves = []
    for _, x in pairs:
        dt, arr = _host(x)
        leaves.append({"dtype": dt, "shape": list(arr.shape),
                       "data": np.ascontiguousarray(arr).tobytes()})
    payload = {"treedef": "dict(" + ", ".join(p for p, _ in pairs) + ")",
               "leaves": leaves}
    return _compress(msgpack.packb(payload))


def _unpack_leaves(blob: bytes):
    payload = msgpack.unpackb(_decompress(blob))
    out = []
    for leaf in payload["leaves"]:
        dt = leaf["dtype"]
        arr = np.frombuffer(leaf["data"],
                            dtype=np.float32 if dt == "bfloat16" else dt)
        out.append(arr.reshape(leaf["shape"]))
    return out, payload["treedef"]


class QuotaExceeded(RuntimeError):
    """A put would push its owner past the store's per-owner byte quota.

    Carries ``owner``, the owner's current logical ``used`` bytes, the
    rejected blob's ``requested`` size, and the configured ``quota``. The
    put is rejected atomically — no store state (global or per-owner
    accounting) changes."""

    def __init__(self, owner: str, used: int, requested: int,
                 quota: int) -> None:
        super().__init__(
            f"owner {owner!r} quota exceeded: {used} + {requested} bytes "
            f"> quota {quota}")
        self.owner = owner
        self.used = used
        self.requested = requested
        self.quota = quota


class IPFSStore:
    """In-process content-addressed store with hash-verified retrieval.

    Multi-tenant accounting: a store shared by several federated tasks on
    one chain node tags puts with an ``owner`` (task id), tracking
    per-owner put counts and logical bytes. Content addressing dedups
    across owners — two tasks publishing an identical tree store one blob
    (counted in ``dedup_hits``) while each owner's logical usage is still
    attributed.

    ``owner_quota_bytes`` (0 = unlimited) enforces a per-owner cap on
    *logical* bytes — dedup'd puts still count against their owner, so one
    tenant cannot ride another tenant's identical blobs to unlimited
    attribution. An over-quota put raises ``QuotaExceeded`` before any
    state changes; anonymous (ownerless) puts are never quota'd."""

    def __init__(self, owner_quota_bytes: int = 0) -> None:
        if owner_quota_bytes < 0:
            raise ValueError("owner_quota_bytes must be >= 0")
        self._store: Dict[str, bytes] = {}
        self.owner_quota_bytes = owner_quota_bytes
        self.bytes_stored = 0
        self.puts = 0
        self.gets = 0
        self.dedup_hits = 0
        self.puts_by_owner: Dict[str, int] = {}
        self.bytes_by_owner: Dict[str, int] = {}
        # streaming (read-path) accounting: byte-range reads served to
        # checkpoint-streaming clients (repro.serve)
        self.reads = 0
        self.bytes_read = 0

    def put_tree(self, tree: Any, owner: str = None) -> str:
        blob = _pack_tree(tree)
        cid = hashlib.sha256(blob).hexdigest()
        if owner is not None and self.owner_quota_bytes:
            used = self.bytes_by_owner.get(owner, 0)
            if used + len(blob) > self.owner_quota_bytes:
                raise QuotaExceeded(owner, used, len(blob),
                                    self.owner_quota_bytes)
        if cid not in self._store:
            self._store[cid] = blob
            self.bytes_stored += len(blob)
        else:
            self.dedup_hits += 1
        self.puts += 1
        if owner is not None:
            self.puts_by_owner[owner] = self.puts_by_owner.get(owner, 0) + 1
            self.bytes_by_owner[owner] = \
                self.bytes_by_owner.get(owner, 0) + len(blob)
        return cid

    def put_blob(self, blob: bytes, owner: str = None) -> str:
        """Store an already-serialized blob under its content address —
        how a gossiped artifact (a peer cluster's aggregate, shipped as
        raw bytes over ``repro.net``) enters the local store. Same dedup
        and per-owner quota accounting as ``put_tree``."""
        cid = hashlib.sha256(blob).hexdigest()
        if owner is not None and self.owner_quota_bytes:
            used = self.bytes_by_owner.get(owner, 0)
            if used + len(blob) > self.owner_quota_bytes:
                raise QuotaExceeded(owner, used, len(blob),
                                    self.owner_quota_bytes)
        if cid not in self._store:
            self._store[cid] = blob
            self.bytes_stored += len(blob)
        else:
            self.dedup_hits += 1
        self.puts += 1
        if owner is not None:
            self.puts_by_owner[owner] = self.puts_by_owner.get(owner, 0) + 1
            self.bytes_by_owner[owner] = \
                self.bytes_by_owner.get(owner, 0) + len(blob)
        return cid

    def get_leaves(self, cid: str):
        blob = self._store[cid]
        if hashlib.sha256(blob).hexdigest() != cid:    # tamper check
            raise ValueError(f"content hash mismatch for {cid}")
        self.gets += 1
        return _unpack_leaves(blob)[0]

    def blob_size(self, cid: str) -> int:
        """Stored (compressed) byte size of a blob — what a streaming
        server paginates over the wire."""
        return len(self._store[cid])

    def read_blob(self, cid: str, start: int = 0,
                  stop: Optional[int] = None) -> bytes:
        """Raw byte-range read of a stored blob. No hash check here — a
        streaming client verifies the *reassembled* blob against its
        content address (the cid), which is what makes bounded-chunk
        checkpoint streaming tamper-evident end to end without the server
        materializing whole blobs per request."""
        if start < 0:
            raise ValueError("start must be >= 0")
        blob = self._store[cid]
        part = blob[start:len(blob) if stop is None else stop]
        self.reads += 1
        self.bytes_read += len(part)
        return part

    def has(self, cid: str) -> bool:
        return cid in self._store

    def tamper(self, cid: str, blob: bytes) -> None:
        """Test hook: corrupt a stored object in place."""
        self._store[cid] = blob
