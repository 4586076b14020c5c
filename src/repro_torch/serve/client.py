"""Client half of the chain read path: the header-only light client.

A ``LightClient`` holds nothing but verified block headers. Sync
verifies the chain link by link (index continuity, ``prev_hash``
linkage, full hash recomputation — header hashes are bit-identical to
full-node block hashes by construction), so a server cannot feed a
client headers it didn't seal. Proof batches then verify against the
client's *own* header for the claimed block, one framed sha256 pass per
Merkle level; checkpoints stream in bounded chunks and verify against
their content address. The server is untrusted throughout — every
answer is checked, and a stale answer re-anchors by syncing forward.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.chain.ipfs import _unpack_leaves
from repro_torch.chain.ledger import Ledger
from repro_torch.chain.proofs import BlockHeader, ProofBatch, verify_proof_batch

__all__ = ["LightClient", "StaleProofError", "HeaderVerificationError"]


class HeaderVerificationError(ValueError):
    """A served header fails chain verification (bad index, broken
    ``prev_hash`` link, or a hash that doesn't recompute)."""


class StaleProofError(RuntimeError):
    """A proof batch references a block beyond the client's synced
    head — sync first, then re-verify (the proof itself may be fine)."""

    def __init__(self, block_index: int, height: int) -> None:
        super().__init__(
            f"proof targets block {block_index} but only {height} "
            f"headers are synced")
        self.block_index = block_index
        self.height = height


class LightClient:
    """Header-only verifying client of a :class:`ChainReadServer`.

    State is just ``headers`` — the verified chain prefix. Everything
    else (proofs, records, checkpoints) is fetched on demand and checked
    against those headers before being believed."""

    def __init__(self, server, client_id: Optional[str] = None) -> None:
        self.server = server
        self.client_id = client_id
        self.headers: List[BlockHeader] = []
        # resets received while already holding verified headers — i.e.
        # the server's chain reorged out from under us (repro_torch.net fork
        # choice) and we re-verified the winning fork from genesis
        self.reorg_resyncs = 0

    @property
    def height(self) -> int:
        return len(self.headers)

    # -- header sync -----------------------------------------------------------

    def _verify_and_adopt(self, headers: Sequence[BlockHeader],
                          base: List[BlockHeader]) -> List[BlockHeader]:
        prev = base[-1].hash if base else Ledger.GENESIS_HASH
        index = len(base)
        out = list(base)
        for h in headers:
            if h.index != index:
                raise HeaderVerificationError(
                    f"expected header {index}, got {h.index}")
            if h.prev_hash != prev:
                raise HeaderVerificationError(
                    f"header {h.index} does not link to {prev[:12]}…")
            if h.compute_hash() != h.hash:
                raise HeaderVerificationError(
                    f"header {h.index} hash does not recompute")
            out.append(h)
            prev = h.hash
            index += 1
        return out

    def sync(self) -> int:
        """One head-sync handshake: verify and adopt whatever delta the
        server returns (or the full chain on ``reset`` — which, against
        a ``repro_torch.net`` replica, is how a reorg reaches light clients:
        the dead-fork claim misses, and the winning fork is re-verified
        from genesis, counted in ``reorg_resyncs``). Returns the number
        of headers gained (possibly negative across a reorg onto a
        shorter-but-heavier fork); raises ``HeaderVerificationError`` —
        leaving local state untouched — on any bad header."""
        claim_hash = self.headers[-1].hash if self.headers else None
        reply = self.server.sync_head(len(self.headers), claim_hash)
        if reply.current:
            return 0
        if reply.reset and self.headers:
            self.reorg_resyncs += 1
        base = [] if reply.reset else self.headers
        adopted = self._verify_and_adopt(reply.headers, base)
        gained = len(adopted) - len(self.headers)
        self.headers = adopted
        return gained

    # -- proof verification ----------------------------------------------------

    def verify_batch(self, batch: ProofBatch) -> bool:
        """Verify a proof batch against the client's own header for its
        block. ``StaleProofError`` means the client hasn't synced that
        far; any cryptographic failure returns ``False``."""
        if not 0 <= batch.block_index < len(self.headers):
            raise StaleProofError(batch.block_index, len(self.headers))
        return verify_proof_batch(batch, self.headers[batch.block_index])

    def fetch_proofs(self, task_id: Optional[str],
                     worker_ids: Sequence[int],
                     round_index: Optional[int] = None) -> ProofBatch:
        """Fetch a batch from the server (unverified — pair with
        ``verify_batch``)."""
        return self.server.get_proofs(task_id, worker_ids,
                                      round_index=round_index)

    def audit(self, task_id: Optional[str], worker_id: int,
              round_index: Optional[int] = None) -> Dict[str, Any]:
        """End-to-end audit of one worker's settlement record: fetch its
        proof, re-anchor by syncing if the proof outruns our headers,
        verify, and return the decoded record — raising ``ValueError``
        if the server's answer does not verify or names a different
        worker."""
        batch = self.fetch_proofs(task_id, [int(worker_id)],
                                  round_index=round_index)
        try:
            ok = self.verify_batch(batch)
        except StaleProofError:
            self.sync()
            ok = self.verify_batch(batch)
        if not ok:
            raise ValueError(
                f"settlement proof for worker {worker_id} rejected")
        record = batch.decoded(0)
        if record["worker"] != int(worker_id):
            raise ValueError(
                f"proof is for worker {record['worker']}, "
                f"not {worker_id}")
        return record

    # -- checkpoint streaming --------------------------------------------------

    def fetch_checkpoint(self, cid: str):
        """Stream a published checkpoint in bounded chunks, verify the
        reassembled bytes against their content address, and return the
        decoded model leaves. Oversized chunks and content mismatches
        raise ``ValueError`` — a tampered store cannot slip a forged
        checkpoint past the cid."""
        manifest = self.server.checkpoint_manifest(cid)
        parts = []
        for i in range(manifest.num_chunks):
            part = self.server.checkpoint_chunk(cid, i,
                                                client_id=self.client_id)
            if len(part) > manifest.chunk_bytes:
                raise ValueError(f"chunk {i} exceeds the manifest bound")
            parts.append(part)
        blob = b"".join(parts)
        if hashlib.sha256(blob).hexdigest() != cid:
            raise ValueError(f"content hash mismatch for {cid}")
        return _unpack_leaves(blob)[0]
