"""Chain read path: batched proof serving + light-client verification.

The paper's §III architecture splits chain participants into heavy nodes
(cluster heads / the blockchain committee, who hold full settlement
state) and everyone else — workers, requesters, auditors — who must be
able to *check* what the chain settled without replaying it. This
package is that read path, in two halves:

**Server half** — :class:`ChainReadServer` wraps a live
:class:`~repro_torch.core.node.ChainNode` (or a bare ledger + contracts) and
serves three things, all lock-free against the node's settler threads:

* an O(1) head-sync handshake (``sync_head``): the client states its
  ``(height, block_hash)`` and gets back either a "you're current"
  token or exactly the header delta it is missing;
* batched settlement proofs (``get_proofs``): one deduplicated Merkle
  multiproof per ``(task, round, worker_ids)`` request, resolving
  through every commit flavor the chain produces (dense, sharded,
  delta-overlay, multi-task) — adjacent workers share all but
  O(log(W/k)) sibling digests;
* content-addressed checkpoint streaming (``checkpoint_manifest`` /
  ``checkpoint_chunk``): bounded byte-range reads of published model
  blobs out of the :class:`~repro_torch.chain.ipfs.IPFSStore`, under
  per-client serve quotas.

**Client half** — :class:`LightClient` holds *only block headers*. It
verifies the header chain link by link on sync (hash recomputation, so
header hashes are bit-identical to full-node block hashes), verifies
proof batches with one framed sha256 pass per Merkle level, re-anchors
stale proofs by syncing forward, and reassembles + content-verifies
streamed checkpoints. A tampered header, proof, or checkpoint never
verifies; a light client therefore audits any worker's settlement
record — score, penalty, stake, staleness — against nothing but the
chain head, which is the paper's trust-penalization transparency claim
made concrete.
"""
from repro_torch.chain.ipfs import QuotaExceeded
from repro_torch.chain.proofs import (BlockHeader, ProofBatch, SettlementProof,
                                header_of)
from repro_torch.serve.client import (HeaderVerificationError, LightClient,
                                StaleProofError)
from repro_torch.serve.server import (ChainReadServer, CheckpointManifest,
                                HeadSync, RoundNotSettled)

__all__ = [
    "ChainReadServer", "LightClient", "HeadSync", "CheckpointManifest",
    "RoundNotSettled", "StaleProofError", "HeaderVerificationError",
    "QuotaExceeded", "BlockHeader", "ProofBatch", "SettlementProof",
    "header_of",
]
