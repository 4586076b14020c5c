"""Fork tracking and fork choice for the multi-node settlement chain.

``BlockTree`` indexes every valid block a node has seen (its own seals
plus gossiped peers' blocks) by hash, keyed off the node's trusted base
chain (genesis + deployment block). Fork choice is **longest valid
chain with a cumulative-trust tiebreak**:

1. greater height wins (most settled rounds),
2. at equal height, greater cumulative trust wins — each block
   contributes its ``seal`` transaction's ``trust`` field (the sum of
   the cohort's trust scores it settled), so after a partition the
   majority side's fork — the one that kept settling more of the
   federation — beats the minority fork of the same length (the
   reliability tiebreak of the paper's trust-penalization pillar),
3. at equal trust, the lexicographically smaller block hash wins
   (arbitrary but deterministic: every node picks the same head).

``apply_reorg`` turns a fork-choice decision into ledger state: roll
the ledger back to the common ancestor (``Ledger.rollback_to``) and
adopt the winning branch block-by-block (``Ledger.adopt_block``, which
re-verifies linkage, hashes, and each shipped commit against the
block's ``records_root`` — including sparse ``DeltaCommit`` overlay
chains, whose ancestor commits survive the rollback so idle-worker
proofs from the surviving prefix stay valid). Contract state is the
caller's half: ``repro_torch.net.node.SettlementNode`` restores its snapshot
at the ancestor and replays the adopted blocks' settlement records.

Blocks marked invalid (equivocation evidence, failed semantic
validation) are excluded from fork choice together with all their
descendants.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.chain.ledger import Block, Ledger, MultiTaskCommit

__all__ = ["block_trust", "seal_info", "BlockTree", "apply_reorg"]


def seal_info(block: Block) -> Optional[Tuple[int, int]]:
    """``(round, proposer)`` from a network block's ``seal`` transaction,
    or None for non-network blocks (genesis, deployment)."""
    for tx in block.transactions:
        if isinstance(tx, dict) and tx.get("type") == "seal":
            try:
                return int(tx["round"]), int(tx["proposer"])
            except (KeyError, TypeError, ValueError):
                return None
    return None


def block_trust(block: Block) -> float:
    """One block's fork-choice weight: the trust mass its seal settled
    (0.0 for blocks without a ``seal`` tx, so base-chain blocks are
    weightless)."""
    total = 0.0
    for tx in block.transactions:
        if isinstance(tx, dict) and tx.get("type") == "seal":
            try:
                total += float(tx["trust"])
            except (KeyError, TypeError, ValueError):
                pass
    return total


class BlockTree:
    """Hash-indexed fork tree over one node's view of the network chain."""

    def __init__(self, base_blocks: Sequence[Block],
                 base_commits: Optional[Dict[int, MultiTaskCommit]] = None
                 ) -> None:
        """Seed the tree with the node's trusted base chain (typically
        ``ledger.blocks`` right after local genesis + deployment —
        adopted without re-verification)."""
        if not base_blocks:
            raise ValueError("base chain must contain at least genesis")
        self._blocks: Dict[str, Block] = {}
        self._commits: Dict[str, Optional[MultiTaskCommit]] = {}
        self._children: Dict[str, List[str]] = {}
        self._height: Dict[str, int] = {}
        self._weight: Dict[str, float] = {}
        self._invalid: Set[str] = set()
        prev: Optional[str] = None
        for blk in base_blocks:
            h = blk.hash
            self._blocks[h] = blk
            self._commits[h] = None if base_commits is None \
                else base_commits.get(blk.index)
            self._height[h] = blk.index
            self._weight[h] = (0.0 if prev is None
                               else self._weight[prev]) + block_trust(blk)
            self._children.setdefault(h, [])
            if prev is not None:
                self._children[prev].append(h)
            prev = h
        self.root = base_blocks[0].hash

    def __contains__(self, block_hash: str) -> bool:
        return block_hash in self._blocks

    def block(self, block_hash: str) -> Block:
        return self._blocks[block_hash]

    def commit(self, block_hash: str) -> Optional[MultiTaskCommit]:
        return self._commits[block_hash]

    def height(self, block_hash: str) -> int:
        return self._height[block_hash]

    def is_valid(self, block_hash: str) -> bool:
        return block_hash in self._blocks \
            and block_hash not in self._invalid

    def add(self, block: Block,
            commit: Optional[MultiTaskCommit] = None) -> bool:
        """Index a block under its parent. Returns False when the parent
        is unknown (orphan — the caller should chain-sync from the
        sender); duplicate adds are no-ops returning True. Descendants of
        invalidated blocks inherit the invalidation."""
        h = block.hash
        if h in self._blocks:
            return True
        parent = block.prev_hash
        if parent not in self._blocks:
            return False
        self._blocks[h] = block
        self._commits[h] = commit
        self._height[h] = self._height[parent] + 1
        self._weight[h] = self._weight[parent] + block_trust(block)
        self._children.setdefault(h, [])
        self._children[parent].append(h)
        if parent in self._invalid:
            self._invalid.add(h)
        return True

    def invalidate(self, block_hash: str) -> int:
        """Mark a block and every descendant ineligible for fork choice
        (equivocation / tampered records / failed validation). Returns
        how many blocks were newly invalidated."""
        if block_hash not in self._blocks:
            return 0
        stack, n = [block_hash], 0
        while stack:
            h = stack.pop()
            if h not in self._invalid:
                self._invalid.add(h)
                n += 1
            stack.extend(self._children.get(h, ()))
        return n

    def best_head(self) -> str:
        """The fork-choice winner over all valid blocks: max
        ``(height, cumulative trust)``, ties broken by the smaller hash
        (deterministic across nodes)."""
        best: Optional[str] = None
        for h in self._blocks:
            if h in self._invalid:
                continue
            if best is None:
                best = h
                continue
            key = (self._height[h], self._weight[h])
            bkey = (self._height[best], self._weight[best])
            if key > bkey or (key == bkey and h < best):
                best = h
        assert best is not None            # the base chain is never invalid
        return best

    def chain_to(self, block_hash: str) -> List[Block]:
        """Root→``block_hash`` path (inclusive)."""
        out = []
        h: Optional[str] = block_hash
        while h is not None:
            blk = self._blocks[h]
            out.append(blk)
            h = blk.prev_hash if blk.index > self._blocks[self.root].index \
                else None
        out.reverse()
        if out[0].hash != self.root:
            raise KeyError(f"{block_hash[:12]}… does not descend from root")
        return out

    def ancestor(self, a: str, b: str) -> str:
        """Hash of the deepest common ancestor of two blocks."""
        ha, hb = self._height[a], self._height[b]
        while ha > hb:
            a = self._blocks[a].prev_hash
            ha -= 1
        while hb > ha:
            b = self._blocks[b].prev_hash
            hb -= 1
        while a != b:
            a = self._blocks[a].prev_hash
            b = self._blocks[b].prev_hash
        return a


def apply_reorg(ledger: Ledger, tree: BlockTree, new_head: str,
                verify_commit: bool = True) -> Tuple[int, List[Block]]:
    """Move ``ledger`` from its current head to ``new_head``: roll back
    to the common ancestor, then adopt the winning branch (each block's
    shipped commit re-verified against its ``records_root`` unless
    ``verify_commit=False``). Returns ``(ancestor_index, adopted)`` —
    the caller restores contract state at ``ancestor_index`` and replays
    the adopted blocks' settlement records. On an adoption failure
    (tampered block mid-branch) the ledger is left at the consistent
    prefix ending in the last good block and the error propagates."""
    cur = ledger.head.hash
    if cur == new_head:
        return ledger.head.index, []
    anc = tree.ancestor(cur, new_head)
    anc_index = tree.height(anc)
    path = tree.chain_to(new_head)[anc_index - tree.height(tree.root) + 1:]
    ledger.rollback_to(anc_index)
    adopted: List[Block] = []
    for blk in path:
        ledger.adopt_block(blk, tree.commit(blk.hash),
                           verify_commit=verify_commit)
        adopted.append(blk)
    return anc_index, adopted
