"""`repro_torch.net` — multi-node semi-decentralized settlement.

The paper's semi-decentralized layer, made multi-*node*: several chain
replicas (one per cluster head) gossip scores, cluster aggregates, and
sealed blocks over a deterministic simulated transport, agree via
longest-valid-chain fork choice with a cumulative-trust tiebreak, and
punish head misbehavior (equivocation, tampered super-roots) with
on-chain evidence and stake slashes.

Layers:

- ``repro_torch.net.sim`` — ``SimNet``: seeded per-link latency/jitter/loss
  and timed partition windows on the shared simulated clock;
  byte-reproducible runs (the fault-injection harness).
- ``repro_torch.net.fork_choice`` — ``BlockTree`` + ``apply_reorg``: fork
  tracking, (height, trust, hash) fork choice, rollback/replay through
  ``Ledger.rollback_to``/``adopt_block``.
- ``repro_torch.net.node`` — ``SettlementNode`` (honest replica),
  ``EquivocatingNode``/``TamperingNode`` (byzantine heads),
  ``NetworkHarness`` (round driver), ``replay_chain`` (the
  single-node replay oracle the property tests compare against).
"""
from repro_torch.net.fork_choice import (BlockTree, apply_reorg, block_trust,
                                   seal_info)
from repro_torch.net.node import (AggregateGossip, BlockGossip, ChainRequest,
                            HeadAnnounce,
                            ChainResponse, EquivocatingNode, NetworkHarness,
                            ScoreGossip, SettlementNode, TamperingNode,
                            apply_block_state, contract_fingerprint,
                            head_worker, make_score_fn, replay_chain,
                            settlement_records)
from repro_torch.net.sim import LinkSpec, Partition, SimNet

__all__ = [
    "LinkSpec", "Partition", "SimNet",
    "BlockTree", "apply_reorg", "block_trust", "seal_info",
    "ScoreGossip", "AggregateGossip", "BlockGossip", "ChainRequest",
    "ChainResponse", "HeadAnnounce", "SettlementNode", "EquivocatingNode",
    "TamperingNode",
    "NetworkHarness", "replay_chain", "settlement_records",
    "apply_block_state", "contract_fingerprint", "make_score_fn",
    "head_worker",
]
