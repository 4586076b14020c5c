"""Scenario: multi-node semi-decentralized settlement, end to end.

Three chain replicas (one per cluster head) drive four settlement rounds
over a deterministic simulated network, through escalating faults:

1. **fault-free** — scores, cluster aggregates, and sealed blocks gossip
   over lossy links; every replica converges to one byte-identical chain
   with bit-equal contract state (checked against a from-scratch replay
   of the canonical chain).
2. **partition → forks → rejoin** — a 2-round split leaves the minority
   replica on its own fork; fork choice (longest valid chain, cumulative
   seal-trust tiebreak) reorgs it back onto the winner, rolling contract
   state back and replaying it forward block by block.
3. **byzantine head** — an equivocating head seals two conflicting
   blocks for the same slot; honest replicas detect the conflict on
   receipt, seal equivocation evidence on-chain, blanket-reject the
   offender, and slash its head worker's stake.
4. **light client across the reorg** — a ``LightClient`` synced to the
   minority fork observes the rejoin as a header ``reset`` (the
   sync_head mismatch is a real reorg signal) and re-verifies settlement
   proofs against the winning chain.

    PYTHONPATH=src python -m repro_torch.examples.decentralized_network
"""
import numpy as np

from repro_torch.net import (LinkSpec, NetworkHarness, contract_fingerprint,
                       head_worker, replay_chain)
from repro_torch.serve import ChainReadServer, LightClient


def fault_free() -> None:
    print("== 1. fault-free convergence over lossy links ==")
    h = NetworkHarness(3, seed=11,
                       link=LinkSpec(latency=0.02, jitter=0.02, loss=0.1))
    h.run(4)
    h.sync()
    heads = {n.ledger.head.hash for n in h.nodes}
    assert len(heads) == 1 and h.converged()
    n0 = h.nodes[0]
    _, replayed = replay_chain(n0.ledger.blocks, n0.ledger._commits,
                               h.workers_per_node)
    assert contract_fingerprint(replayed) == contract_fingerprint(n0.contract)
    print(f"  3 replicas, head {n0.ledger.head.hash[:12]}…, "
          f"{h.net.delivered} msgs delivered "
          f"({h.net.dropped_loss} lost), state bit-equal to replay\n")


def partition_rejoin() -> None:
    print("== 2. partition -> forks -> rejoin ==")
    h = NetworkHarness(3, seed=4, partition_rounds=[(1, 3, ((0, 1), (2,)))])
    h.run(3)
    forked = h.nodes[2].ledger.head.hash != h.nodes[0].ledger.head.hash
    print(f"  during split: minority on its own fork = {forked}")
    h.run(1)
    assert h.converged()
    print(f"  after rejoin: minority reorged {h.nodes[2].reorgs}x onto the "
          f"majority fork, all {len(h.nodes[0].ledger.blocks)} blocks "
          f"byte-identical, rounds settled = "
          f"{sorted(h.nodes[0].contract._round_blocks)}\n")


def byzantine_head() -> NetworkHarness:
    print("== 3. equivocating byzantine head ==")
    byz = 1
    h = NetworkHarness(3, seed=2, byzantine={byz: "equivocate"})
    h.run(4)
    honest = h.honest_nodes()
    n = honest[0]
    txs = [tx for b in n.ledger.blocks for tx in b.transactions
           if isinstance(tx, dict)]
    ev = next(tx for tx in txs if tx.get("type") == "equivocation")
    w = head_worker(ev["round"], byz, h.workers_per_node)
    print(f"  node {byz} equivocated in round {ev['round']}: "
          f"{len(ev['blocks'])} conflicting blocks seen")
    print(f"  evidence on-chain, head worker {w} slashed: stake "
          f"{n.contract.stake[w]:.1f} (full stake is "
          f"{n.contract.F:.1f}), penalized "
          f"{int(n.contract.penalized_rounds[w])}x")
    assert all(tx["proposer"] != byz for tx in txs
               if tx.get("type") == "seal")
    print(f"  no byzantine seal canonicalized; rounds "
          f"{sorted(n.contract._round_blocks)} still settled by honest "
          f"backups\n")
    return h


def light_client_reorg() -> None:
    print("== 4. light client across the reorg ==")
    h = NetworkHarness(3, seed=3, partition_rounds=[(1, 3, ((0, 1), (2,)))])
    minority = h.nodes[2]
    server = ChainReadServer(ledger=minority.ledger,
                             contracts={None: minority.contract})
    client = LightClient(server)
    h.run(3)
    client.sync()
    fork_head = client.headers[-1].hash[:12]
    h.run(2)
    client.sync()
    r = server.latest_settled_round(None)
    batch = server.get_proofs(None, list(range(h.workers_per_node)),
                              round_index=r)
    assert client.verify_batch(batch)
    print(f"  client tracked fork {fork_head}…; reorg observed as "
          f"{client.reorg_resyncs} reset resync "
          f"(server counted {server.head_resets}); now on "
          f"{client.headers[-1].hash[:12]}… with round-{r} proofs "
          f"verified\n")


def main(device=None) -> None:
    """The four scenarios. The settlement network is host-only (it trains
    no model), so ``device`` only keeps the examples' signature."""
    np.set_printoptions(precision=3)
    fault_free()
    partition_rejoin()
    byzantine_head()
    light_client_reorg()
    print("all scenarios converged.")


if __name__ == "__main__":
    main()
