"""The port's settlement network (``repro_torch.net``) against the JAX
package's (``repro.net``), the cross-cluster exchange it gossips through
(fault F3), fork choice, and the ``ChainNode`` network seams.

``net/*.py`` are verbatim copies; what differs underneath is the port's
``chain/ipfs.py``, whose cids are its own (its treedef string differs).
Network blocks carry the cluster aggregates' cids, and every round's
proposer after round 0 is drawn from the head block's hash
(``SettlementNode.candidate_rank``), so the two packages' proposer
sequences, block hashes and reorg counts differ by design and are never
compared. What must agree is what does not depend on a hash: the contract
state (``contract_fingerprint``, byte for byte), the evidence on chain
(type, round, offender, slashed worker), convergence, chain heights and
the settled rounds. Each package's replay oracle must also rebuild the
other package's canonical chain to the other's state, byte for byte.

F3: the port's ``ClusterExchange.fetch`` and ``merge`` took only tensors,
while ``SettlementNode`` publishes and merges numpy aggregates. The merge
of numpy aggregates is held to the reference's at 1e-6 absolute (both sum
f32 products in the same order; values are below 2).
"""
import numpy as np
import pytest
import torch

import repro.net as jnet
from repro.core.gossip import ClusterExchange as JExchange
from repro.chain.ipfs import IPFSStore as JStore
from repro.chain.ledger import Ledger as JLedger
from repro_torch import net
from repro_torch.chain.ipfs import IPFSStore
from repro_torch.chain.ledger import Block, Ledger
from repro_torch.core.gossip import ClusterExchange
from repro_torch.net.fork_choice import BlockTree, seal_info

MERGE_TOL = 1e-6
PARTITION = [(1, 3, ((0, 1), (2,)))]


# -- F3: numpy aggregates through the exchange ---------------------------------


def _aggregates(seed, C=3):
    rng = np.random.default_rng(seed)
    return [{"cluster_mean": rng.random(2).astype(np.float32),
             "w": rng.standard_normal((2, 3)).astype(np.float32)}
            for _ in range(C)]


def _merge(exchange_cls, store_cls, ledger_cls, aggs, trust):
    ex = exchange_cls(store_cls(), ledger_cls(), len(aggs))
    for c, a in enumerate(aggs):
        ex.publish(0, c, a)
    return ex.merge(0, 0, aggs[0], peer_trust=trust)


@pytest.mark.parametrize("trust", [(1.0, 1.0, 1.0), (0.3, 0.9, 0.2),
                                   (1.0, 0.0, 0.7)])
def test_f3_merge_of_numpy_aggregates_matches_reference(trust):
    aggs = _aggregates(1)
    got = _merge(ClusterExchange, IPFSStore, Ledger, aggs, trust)
    want = _merge(JExchange, JStore, JLedger, aggs, trust)
    assert set(got) == set(want)
    for k in want:
        assert isinstance(got[k], np.ndarray) and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=MERGE_TOL)


def test_f3_fetch_gives_back_the_kind_it_was_given():
    aggs = _aggregates(2, C=2)
    ex = ClusterExchange(IPFSStore(), Ledger(), 2)
    for c, a in enumerate(aggs):
        ex.publish(0, c, a)
    like = {"cluster_mean": np.zeros(2, np.float64),
            "w": np.zeros((2, 3), np.float32)}
    got = ex.fetch(0, 1, like)
    assert got["cluster_mean"].dtype == np.float64
    np.testing.assert_array_equal(got["w"], aggs[1]["w"])
    tlike = {k: torch.zeros(v.shape, dtype=torch.float64)
             for k, v in aggs[0].items()}
    tgot = ex.fetch(0, 1, tlike)
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float64
               for v in tgot.values())
    np.testing.assert_array_equal(tgot["w"].numpy(), aggs[1]["w"])


def test_f3_tensor_merge_unchanged():
    """The tensor path keeps its formula: own · 0.5 plus each peer at its
    trust share, in f32, cast back to the aggregate's dtype."""
    aggs = _aggregates(3)
    taggs = [{k: torch.from_numpy(v) for k, v in a.items()} for a in aggs]
    trust = (0.0, 0.6, 0.2)
    got = _merge(ClusterExchange, IPFSStore, Ledger, taggs, trust)
    w = np.asarray(trust[1:]) / sum(trust[1:]) * 0.5
    for k in got:
        want = 0.5 * taggs[0][k].float()
        for c, wc in zip((1, 2), w):
            want = want + float(wc) * taggs[c][k].float()
        assert isinstance(got[k], torch.Tensor)
        assert torch.equal(got[k], want)


def test_f3_settlement_node_merges_numpy_aggregates():
    """``merged_aggregate`` (numpy in, numpy out) on a live harness, held
    to the reference node's."""
    got, want = (m.NetworkHarness(3, seed=1) for m in (net, jnet))
    for h in (got, want):
        h.run(2)
    for g, j in zip(got.nodes, want.nodes):
        a, b = g.merged_aggregate(1), j.merged_aggregate(1)
        np.testing.assert_allclose(a["cluster_mean"],
                                   np.asarray(b["cluster_mean"]), rtol=0,
                                   atol=MERGE_TOL)


# -- the settlement network against the reference ------------------------------


SCENARIOS = {
    "clean-s0": (dict(seed=0), 4),
    "clean-s7": (dict(seed=7), 4),
    "clean-5-nodes": (dict(seed=3, num_nodes=5), 3),
    "partition-s4": (dict(seed=4, partition_rounds=PARTITION), 5),
    "partition-s9": (dict(seed=9, partition_rounds=PARTITION), 5),
    "equivocate-s2": (dict(seed=2, byzantine={1: "equivocate"}), 4),
    "equivocate-s5": (dict(seed=5, byzantine={1: "equivocate"}), 2),
    "tamper-s6": (dict(seed=6, byzantine={1: "tamper"}), 2),
}


def _harness(mod, kw, rounds):
    kw = dict(kw)
    h = mod.NetworkHarness(kw.pop("num_nodes", 3), **kw)
    h.run(rounds)
    h.sync()
    return h


def _evidence(node):
    return [(tx["type"], tx["round"], tx["proposer"], tx["worker"])
            for b in node.ledger.blocks for tx in b.transactions
            if isinstance(tx, dict)
            and tx.get("type") in ("equivocation", "tampered_block")]


def _outcome(mod, h):
    honest = h.honest_nodes()
    n0 = honest[0]
    _, replayed = mod.replay_chain(n0.ledger.blocks, n0.ledger._commits,
                                   h.workers_per_node)
    assert mod.contract_fingerprint(replayed) \
        == mod.contract_fingerprint(n0.contract)
    assert all(n.verify() for n in honest)
    return {"fingerprints": [mod.contract_fingerprint(n.contract)
                             for n in honest],
            "evidence": [_evidence(n) for n in honest],
            "converged": h.converged(),
            "heights": [len(n.ledger.blocks) for n in honest],
            "settled": [sorted(n.contract._round_blocks) for n in honest],
            "total_value": [n.contract.total_value() for n in honest]}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_network_matches_reference(name):
    kw, rounds = SCENARIOS[name]
    got = _outcome(net, _harness(net, kw, rounds))
    want = _outcome(jnet, _harness(jnet, kw, rounds))
    assert got == want
    assert got["converged"]
    if "byzantine" in kw:
        (byz, _), = kw["byzantine"].items()
        assert got["evidence"][0] and all(
            e[2] == byz for e in got["evidence"][0])


@pytest.mark.parametrize("kw", [
    dict(seed=2, byzantine={0: "tamper"}),
    dict(seed=8, link=(0.02, 0.02, 0.15)),
    dict(seed=3, byzantine={2: "equivocate"},
         partition_rounds=[(1, 2, ((0,), (1, 2)))]),
], ids=["tamper", "lossy", "equivocate-partition"])
def test_each_package_replays_the_others_chain(kw):
    """The replay oracle of each package rebuilds the other package's
    canonical chain to that package's contract state, byte for byte."""
    for mod, other in ((net, jnet), (jnet, net)):
        k = dict(kw)
        if "link" in k:
            lat, jit, loss = k.pop("link")
            k["link"] = other.LinkSpec(latency=lat, jitter=jit, loss=loss)
        h = other.NetworkHarness(3, **k)
        h.run(4)
        h.sync()
        for n in h.honest_nodes():
            _, replayed = mod.replay_chain(n.ledger.blocks, n.ledger._commits,
                                           h.workers_per_node)
            assert mod.contract_fingerprint(replayed) \
                == other.contract_fingerprint(n.contract)


@pytest.mark.parametrize("seed", [1, 13])
def test_lossy_links_converge(seed):
    h = net.NetworkHarness(3, seed=seed,
                           link=net.LinkSpec(latency=0.02, jitter=0.02,
                                             loss=0.15))
    h.run(6)
    h.sync()
    chains = [[b.hash for b in n.ledger.blocks] for n in h.nodes]
    assert all(c == chains[0] for c in chains[1:])
    assert all(n.verify() for n in h.nodes)
    scheduled = h.net.sent - h.net.dropped_loss - h.net.dropped_partition
    assert h.net.dropped_loss > 0 and h.net.delivered == scheduled


def test_light_client_resyncs_across_reorg():
    from repro_torch.serve import ChainReadServer, LightClient
    h = net.NetworkHarness(3, seed=3, partition_rounds=PARTITION)
    minority = h.nodes[2]
    server = ChainReadServer(ledger=minority.ledger,
                             contracts={None: minority.contract})
    client = LightClient(server)
    h.run(3)
    client.sync()
    fork_head = client.headers[-1].hash
    h.run(2)
    assert minority.reorgs >= 1
    client.sync()
    assert client.reorg_resyncs == 1 and server.head_resets >= 1
    assert client.headers[-1].hash == minority.ledger.head.hash != fork_head
    r = server.latest_settled_round(None)
    assert client.verify_batch(server.get_proofs(None, [0, 1, 5],
                                                 round_index=r))


# -- fork choice against the reference -----------------------------------------


def _seal(block_cls, parent, round_index, proposer, trust, tag):
    txs = [{"type": "seal", "round": round_index, "proposer": proposer,
            "trust": trust}, {"type": "tag", "tag": tag}]
    blk = block_cls(parent.index + 1, parent.hash, txs,
                    float(round_index + 1))
    blk.hash = blk.compute_hash()
    return blk


def _fork_walk(ledger_cls, block_cls, tree_cls, seed):
    """Grow a random block tree (blocks arrive out of order, some are
    invalidated) and record every observable of the fork choice by block
    position, never by hash."""
    rng = np.random.default_rng(seed)
    base = ledger_cls()
    base.append_block([{"type": "deploy", "deposit": 100.0}], timestamp=0.0)
    blocks = [base.head]
    for i in range(14):
        parent = blocks[int(rng.integers(0, len(blocks)))]
        r = parent.index - 1
        blocks.append(_seal(block_cls, parent, r, int(rng.integers(0, 3)),
                            float(rng.integers(1, 4)), f"b{i}"))
    pos = {b.hash: i - 1 for i, b in enumerate([base.blocks[0]] + blocks)}
    tree = tree_cls(list(base.blocks))
    log = []
    for i in rng.permutation(np.arange(1, len(blocks))):
        log.append(("add", int(i), tree.add(blocks[i])))
        if rng.random() < 0.15:
            log.append(("invalidate", int(i), tree.invalidate(blocks[i].hash)))
        best = tree.best_head()
        log.append(("best", pos[best], tree.height(best),
                    [pos[b.hash] for b in tree.chain_to(best)]))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_block_tree_fork_choice_matches_reference(seed):
    from repro.chain.ledger import Block as JBlock
    from repro.net import BlockTree as JTree
    assert _fork_walk(Ledger, Block, BlockTree, seed) \
        == _fork_walk(JLedger, JBlock, JTree, seed)


def test_seal_info_reads_the_seal_transaction():
    led = Ledger()
    blk = _seal(Block, led.head, 3, 1, 2.5, "x")
    assert seal_info(blk) == (3, 1) and net.block_trust(blk) == 2.5
    assert seal_info(led.head) is None


# -- the ChainNode seams ---------------------------------------------------------


def _leader(**kw):
    from repro_torch.configs.base import FederationConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.node import ChainNode
    fed = FederationConfig(num_clusters=1, workers_per_cluster=3,
                           trust_threshold=0.3, merkle_chunk_size=2)
    node = ChainNode(pipeline_depth=2, device="cpu", **kw)
    node.create_task("t", get_config("paper-net"), fed,
                     TrainConfig(lr=0.01, momentum=0.5, optimizer="sgd"),
                     seed=0)
    return node


def test_seal_listener_feeds_a_follower_replica():
    from repro_torch.core.node import ChainNode
    from repro_torch.data.datasets import make_federated_mnist
    from repro_torch.serve import LightClient
    sealed = []
    leader = _leader()
    leader.add_seal_listener(lambda blk, commit: sealed.append((blk, commit)))
    ds = make_federated_mnist(3, samples=96, seed=0)
    for _ in range(3):
        leader.run_tick({"t": ds.round_batches(16)})
    leader.flush()
    # every block but genesis (the deploy rides in the first tick's block)
    assert [b.index for b, _ in sealed] == [1, 2, 3]
    assert all(c is not None for _, c in sealed)

    follower = ChainNode(pipeline_depth=0, device="cpu")
    n = follower.ingest_peer_blocks(
        [b for b, _ in sealed], commits={b.index: c for b, c in sealed})
    assert n == 3
    assert [b.hash for b in follower.ledger.blocks] \
        == [b.hash for b in leader.ledger.blocks]
    assert follower.ledger.verify_chain(deep=True)
    # light clients of either replica audit the same records
    from repro_torch.serve import ChainReadServer
    contract = leader.tasks["t"].contract
    lc_f = LightClient(ChainReadServer(ledger=follower.ledger,
                                       contracts={"t": contract}))
    lc_l = LightClient(leader.read_server())
    for lc in (lc_f, lc_l):
        lc.sync()
    for w in range(3):
        for r in range(3):
            assert lc_f.audit("t", w, round_index=r) \
                == lc_l.audit("t", w, round_index=r)
    bad, commit = sealed[-1]
    with pytest.raises(ValueError):
        follower.ingest_peer_blocks([bad], commits={bad.index: commit})
    leader.finalize()
    follower.close()
    with pytest.raises(RuntimeError):
        follower.ingest_peer_blocks([bad])


def test_seal_listener_exception_is_node_fatal():
    from repro_torch.data.datasets import make_federated_mnist

    def boom(blk, commit):
        raise OSError("broadcast failed")

    node = _leader()
    node.add_seal_listener(boom)
    ds = make_federated_mnist(3, samples=64, seed=1)
    node.run_tick({"t": ds.round_batches(16)})
    with pytest.raises(RuntimeError) as err:
        node.flush()
    assert isinstance(err.value.__cause__, OSError)
    node.close()
