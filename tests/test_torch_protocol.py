"""The port's protocol end to end on the CPU (``device="cpu"``): the paper
CNN at W = 16 (4 × 4), per-worker batch 8, sync and async rounds with
participation masks settling on the port's own ledger and contract, then
``finalize()`` paying out."""
import numpy as np
import pytest
import torch

from repro_torch.chain.ipfs import IPFSStore
from repro_torch.chain.ledger import Ledger
from repro_torch.configs.base import FederationConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.async_sim import heterogeneous_profiles
from repro_torch.core.gossip import ClusterExchange
from repro_torch.core.protocol import SDFLBProtocol
from repro_torch.data.datasets import make_federated_mnist

W, B, ROUNDS = 16, 8, 3


def _run(async_mode, seed=0):
    fed = FederationConfig(async_mode=async_mode)
    proto = SDFLBProtocol(get_config("paper-net"), fed, TrainConfig(),
                          seed=seed, device="cpu")
    data = make_federated_mnist(W, samples=512, seed=seed)
    rng = np.random.default_rng(seed + 1)
    recs = []
    for _ in range(ROUNDS):
        part = None
        if async_mode:
            part = (rng.random(W) > 0.4).astype(np.int32)
            part[0] = 1
        recs.append(proto.run_round(data.round_batches(B),
                                    participation=part))
    payouts = proto.finalize()
    return proto, recs, payouts, fed, data


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
def test_protocol_rounds_settle_and_pay_out(async_mode):
    proto, recs, payouts, fed, data = _run(async_mode)
    assert len(recs) == ROUNDS and all(r.settled for r in recs)
    for r in recs:
        assert r.scores.shape == (W,) and np.isfinite(r.scores).all()
        assert r.model_cid and proto.ipfs.has(r.model_cid)
        assert r.penalties.shape == (W,)
        # only bad workers pay; a stake already spent caps the penalty at 0
        assert not r.penalties[r.scores >= fed.trust_threshold].any()
        if async_mode:
            assert r.staleness is not None
            assert r.weights[r.participation == 0].sum() == 0
    # every stake is whole in round 0, so there each bad worker pays
    np.testing.assert_array_equal(recs[0].penalties > 0,
                                  recs[0].scores < fed.trust_threshold)
    assert proto.ledger.verify_chain(deep=True)
    # genesis + one block per round + the finalize block
    assert len(proto.ledger.blocks) == ROUNDS + 2
    assert len(payouts) == W
    total = fed.requester_deposit + W * fed.worker_stake
    assert abs(proto.contract.total_value() - total) < 1e-6
    # what the workers are paid out and what the requester holds is all
    # there was: deposit plus stakes
    assert abs(sum(payouts.values()) + proto.contract.requester_balance
               - total) < 1e-6
    acc = proto.evaluate(data.eval_batch(64))
    assert 0.0 <= acc["accuracy"] <= 1.0 and np.isfinite(acc["loss"])
    per_worker = proto.evaluate_per_worker(data.round_batches(4))
    assert per_worker["accuracy"].shape == (W,)


def test_same_seed_runs_give_identical_block_hashes():
    a = _run(False, seed=3)[0]
    b = _run(False, seed=3)[0]
    c = _run(False, seed=4)[0]
    ha = [blk.hash for blk in a.ledger.blocks]
    assert ha == [blk.hash for blk in b.ledger.blocks]
    assert ha[1:] != [blk.hash for blk in c.ledger.blocks][1:]


def test_cluster_exchange_fetch_merge_and_ingest():
    """Heads publish aggregates to IPFS; a peer fetches them back exactly
    (keys, shapes, dtypes, bf16 included), merges them by trust, and a
    second node ingests a shipped blob only under its own content hash."""
    gen = torch.Generator().manual_seed(0)
    aggs = [{"fc.w": torch.randn((2, 3), generator=gen).bfloat16(),
             "conv.b": torch.randn((4,), generator=gen)} for _ in range(3)]
    ex = ClusterExchange(IPFSStore(), Ledger(), num_clusters=3)
    cids = [ex.publish(0, c, a) for c, a in enumerate(aggs)]
    assert len(set(cids)) == 3
    assert [tx["cid"] for tx in ex.round_transactions(0)] == cids
    for c, a in enumerate(aggs):
        got = ex.fetch(0, c, aggs[0])
        assert sorted(got) == sorted(a)
        for k in a:
            assert got[k].dtype == a[k].dtype and torch.equal(got[k], a[k])

    merged = ex.merge(0, 0, aggs[0], peer_trust=[0.0, 0.6, 0.2])
    for k in aggs[0]:
        want = (0.5 * aggs[0][k].float() + 0.375 * aggs[1][k].float()
                + 0.125 * aggs[2][k].float()).to(aggs[0][k].dtype)
        torch.testing.assert_close(merged[k], want, rtol=0, atol=0)

    peer = ClusterExchange(IPFSStore(), Ledger(), num_clusters=3)
    cid, blob = ex.blob(0, 1)
    with pytest.raises(ValueError):
        peer.ingest(0, 1, cid, blob[:-1] + bytes([blob[-1] ^ 1]))
    peer.ingest(0, 1, cid, blob)
    got = peer.fetch(0, 1, aggs[0])
    assert all(torch.equal(got[k], aggs[1][k]) for k in aggs[1])


def test_event_driven_rounds_seal_arrived_cohorts():
    """``run_events`` on the port: each event trains and seals the arrived
    cohort, with its pre-round staleness on the record and zero weight for
    workers that did not arrive."""
    fed = FederationConfig(async_mode=True, buffer_size=6)
    proto = SDFLBProtocol(get_config("paper-net"), fed, TrainConfig(),
                          device="cpu",
                          arrival_profiles=heterogeneous_profiles(W))
    data = make_federated_mnist(W, samples=256, seed=0)
    recs = proto.run_events(lambda r: data.round_batches(B), events=3)
    proto.finalize()
    assert len(recs) == 3 and all(r.settled for r in recs)
    for r in recs:
        cohort = r.participation > 0
        assert 0 < cohort.sum() <= W and r.sim_time > 0
        assert r.staleness.shape == (W,)
        assert r.weights[~cohort].sum() == 0
    assert recs[1].sim_time >= recs[0].sim_time
    assert proto.ledger.verify_chain(deep=True)
