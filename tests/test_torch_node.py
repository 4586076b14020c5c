"""The port's multi-task and sharded settlement (``repro_torch.core.node``:
``ChainNode``, ``settle_tasks_block``, ``TaskRoundWork``,
``ShardWorkerPool``) against the JAX package's ``repro.core.node``.

Node parity: two paper-CNN tasks share one node in each package — a sync
task (W = 8) and an async task (W = 6, random participation) — for three
ticks at different cadences, with ``settlement_shards`` 1 or 4 (4 with a
shard pool). Both start from the same weights (the JAX init, converted)
and run without dropout (``jax.random`` bits cannot be reproduced), and
two workers of each task flip their labels, so the trust scores separate.
Scores agree within 1e-4 absolute (K1's tolerance; the statistics sum
21840 products in other orders), and the test asserts that no score lies
within that of the threshold and no two workers straddle a top-k cut
within it. Then the decisions must be equal: penalties, stakes and
balances, requester balances and payouts exactly, and head elections for
the same chain randomness. Cids, and hence block hashes and the recorded
heads (drawn from block hashes), differ by design and are not compared.

The chain layer is a verbatim copy, so ``settle_tasks_block`` over the
same scores gives the same penalties and state in both packages; within
the port its blocks are also identical across shard counts and pools.

The JAX node is imported through the ``jref`` fixture, the workaround for
fault F1 of the reference (ROADMAP.md, Queue 3): see
``tests/test_torch_model.py``.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.chain.contract import RoundPrep, TrustContract
from repro_torch.chain.ledger import Ledger
from repro_torch.configs.base import FederationConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import fl_step
from repro_torch.core.node import (ChainNode, ShardWorkerPool, TaskRoundWork,
                                   _interleave_shard_thunks,
                                   settle_tasks_block)
from repro_torch.data.datasets import make_federated_mnist

SCORE_TOL = 1e-4
T = 0.45
TASKS = {
    "sync": dict(num_clusters=2, workers_per_cluster=4, top_k_rewarded=3,
                 merkle_chunk_size=2),
    "async": dict(num_clusters=2, workers_per_cluster=3, top_k_rewarded=2,
                  merkle_chunk_size=1, async_mode=True, staleness_alpha=0.5),
}
BAD = {"sync": (1, 6), "async": (0, 4)}
FIRES = [("async", "sync"), ("sync",), ("async", "sync")]   # three ticks


@pytest.fixture(scope="module")
def jref():
    from jax._src.interpreters import batching
    from jax._src.lax import lax as lax_internal
    proxy = batching.primitive_batchers
    batching.primitive_batchers = {lax_internal.optimization_barrier_p: None}
    try:
        import repro.models.sharding  # noqa: F401
    finally:
        batching.primitive_batchers = proxy
    from repro.chain.contract import TrustContract as JContract
    from repro.chain.ledger import Ledger as JLedger
    from repro.configs.base import FederationConfig as JFed
    from repro.configs.base import TrainConfig as JTrain
    from repro.configs.registry import get_config as jget_config
    from repro.core import node as jnode
    return types.SimpleNamespace(node=jnode, Contract=JContract,
                                 Ledger=JLedger, Fed=JFed, Train=JTrain,
                                 cfg=jget_config("paper-net"))


def _no_dropout(round_fn):
    """The round with ``rngs=None``: no dropout in either package."""
    def call(params, opt, batch, rng, *rest):
        return round_fn(params, opt, batch, None, *rest)
    return call


def _jflip(tid):
    def adv(batch, r):
        labels = batch["labels"]
        for w in BAD[tid]:
            labels = labels.at[w].set(9 - labels[w])
        return {**batch, "labels": labels}
    return adv


def _flip(tid):
    def adv(batch, r):
        labels = batch["labels"].clone()
        rows = list(BAD[tid])
        labels[rows] = 9 - labels[rows]
        return {**batch, "labels": labels}
    return adv


def _fed_kw(tid, shards):
    return dict(TASKS[tid], trust_threshold=T, settlement_shards=shards,
                task_id=tid)


def _inputs(seed=0):
    data = {tid: make_federated_mnist(
        kw["num_clusters"] * kw["workers_per_cluster"], samples=256,
        seed=seed + i) for i, (tid, kw) in enumerate(sorted(TASKS.items()))}
    rng = np.random.default_rng(seed + 50)
    ticks = []
    for fire in FIRES:
        batches = {tid: data[tid].round_batches(8) for tid in fire}
        mask = (rng.random(6) > 0.3).astype(np.int32)
        mask[0] = 1
        ticks.append((batches, {"async": mask} if "async" in fire else None))
    return ticks


def _drive(node, ticks):
    for batches, part in ticks:
        node.run_tick(batches, participation=part)
    node.flush()
    return node


def _reference_node(jref, shards):
    node = jref.node.ChainNode(pipeline_depth=2,
                               settler_pool_size=2 if shards > 1 else 0)
    tc = jref.Train()
    for i, tid in enumerate(sorted(TASKS)):
        task = node.create_task(tid, jref.cfg, jref.Fed(**_fed_kw(tid,
                                                                   shards)),
                                tc, seed=i, adversary=_jflip(tid))
        task._round_fn = _no_dropout(task._round_fn)
        if shards > 1:
            task.contract.min_parallel_leaf_bytes = 1
    return node


def _port_node(jnode, shards):
    """The port's node, its tasks started from the reference tasks'
    weights."""
    node = ChainNode(pipeline_depth=2, device="cpu",
                     settler_pool_size=2 if shards > 1 else 0)
    tc = TrainConfig()
    for i, tid in enumerate(sorted(TASKS)):
        fed = FederationConfig(**_fed_kw(tid, shards))
        task = node.create_task(tid, get_config("paper-net"), fed, tc,
                                seed=i, adversary=_flip(tid))
        gp = convert.params_from_jax(jax.tree.map(
            np.asarray, jnode.tasks[tid].global_params))
        task.global_params = gp
        task.opt_state = fl_step.init_worker_opt(gp, fed, tc)
        if fed.async_mode:
            task.async_state = fl_step.init_async_state_for(
                task.cfg, fed, gp, task.W)
        task._round_fn = _no_dropout(task._round_fn)
        if shards > 1:
            task.contract.min_parallel_leaf_bytes = 1
    return node


def _elections(task, rounds):
    """Heads the task elects for fixed chain randomness, by head rotation
    and by reputation."""
    out = []
    for leaders in (False, True):
        task.reputation_leaders = leaders
        out.append([task._rotate_heads(r, f"{r:064x}") for r in range(rounds)])
    task.reputation_leaders = False
    return out


def _decisions(node):
    out = {}
    for tid, task in sorted(node.tasks.items()):
        c = task.contract
        out[tid] = {"penalties": [r.penalties.tolist() for r in task.history],
                    "stake": c.stake.tolist(), "balance": c.balance.tolist(),
                    "penalized": c.penalized_rounds.tolist(),
                    "requester": c.requester_balance,
                    "elections": _elections(task, len(task.history)),
                    "reputation_penalties": task.reputation.penalties.tolist()}
    out["blocks"] = len(node.ledger.blocks)
    out["task_roots"] = [sorted(b.task_roots) if b.task_roots else None
                         for b in node.ledger.blocks]
    return out


def _scores(node):
    return {tid: np.stack([r.scores for r in t.history])
            for tid, t in sorted(node.tasks.items())}


def _check_margins(scores, node):
    for tid, s in scores.items():
        assert np.abs(s - T).min() > SCORE_TOL, tid
        k = node.tasks[tid].fed.top_k_rewarded
        mean = np.sort(s.mean(axis=0))[::-1]
        assert mean[k - 1] - mean[k] > SCORE_TOL, tid


@pytest.mark.parametrize("shards", [1, 4])
def test_multi_task_node_decisions_match_reference(jref, shards):
    ticks = _inputs()
    jnode = _reference_node(jref, shards)
    node = _port_node(jnode, shards)
    assert (jnode._shard_pool is not None) == (shards > 1)
    assert (node._shard_pool is not None) == (shards > 1)
    _drive(jnode, ticks)
    _drive(node, ticks)
    got, want = _scores(node), _scores(jnode)
    for tid in want:
        np.testing.assert_allclose(got[tid], want[tid], rtol=0,
                                   atol=SCORE_TOL)
        # workers on both sides of T: the decisions are not trivial
        assert (got[tid] < T).any() and (got[tid] > T).any()
    _check_margins(want, jnode)
    assert _decisions(node) == _decisions(jnode)
    for a, b in zip(node.tasks.values(), jnode.tasks.values()):
        np.testing.assert_allclose(a.contract.score_sum, b.contract.score_sum,
                                   rtol=0, atol=len(FIRES) * SCORE_TOL)
        assert [r.staleness is None for r in a.history] \
            == [r.staleness is None for r in b.history]
    assert node.ledger.verify_chain(deep=True)
    assert node.finalize() == jnode.finalize()


def test_node_chain_is_shard_count_independent():
    """The port's node seals the same blocks with 1 shard inline and with
    4 shards through the shard pool (shard bounds are Merkle-subtree
    aligned), run to run."""
    ticks = _inputs(seed=3)
    chains = []
    for shards in (1, 4, 4):
        node = ChainNode(pipeline_depth=2, device="cpu",
                         settler_pool_size=2 if shards > 1 else 0)
        for i, tid in enumerate(sorted(TASKS)):
            task = node.create_task(
                tid, get_config("paper-net"),
                FederationConfig(**_fed_kw(tid, shards)), TrainConfig(),
                seed=i)
            task.contract.min_parallel_leaf_bytes = 1
        assert (node._shard_pool is not None) == (shards > 1)
        _drive(node, ticks)
        chains.append([b.hash for b in node.ledger.blocks])
        assert node.ledger.verify_chain(deep=True)
        node.finalize()
    assert chains[0] == chains[1] == chains[2]


# -- the settlement layer --------------------------------------------------------


def _contract(contract_cls, led, tid, W, chunk=3, shards=1):
    c = contract_cls(led, requester_deposit=1e4, worker_stake=10.0,
                     penalty_pct=50.0, trust_threshold=0.5, top_k=5,
                     merkle_chunk_size=chunk, settlement_shards=shards,
                     task_id=tid)
    c.join_batch(W)
    return c


def _settle_tasks(mod, contract_cls, ledger_cls, N, shards, pool=None,
                  sparse_cohort=False):
    rng = np.random.default_rng(7)
    led = ledger_cls()
    tids = [f"task-{i}" for i in range(N)]
    cs = {tid: _contract(contract_cls, led, tid, 20 + 7 * i, 1 + i % 3,
                         shards)
          for i, tid in enumerate(tids)}
    pens = []
    for r in range(3):
        work = []
        for tid, c in cs.items():
            W = c.num_workers
            ids = np.sort(rng.choice(W, W // 2, replace=False)) \
                if sparse_cohort else None
            n = W if ids is None else len(ids)
            work.append(mod.TaskRoundWork(
                tid, c, r, rng.random(n), f"cid-{tid}-{r}", worker_ids=ids,
                staleness=rng.integers(0, 3, n) if sparse_cohort else None))
        _, p, errors = mod.settle_tasks_block(led, work[::-1],
                                              timestamp=float(r + 1),
                                              pool=pool)
        assert not errors
        pens.append({t: v.tolist() for t, v in sorted(p.items())})
    assert led.verify_chain(deep=True)
    state = {tid: (c.stake.tolist(), c.penalized_rounds.tolist(),
                   c.requester_balance,
                   c.settlement_proof(2, int(c._round_ids[2][-1]))["record"])
             for tid, c in cs.items()}
    return pens, state, led


@pytest.mark.parametrize("N,shards,sparse", [(1, 1, False), (2, 2, False),
                                             (3, 4, False), (2, 1, True)])
def test_settle_tasks_block_matches_reference(jref, N, shards, sparse):
    import repro_torch.core.node as node_mod
    got = _settle_tasks(node_mod, TrustContract, Ledger, N, shards,
                        sparse_cohort=sparse)
    want = _settle_tasks(jref.node, jref.Contract, jref.Ledger, N, shards,
                         sparse_cohort=sparse)
    assert got[:2] == want[:2]
    blocks = got[2].blocks
    if N > 1:
        assert all(set(b.task_roots) == {f"task-{i}" for i in range(N)}
                   for b in blocks[-3:])
    # the port's blocks: the same through a shard pool
    pool = ShardWorkerPool(2)
    try:
        pooled = _settle_tasks(node_mod, TrustContract, Ledger, N, shards,
                               pool=pool, sparse_cohort=sparse)
    finally:
        pool.stop()
    assert [b.hash for b in pooled[2].blocks] == [b.hash for b in blocks]


def test_settle_tasks_block_rejects_duplicate_task_ids(jref):
    for mod, contract_cls, ledger_cls in (
            (jref.node, jref.Contract, jref.Ledger),
            (__import__("repro_torch.core.node", fromlist=["x"]),
             TrustContract, Ledger)):
        led = ledger_cls()
        c = _contract(contract_cls, led, "t", 4)
        w = mod.TaskRoundWork("t", c, 0, np.zeros(4))
        with pytest.raises(ValueError, match="duplicate"):
            mod.settle_tasks_block(led, [w, w], timestamp=1.0)
        assert len(led.blocks) == 1 and c.pending


def test_task_round_work_defaults():
    c = _contract(TrustContract, Ledger(), "t", 4)
    w = TaskRoundWork("t", c, 2, np.ones(4))
    assert (w.model_cid, w.worker_ids, w.staleness) == ("", None, None)
    assert dataclasses.replace(w, round_index=3).round_index == 3


@pytest.mark.parametrize("threads", [1, 3])
def test_shard_worker_pool_order_and_deterministic_raise(jref, threads):
    def boom(i):
        raise ValueError(f"shard {i} died")

    seen = []
    for pool in (ShardWorkerPool(threads), jref.node.ShardWorkerPool(threads)):
        try:
            out = [pool.map([lambda i=i: i * i for i in range(10)]),
                   pool.map([])]
            with pytest.raises(ValueError, match="shard 2 died"):
                pool.map([lambda: 0, lambda: 1, lambda: boom(2),
                          lambda: boom(5)])
            got = pool.map_collect([lambda: 7, lambda: boom(1)])
            out.append([(k, v if k == "ok" else str(v)) for k, v in got])
            out.append(pool.map([lambda: "ok"]))
        finally:
            pool.stop()
        with pytest.raises(RuntimeError):
            pool.map([lambda: 1])
        pool.stop()
        seen.append(out)
    assert seen[0] == seen[1]
    assert seen[0][0] == [i * i for i in range(10)]


def test_shard_thunks_interleave_round_robin(jref):
    from repro.chain.contract import RoundPrep as JPrep
    order = []
    for prep_cls, fn in ((RoundPrep, _interleave_shard_thunks),
                         (JPrep, jref.node._interleave_shard_thunks)):
        ids = np.arange(1)
        preps = {t: prep_cls(0, ids, ids.astype(float),
                             [f"{t}{i}" for i in range(n)])
                 for t, n in (("a", 3), ("b", 1), ("c", 2))}
        order.append([(t, i, th) for t, i, th in fn(["a", "b", "c"], preps)])
    assert order[0] == order[1] == [
        ("a", 0, "a0"), ("b", 0, "b0"), ("c", 0, "c0"), ("a", 1, "a1"),
        ("c", 1, "c1"), ("a", 2, "a2")]


def test_failing_task_is_isolated_in_its_block():
    """A task whose round fails validation is left out of the block with
    nothing applied; its co-tenant settles."""
    led = Ledger()
    a = _contract(TrustContract, led, "a", 6)
    b = _contract(TrustContract, led, "b", 4)
    blk, pens, errors = settle_tasks_block(
        led, [TaskRoundWork("a", a, 0, np.full(6, 0.9)),
              TaskRoundWork("b", b, 0, np.full(3, 0.9))], timestamp=1.0)
    assert set(errors) == {"b"} and set(pens) == {"a"}
    assert blk is not None and 0 in a._round_blocks
    assert 0 not in b._round_blocks
    assert led.verify_chain(deep=True)
    torch.testing.assert_close(torch.from_numpy(b.stake),
                               torch.full((4,), 10.0, dtype=torch.float64))


def test_finished_protocol_waits_for_the_cycle_collector_in_both_packages(
        jref):
    """What earlier phases of ``chip_smoke.py`` leave on the card (the
    garbage lead of ROADMAP.md's Queue 3): a finished ``SDFLBProtocol``
    outlives its last reference until ``gc.collect()`` runs, in the port
    and in the reference alike, since a node holds its tasks and each task
    its node (``src/repro/core/node.py:681`` and ``:1015``). So it is the
    reference's own cycle, not a fault of the port; ``chip_smoke.py``'s
    ``_release`` collects it before a phase that needs the card."""
    import gc
    import weakref
    from repro.core.protocol import SDFLBProtocol as JProtocol
    from repro_torch.core.protocol import SDFLBProtocol
    data = make_federated_mnist(16, samples=256, seed=0)
    cases = [(SDFLBProtocol, FederationConfig(), TrainConfig(),
              get_config("paper-net"), {"device": "cpu"}),
             (JProtocol, jref.Fed(), jref.Train(), jref.cfg, {})]
    gc.collect()
    gc.disable()
    try:
        for protocol, fed, tc, cfg, kw in cases:
            proto = protocol(cfg, fed, tc, seed=0, **kw)
            proto.run_round(data.round_batches(8))
            proto.finalize()
            node, params = weakref.ref(proto.node), \
                weakref.ref(jax.tree.leaves(proto.global_params)[0])
            del proto
            assert node() is not None and params() is not None, protocol
            gc.collect()
            assert node() is None and params() is None, protocol
    finally:
        gc.enable()
