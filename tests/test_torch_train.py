"""Federated LLM training on the port against the JAX package, on the CPU:
``SDFLBProtocol`` over smollm-135m's smoke config (2 layers, d 288, V 512,
bf16) with 2 × 2 workers, AdamW (lr 3e-4, clip 1.0), two rounds in each
of four cases — sync and async (random participation, so round 2 folds
in a nonzero pending buffer), per-leaf trust statistics and the flat-pack
path (``fused_trust_path="on"``: K1's plain version over the packed (W, D)
bf16 matrix, then K2's or K3's). Then ``repro_torch.launch.train`` and
``repro_torch.examples.federated_llm`` run on the CPU.

Both packages start from the same weights (the JAX init, converted) and
see the same token batches (``synthetic_tokens``, numpy) and masks.
Tolerances (bf16 on the CPU; the two frameworks round products to bf16 at
other places, so a parameter can differ by a bf16 step):

  scores, weights  1e-3 absolute  a bf16 step in the post-step params moves
                                  a worker's loss by ~1e-4, and the loss
                                  term divides loss deltas by the best one
                                  (measured ≤ 1.6e-4)
  losses           2e-3 absolute  (measured ≤ 4.3e-4)
  global params    2^-7 · |p| + 6 · lr: two bf16 steps of the value, plus
                   the most two AdamW rounds can move an element apart
                   where a near-zero gradient takes the other sign in the
                   two frameworks (each worker's step is ~lr · sign(g));
                   at most 1 % of the elements beyond the two bf16 steps
                   (measured: ≤ 1.5e-3 = 4.9 lr, 0.3 % beyond)

The settlement check: each package's scores go to its own
``TrustContract`` (threshold T, top-2 rewarded), which must take identical
decisions (penalised workers, penalties, stakes, balances, payouts). T
splits the workers, and the test asserts that no score lies within the
tolerance of T and that the top-k cut has that margin too.

The JAX protocol is imported through the ``jref`` fixture, the workaround
for fault F1 of the reference (ROADMAP.md, Queue 3): see
``tests/test_torch_model.py``.
"""
import types

import jax
import numpy as np
import pytest

from repro_torch import convert
from repro_torch.configs.base import FederationConfig, TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import fl_step
from repro_torch.core.protocol import SDFLBProtocol
from repro_torch.data.datasets import synthetic_tokens

jax.config.update("jax_enable_x64", False)

ARCH, W, B, S, ROUNDS = "smollm-135m", 4, 2, 128, 2
SCORE_TOL, LOSS_TOL, PARAM_RTOL = 1e-3, 2e-3, 2.0 ** -7
T, TOP_K = 0.47, 2
MASKS = [np.array([1, 0, 1, 1], np.int32), np.array([0, 1, 1, 1], np.int32)]
TC = dict(optimizer="adamw", lr=3e-4, grad_clip=1.0, remat=False)


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
    from repro.configs.base import FederationConfig as JFed
    from repro.configs.base import TrainConfig as JTrain
    from repro.configs.registry import get_smoke_config as jsmoke
    from repro.core.protocol import SDFLBProtocol as JProtocol
    return types.SimpleNamespace(Protocol=JProtocol, Fed=JFed, Train=JTrain,
                                 cfg=jsmoke(ARCH))


def _fed_kw(fused, async_mode):
    return dict(num_clusters=2, workers_per_cluster=2, trust_threshold=T,
                top_k_rewarded=TOP_K, async_mode=async_mode,
                fused_trust_path="on" if fused else "off")


def _run_both(jref, fused, async_mode):
    jproto = jref.Protocol(jref.cfg, jref.Fed(**_fed_kw(fused, async_mode)),
                           jref.Train(**TC), use_blockchain=True, seed=0)
    fed, tc = FederationConfig(**_fed_kw(fused, async_mode)), TrainConfig(**TC)
    cfg = get_smoke_config(ARCH)
    proto = SDFLBProtocol(cfg, fed, tc, use_blockchain=True, seed=0,
                          device="cpu")
    task = proto.task
    task.global_params = convert.params_from_jax(jax.tree.map(
        np.asarray, jproto.global_params))
    task.opt_state = fl_step.init_worker_opt(task.global_params, fed, tc)
    if async_mode:
        task.async_state = fl_step.init_async_state_for(
            cfg, fed, task.global_params, W)
    recs = []
    for r in range(ROUNDS):
        data = synthetic_tokens(W, B, S, cfg.vocab_size, seed=r)
        part = MASKS[r] if async_mode else None
        recs.append((jproto.run_round(data, participation=part),
                     proto.run_round(data, participation=part)))
    jproto.flush()
    proto.flush()
    return jproto, proto, recs


@pytest.fixture(scope="module")
def runs(jref):
    """Each case's two protocols, run once per module; the ones no test
    finalized are finalized at the end (their settler threads stop)."""
    cache = {}

    def get(fused, async_mode):
        if (fused, async_mode) not in cache:
            cache[fused, async_mode] = _run_both(jref, fused, async_mode)
        return cache[fused, async_mode]
    yield get
    for jproto, proto, _ in cache.values():
        for p in (jproto, proto):
            if not p.node._closed:
                p.finalize()


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_leaf"])
def test_llm_protocol_matches_reference(runs, fused, async_mode):
    jproto, proto, recs = runs(fused, async_mode)
    for jrec, rec in recs:
        np.testing.assert_allclose(rec.scores, jrec.scores, rtol=0,
                                   atol=SCORE_TOL)
        np.testing.assert_allclose(rec.weights, jrec.weights, rtol=0,
                                   atol=SCORE_TOL)
        np.testing.assert_allclose(rec.losses, jrec.losses, rtol=0,
                                   atol=LOSS_TOL)
        assert np.isfinite(rec.losses).all()
        if async_mode:
            np.testing.assert_array_equal(rec.staleness, jrec.staleness)
            assert rec.weights[rec.participation == 0].sum() == 0
    got = convert.params_to_jax(proto.global_params)
    for a, b in zip(jax.tree.leaves(got),
                    jax.tree.leaves(jproto.global_params)):
        b = np.asarray(b, np.float32)
        d, steps = np.abs(a - b), PARAM_RTOL * np.abs(b)
        assert np.all(d <= steps + 6 * TC["lr"])
        assert np.mean(d > steps + 1e-6) <= 0.01
    if fused:
        assert proto.task.async_state is None or \
            proto.task.async_state.pending.shape == (W, sum(
                v.numel() for v in proto.global_params.values()))


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_leaf"])
def test_llm_settlement_decisions_match_reference(runs, fused, async_mode):
    jproto, proto, recs = runs(fused, async_mode)
    js = np.stack([j.scores for j, _ in recs])
    assert np.abs(js - T).min() > SCORE_TOL, "scores too close to T"
    assert (js < T).any() and (js > T).any()      # the decision is not moot
    mean = np.sort(js.mean(axis=0))[::-1]
    assert mean[TOP_K - 1] - mean[TOP_K] > SCORE_TOL, "too close at top-k"
    for j, r in recs:
        np.testing.assert_array_equal(j.scores < T, r.scores < T)
        np.testing.assert_array_equal(j.penalties, r.penalties)
    jc, c = jproto.contract, proto.contract
    np.testing.assert_array_equal(jc.stake, c.stake)
    np.testing.assert_array_equal(jc.balance, c.balance)
    assert jc.requester_balance == c.requester_balance
    assert proto.ledger.verify_chain(deep=True)


def test_llm_finalize_pays_the_same(runs):
    jproto, proto, _ = runs(False, False)
    assert proto.finalize() == jproto.finalize()


def test_train_launcher_runs_an_llm_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train --arch smollm-135m --device
    cpu``, cut to 2 rounds: its JSON lines, a verified ledger, value
    conserved; ``--async`` runs the arrival scheduler's cohorts."""
    from repro_torch.launch import train
    for extra in ([], ["--async"]):
        out = train.main(["--arch", "smollm-135m", "--rounds", "2",
                          "--device", "cpu", *extra])
        proto = out["proto"]
        assert [e["round"] for e in out["log"]] == [1, 2]
        assert all(np.isfinite(e["loss"]) and e["aux"] == 0.0
                   for e in out["log"])
        assert len(proto.history) == 2 and proto.cfg.num_layers == 2
        assert proto.ledger.verify_chain(deep=True)
        assert len(out["payouts"]) == 8
        if extra:
            assert all(r.participation is not None for r in proto.history)
    lines = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("ledger: 4 blocks, verified=True")
               for ln in lines) == 2


def test_federated_llm_example_on_the_cpu(capsys):
    from repro_torch.examples import federated_llm
    out = federated_llm.main(rounds=2, device="cpu")
    assert out["verified"] and out["blocks"] == 4
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("round 1: mean_loss=")
    assert lines[-1] == "ledger verified: True"
