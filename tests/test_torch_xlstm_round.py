"""xLSTM's federated round on the port against the JAX package, on the
CPU: a 2 × 2 ``SDFLBProtocol`` over xlstm-1.3b's smoke config in both
packages (sync and async, per-leaf trust statistics, the chain on), in f32
and in the config's bf16: scores, weights, losses, global params and the
settlement decisions. ``tests/test_torch_xlstm_train.py`` holds the loss,
the gradients and the sLSTM scan's VJP.

Config: xlstm-1.3b's smoke config (one super-layer of one mLSTM and one
sLSTM block; d 256, 4 heads, mLSTM heads of dh 128 with chunk 64, V 512);
W = 4 in 2 clusters, batch 2, seq 128 (two mLSTM chunks), two rounds of
AdamW lr 3e-4, clip 1.0. Both packages start from the JAX init. The JAX
package is imported through the ``jref`` fixture, the workaround for fault
F1 of the reference (ROADMAP.md, Queue 3; see ``tests/test_torch_llm.py``).

Tolerances (the losses are each worker's loss after its step):

  f32    scores, weights and losses 1e-5 (measured ≤ 4.8e-7, 6.0e-8 and
         1.9e-6), params 0.1 · lr (measured ≤ 0.053 lr), as the MoE
         protocol's (``tests/test_torch_moe.py``)
  bf16   scores and weights 2e-3 (measured ≤ 1.4e-3 and 2.5e-4), losses
         1e-2 (measured ≤ 5.4e-3), as the hybrid's
         (``tests/test_torch_hybrid_train.py``). Params: the sLSTM's VJP
         moves some 20 times what its input moves, and bf16 rounding alone
         moves that input by ~1 % of its largest value between the packages
         (``tests/test_torch_xlstm_train.py``), so a small gradient's sign
         follows the rounding, and AdamW steps each element by ~lr · sign(g) a
         round, two steps in a round where async folds a late worker's
         pending update in. So every bf16 element within two bf16 steps
         plus 8 · lr (measured ≤ 6.2 lr beyond the steps, async) and at
         most 5 % of a leaf's elements beyond the two steps (measured
         ≤ 3.2 %, sLSTM's w_gates, async); the f32 leaves (mLSTM's w_i,
         w_f, f_bias and sLSTM's b_gates) within 4 · lr (measured ≤ 3.4
         lr)

The settlement check, as in ``tests/test_torch_train.py``: each package's
scores go to its own ``TrustContract`` (threshold T, top-2 rewarded), which
must take identical decisions; T splits the workers with a margin in both
dtypes.
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import FederationConfig, TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import fl_step
from repro_torch.core.protocol import SDFLBProtocol
from repro_torch.data.datasets import synthetic_tokens

jax.config.update("jax_enable_x64", False)

ARCH, W, B, S, ROUNDS = "xlstm-1.3b", 4, 2, 128, 2
PROTO_F32_TOL = 1e-5
SCORE_TOL, PROTO_LOSS_TOL, PARAM_RTOL = 2e-3, 1e-2, 2.0 ** -7
T, TOP_K = 0.5, 2
MASKS = [np.array([1, 0, 1, 1], np.int32), np.array([0, 1, 1, 1], np.int32)]
TC = dict(optimizer="adamw", lr=3e-4, grad_clip=1.0, remat=False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the sLSTM scan is a loop
    of small ops, and parallel test workers that each spin a pool of
    threads for them slow one another by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    return types.SimpleNamespace(smoke=jsmoke, Protocol=JProtocol, Fed=JFed,
                                 Train=JTrain)


def _fed_kw(async_mode):
    return dict(num_clusters=2, workers_per_cluster=2, trust_threshold=T,
                top_k_rewarded=TOP_K, async_mode=async_mode,
                fused_trust_path="off")


def _run_both(jref, dtype, async_mode):
    jproto = jref.Protocol(jref.smoke(ARCH).replace(dtype=dtype),
                           jref.Fed(**_fed_kw(async_mode)),
                           jref.Train(**TC), use_blockchain=True, seed=0)
    fed, tc = FederationConfig(**_fed_kw(async_mode)), TrainConfig(**TC)
    cfg = get_smoke_config(ARCH).replace(dtype=dtype)
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

    def get(dtype, async_mode):
        if (dtype, async_mode) not in cache:
            cache[dtype, async_mode] = _run_both(jref, dtype, async_mode)
        return cache[dtype, async_mode]
    yield get
    for jproto, proto, _ in cache.values():
        for p in (jproto, proto):
            if not p.node._closed:
                p.finalize()


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_protocol_matches_reference(runs, dtype, async_mode):
    jproto, proto, recs = runs(dtype, async_mode)
    f32_run = dtype == "float32"
    score_tol = PROTO_F32_TOL if f32_run else SCORE_TOL
    loss_tol = PROTO_F32_TOL if f32_run else PROTO_LOSS_TOL
    for jrec, rec in recs:
        np.testing.assert_allclose(rec.scores, jrec.scores, rtol=0,
                                   atol=score_tol)
        np.testing.assert_allclose(rec.weights, jrec.weights, rtol=0,
                                   atol=score_tol)
        np.testing.assert_allclose(rec.losses, jrec.losses, rtol=0,
                                   atol=loss_tol)
        assert np.isfinite(rec.losses).all()
        if async_mode:
            np.testing.assert_array_equal(rec.staleness, jrec.staleness)
            assert rec.weights[rec.participation == 0].sum() == 0
    got = convert.params_to_jax(proto.global_params)
    for a, b in zip(jax.tree.leaves(got),
                    jax.tree.leaves(jproto.global_params)):
        f32 = b.dtype == np.float32
        b = np.asarray(b, np.float32)
        d = np.abs(a - b)
        if f32_run:
            assert np.all(d <= 0.1 * TC["lr"])
        elif f32:
            assert np.all(d <= 4 * TC["lr"])
        else:
            steps = PARAM_RTOL * np.abs(b)
            assert np.all(d <= steps + 8 * TC["lr"])
            assert np.mean(d > steps + 1e-6) <= 0.05


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_settlement_decisions_match_reference(runs, dtype, async_mode):
    jproto, proto, recs = runs(dtype, async_mode)
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


def test_xlstm_finalize_pays_the_same(runs):
    jproto, proto, _ = runs("bfloat16", False)
    assert proto.finalize() == jproto.finalize()


