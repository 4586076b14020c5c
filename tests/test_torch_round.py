"""The port's whole round against the JAX package's ``make_fl_round`` on the
paper CNN, W = 16 (4 clusters × 4 workers), per-worker batch 8, at
``rngs=None`` (no dropout: ``jax.random`` bits cannot be reproduced), in
four cases: fused path on and off, sync and async. The async case runs two
rounds, so the second consumes a nonzero pending buffer and staleness.

Both packages start from the same weights (the JAX init, converted) and
see the same batches and participation masks, made from a seed with
numpy. Tolerances, absolute, on the CPU in f32:

  scores, weights  1e-4  the statistics sum 21840 products in different
                         orders (K1's own tolerance is 1e-4 relative);
  global params    1e-5  lr·(gradient difference) plus one aggregate;
  losses           1e-5  two f32 forward passes of the same CNN;
  pending          1e-5  elementwise sums of deltas.

The settlement check feeds each package's scores to its own
``TrustContract`` and requires identical decisions: the bad-worker sets,
the penalties and the top-k payouts. The seeds are chosen so that no score
lies within the tolerance of the threshold T and no two workers' mean
scores straddle the top-k cut within it; the test asserts both margins.

The JAX round is imported through the ``jref`` fixture, the workaround for
fault F1 of the reference (ROADMAP.md, Queue 3): see
``tests/test_torch_model.py``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.chain.contract import TrustContract
from repro_torch.chain.ledger import Ledger
from repro_torch.configs.base import FederationConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import fl_step, hierarchy, trust
from repro_torch.data.datasets import synthetic_mnist
from repro_torch.kernels import pack
from repro_torch.models import api

jax.config.update("jax_enable_x64", False)

W, B, SEED = 16, 8, 0
SCORE_TOL, PARAM_TOL = 1e-4, 1e-5


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
    from repro.core import fl_step as jfl_step
    from repro.core import trust as jtrust
    from repro.kernels import pack as jpack
    from repro.models import api as japi
    return types.SimpleNamespace(
        fl_step=jfl_step, trust=jtrust, pack=jpack, api=japi,
        Contract=JContract, Ledger=JLedger, Fed=JFed, Train=JTrain,
        cfg=jget_config("paper-net"))


def _inputs(seed):
    imgs, labels = synthetic_mnist(W * B, seed=seed)
    images = imgs.reshape(W, 1, B, 28, 28, 1)
    labels = labels.reshape(W, 1, B)
    rng = np.random.default_rng(seed + 100)
    masks = [(rng.random(W) > 0.4).astype(np.int32) for _ in range(2)]
    for m in masks:
        m[0] = 1
    return images, labels, masks


def _fed_kwargs(fused, async_mode):
    return dict(num_clusters=4, workers_per_cluster=4, async_mode=async_mode,
                fused_trust_path="on" if fused else "off")


def _run_both(jref, fused, async_mode, seed=SEED):
    """One sync round or two async rounds in each package."""
    images, labels, masks = _inputs(seed)
    rounds = 2 if async_mode else 1
    jfed = jref.Fed(**_fed_kwargs(fused, async_mode))
    fed = FederationConfig(**_fed_kwargs(fused, async_mode))
    jtc, tc = jref.Train(), TrainConfig()

    jgp, _ = jref.api.init(jref.cfg, jax.random.PRNGKey(seed), tp=1)
    gp = convert.params_from_jax(jax.tree.map(np.asarray, jgp))
    jfn = jax.jit(jref.fl_step.make_fl_round(jref.cfg, jfed, jtc))
    fn = fl_step.make_fl_round(get_config("paper-net"), fed, tc,
                               device="cpu")
    jopt = jref.fl_step.init_worker_opt(jgp, jfed, jtc)
    opt = fl_step.init_worker_opt(gp, fed, tc)
    jb = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    tb = {"images": torch.from_numpy(images),
          "labels": torch.from_numpy(labels)}
    jstate = jref.fl_step.init_async_state_for(jref.cfg, jfed, jgp, W) \
        if async_mode else None
    state = fl_step.init_async_state_for(get_config("paper-net"), fed, gp, W) \
        if async_mode else None
    outs = []
    for r in range(rounds):
        if async_mode:
            jout, jstate = jfn(jgp, jopt, jb, None,
                               jnp.asarray(masks[r], jnp.float32), jstate)
            out, state = fn(gp, opt, tb, None, torch.from_numpy(masks[r]),
                            state)
        else:
            jout, out = jfn(jgp, jopt, jb, None, None), fn(gp, opt, tb)
        jgp, jopt, gp, opt = (jout.global_params, jout.opt_state,
                              out.global_params, out.opt_state)
        outs.append((jout, out, jstate, state))
    return outs, fed


@pytest.fixture(scope="module")
def runs(jref):
    """Each case's rounds, run once per module and shared by its tests."""
    cache = {}

    def get(fused, async_mode):
        if (fused, async_mode) not in cache:
            cache[fused, async_mode] = _run_both(jref, fused, async_mode)
        return cache[fused, async_mode]
    return get


def _pending_to_jax_layout(pending, gp, fused):
    """The port's pending buffer → per-worker nested numpy in JAX layout."""
    if fused:
        pending = pack.unpack_stack(pending, pack.pack_spec(gp))
    return [convert.params_to_jax({k: v[w] for k, v in pending.items()})
            for w in range(W)]


def _jax_pending(jstate, jgp, fused, jref):
    pend = jstate.pending
    if fused:
        spec = jref.pack.pack_spec(jgp)
        pend = jref.pack.unpack_stack(pend[:W, :spec.total], spec)
    return [jax.tree.map(lambda x: np.asarray(x[w]), pend) for w in range(W)]


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_leaf"])
def test_round_matches_jax(jref, runs, fused, async_mode):
    outs, fed = runs(fused, async_mode)
    for jout, out, jstate, state in outs:
        np.testing.assert_allclose(out.scores.numpy(),
                                   np.asarray(jout.scores), atol=SCORE_TOL)
        np.testing.assert_allclose(out.weights.numpy(),
                                   np.asarray(jout.weights), atol=SCORE_TOL)
        np.testing.assert_allclose(out.losses.numpy(),
                                   np.asarray(jout.losses), atol=PARAM_TOL)
        got = convert.params_to_jax(out.global_params)
        for a, b in zip(jax.tree.leaves(got),
                        jax.tree.leaves(jout.global_params)):
            np.testing.assert_allclose(a, np.asarray(b), atol=PARAM_TOL)
        if async_mode:
            np.testing.assert_array_equal(state.staleness.numpy(),
                                          np.asarray(jstate.staleness))
            if fused:
                assert state.pending.shape == (W, 21840)
            mine = _pending_to_jax_layout(state.pending, out.global_params,
                                          fused)
            theirs = _jax_pending(jstate, jout.global_params, fused, jref)
            for m, t in zip(mine, theirs):
                for a, b in zip(jax.tree.leaves(m), jax.tree.leaves(t)):
                    np.testing.assert_allclose(a, b, atol=PARAM_TOL)
    # round 2 of the async case really consumed a nonzero pending buffer
    if async_mode:
        first_state = outs[0][3]
        p = first_state.pending
        total = p.abs().sum() if fused else sum(v.abs().sum()
                                                for v in p.values())
        assert float(total) > 0


def _settle(Contract, LedgerCls, fed, rounds_scores):
    c = Contract(LedgerCls(), requester_deposit=fed.requester_deposit,
                 worker_stake=fed.worker_stake, penalty_pct=fed.penalty_pct,
                 trust_threshold=fed.trust_threshold,
                 top_k=fed.top_k_rewarded)
    c.join_batch(W)
    pens = [c.settle_round_batch(r, np.asarray(s, np.float64),
                                 timestamp=float(r + 1))
            for r, s in enumerate(rounds_scores)]
    return pens, c.finalize(timestamp=float(len(rounds_scores) + 1)), c


def _assert_same_decisions(jref, fed, jscores, scores):
    T = fed.trust_threshold
    for s in jscores:
        assert np.abs(np.asarray(s) - T).min() > SCORE_TOL, "seed too close"
    mean = np.mean(jscores, axis=0)
    k = fed.top_k_rewarded
    order = np.sort(mean)[::-1]
    assert order[k - 1] - order[k] > SCORE_TOL, "seed too close at top-k"
    jpens, jpay, jc = _settle(jref.Contract, jref.Ledger, fed, jscores)
    pens, pay, c = _settle(TrustContract, Ledger, fed, scores)
    for js, s, jp, p in zip(jscores, scores, jpens, pens):
        np.testing.assert_array_equal(np.asarray(js) < T, np.asarray(s) < T)
        np.testing.assert_array_equal(jp, p)
    assert jpay == pay
    assert abs(c.total_value() - (fed.requester_deposit
                                  + W * fed.worker_stake)) < 1e-6


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_leaf"])
def test_settlement_decisions_match_jax(jref, runs, fused, async_mode):
    outs, fed = runs(fused, async_mode)
    _assert_same_decisions(jref, fed,
                           [np.asarray(j.scores) for j, _, _, _ in outs],
                           [o.scores.numpy() for _, o, _, _ in outs])


def test_poisoned_worker_scored_lowest_and_filtered_on_both_sides(jref):
    """Real CNN deltas (one SGD step per worker on its own batch, in each
    package), worker 0 flipped to −3× its update: both packages score it
    lowest, zero its weight (the same filter on both sides), and settle it
    as a bad worker."""
    images, labels, _ = _inputs(SEED)
    cfg = get_config("paper-net")
    fed = FederationConfig(num_clusters=4, workers_per_cluster=4)
    lr = TrainConfig().lr

    jgp, _ = jref.api.init(jref.cfg, jax.random.PRNGKey(SEED), tp=1)
    jloss = jref.api.loss_fn(jref.cfg)
    jb = {"images": jnp.asarray(images[:, 0]),
          "labels": jnp.asarray(labels[:, 0])}
    (jl, _), jg = jax.vmap(jax.value_and_grad(jloss, has_aux=True),
                           in_axes=(None, 0))(jgp, jb)
    jspec = jref.pack.pack_spec(jgp)
    ju = jref.pack.pack_stack(jax.tree.map(lambda g: -lr * g, jg), jspec)
    ju = ju.at[0].multiply(-3.0)

    gp = convert.params_from_jax(jax.tree.map(np.asarray, jgp))
    pw = {k: v.detach().requires_grad_(True)
          for k, v in hierarchy.broadcast_to_workers(gp, W).items()}
    tl, _ = api.loss_fn(cfg)(pw, {"images": torch.from_numpy(images[:, 0]),
                                  "labels": torch.from_numpy(labels[:, 0])})
    tg = dict(zip(pw, torch.autograd.grad(tl.sum(), list(pw.values()))))
    tu = pack.pack_stack({k: -lr * g for k, g in tg.items()},
                         pack.pack_spec(gp)).detach()
    tu[0] *= -3.0

    # the attacker's loss got worse, everyone else's improved
    before = np.full(W, 2.0, np.float32)
    after = np.full(W, 1.5, np.float32)
    after[0] = 2.2
    js = jref.trust.scores_from_stats(jref.trust.update_stats_flat(
        ju, jnp.asarray(before), jnp.asarray(after)), fed)
    ts = trust.scores_from_stats(trust.update_stats_flat(
        tu, torch.from_numpy(before), torch.from_numpy(after)), fed)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=SCORE_TOL)
    for s in (np.asarray(js), ts.numpy()):
        assert s[0] == s.min() and (s[1:] > s[0]).all()
    jw = np.asarray(jref.trust.trust_weights(js, fed))
    tw = trust.trust_weights(ts, fed).numpy()
    assert jw[0] == tw[0] == 0.0
    np.testing.assert_array_equal(jw == 0, tw == 0)
    np.testing.assert_allclose(tw, jw, atol=SCORE_TOL)
    np.testing.assert_allclose(np.asarray(jl), tl.detach().numpy(),
                               atol=PARAM_TOL)
    _assert_same_decisions(jref, fed, [np.asarray(js)], [ts.numpy()])
