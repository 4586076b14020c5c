"""zamba2 federation on the port against the JAX package, on the CPU: the
hybrid's causal-LM loss and gradients (with and without rematerialisation
of each super-layer), the AdamW state of its tree carried across by
``convert``, a 2 × 2 ``SDFLBProtocol`` over zamba2's smoke config in both
packages (sync and async, per-leaf trust statistics, the chain on), and
``repro_torch.launch.train --arch zamba2-7b`` and ``federated_llm`` on the
CPU.

Configs: zamba2-7b's smoke config (2 Mamba2 layers in one super-layer with
the shared block, no tail; d 256, SSD state 16, chunk 64, V 512, bf16) and
a 3-layer variant with one tail layer. Weights are the JAX init, converted;
tokens come from numpy. On the CPU the Mamba2 layers run K4's plain
forward and its plain backward through ``ssd_scan``'s ``autograd.Function``
(``tests/test_torch_ssd_bwd.py`` holds those to ``jax.vjp``). The JAX
package is imported through the ``jref`` fixture, the workaround for fault
F1 of the reference (ROADMAP.md, Queue 3; see ``tests/test_torch_llm.py``).

Tolerances, each against the reference's value:

  f32 loss         2e-5 absolute   (measured ≤ 9.6e-7)
  f32 gradients    1e-4 · max|g|   per leaf: the SSD backward's own bound
                                   (``ssd_scan.BWD_ATOL_REL``); A_log's
                                   gradient, a sum over every position of
                                   the gate path, measured ≤ 4.7e-5
  bf16 loss        2e-3 absolute   (measured ≤ 6.6e-4)
  bf16 gradients   (5e-2 + the reference's own bf16-vs-f32 gap on the
                   leaf) · max|g|: the dense decoders' 5e-2, widened by
                   what bf16 alone moves the leaf in the reference, which
                   reaches 7.9e-2 on the tail's A_log (the port's gap to
                   the reference there measured 8.7e-2)

The protocol (bf16, two rounds of AdamW lr 3e-4, clip 1.0; the losses are
each worker's loss after its step):

  scores, weights  2e-3 absolute  (measured ≤ 8.6e-4)
  losses           1e-2 absolute  (measured ≤ 5.5e-3: after a step whose
                                  bf16 params differ by a bf16 step)
  global params    2^-7 · |p| + 6 · lr everywhere, as for the dense
                   decoders; at most 3 % of a bf16 leaf's elements beyond
                   the two bf16 steps (measured ≤ 1.8 %, async); the f32
                   gate leaves (A_log, dt_bias, D, a few per layer, each
                   moved ~lr a round) within 2 · lr (measured ≤ 0.65 lr)

The settlement check, as in ``tests/test_torch_train.py``: each package's
scores go to its own ``TrustContract`` (threshold T, top-2 rewarded), which
must take identical decisions; T splits the workers with a margin.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import FederationConfig, TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import fl_step
from repro_torch.core.protocol import SDFLBProtocol
from repro_torch.data.datasets import synthetic_tokens
from repro_torch.kernels import ssd_scan
from repro_torch.models import api
from repro_torch.optim import optimizers

jax.config.update("jax_enable_x64", False)

ARCH, W, B, S, ROUNDS = "zamba2-7b", 4, 2, 128, 2
LOSS_TOL = {"float32": 2e-5, "bfloat16": 2e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
SCORE_TOL, PROTO_LOSS_TOL, PARAM_RTOL = 2e-3, 1e-2, 2.0 ** -7
T, TOP_K = 0.48, 2
MASKS = [np.array([1, 0, 1, 1], np.int32), np.array([0, 1, 1, 1], np.int32)]
TC = dict(optimizer="adamw", lr=3e-4, grad_clip=1.0, remat=False)
KV_CHUNK = 256


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
    from repro.models import api as japi
    from repro.optim import optimizers as jopt
    return types.SimpleNamespace(api=japi, opt=jopt, smoke=jsmoke,
                                 Protocol=JProtocol, Fed=JFed, Train=JTrain)


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _batch(cfg, seed):
    """Tokens and labels (B, S) int32, the last 5 labels of each row
    masked (-100)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = toks.copy()
    labels[:, -5:] = -100
    return toks, labels


# (dtype, num_layers, remat, seed): the smoke config and the 3-layer one
# with a tail layer, remat on and off
LOSS_CASES = [("float32", 2, False, 1), ("float32", 3, True, 4),
              ("bfloat16", 2, True, 1), ("bfloat16", 3, False, 3)]


@pytest.mark.parametrize("dtype,num_layers,remat,seed", LOSS_CASES,
                         ids=[f"{d}-L{n}-{'remat' if r else 'plain'}"
                              for d, n, r, _ in LOSS_CASES])
def test_hybrid_loss_and_grads_match_reference(jref, dtype, num_layers,
                                               remat, seed):
    jcfg = jref.smoke(ARCH).replace(dtype=dtype, num_layers=num_layers)
    cfg = get_smoke_config(ARCH).replace(dtype=dtype, num_layers=num_layers)
    jp, _ = jref.api.init(jcfg, jax.random.PRNGKey(seed), tp=1)
    p = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    toks, labels = _batch(cfg, S)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    grad = jax.value_and_grad(jref.api.loss_fn(jcfg, kv_chunk=KV_CHUNK),
                              has_aux=True)
    (jl, _), jg = grad(jp, jb)

    pr = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    loss, m = api.lm_loss_fn(cfg, remat=remat, kv_chunk=KV_CHUNK)(pr, batch)
    g = dict(zip(pr, torch.autograd.grad(loss, list(pr.values()))))
    loss = loss.detach()
    assert loss.dtype == torch.float32 and float(m["aux"]) == 0.0
    assert abs(float(loss) - float(jl)) <= LOSS_TOL[dtype]
    got = convert.params_to_jax(g)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, jg))
    gap = [0.0] * len(_leaves(jg))
    if dtype == "bfloat16":
        # what bf16 alone moves each gradient in the reference: the same
        # weights in f32
        j32 = jcfg.replace(dtype="float32")
        (_, _), jg32 = jax.value_and_grad(
            jref.api.loss_fn(j32, kv_chunk=KV_CHUNK), has_aux=True)(
            jax.tree.map(lambda x: x.astype(jnp.float32), jp), jb)
        gap = [np.abs(a - b).max() / np.abs(b).max()
               for a, b in zip(_leaves(jg), _leaves(jg32))]
    for a, b, extra in zip(_leaves(got), _leaves(jg), gap):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= (GRAD_TOL[dtype] + extra) * \
            np.abs(b).max()


def test_remat_runs_the_scan_again_for_its_saved_states():
    """With ``remat`` each super-layer's forward (K4's plain version on the
    CPU, states kept for the backward) runs twice a Mamba2 layer: in the
    forward and again when backward recomputes it; without, once. The
    gradients agree bit for bit."""
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    p = api.init(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    toks, labels = _batch(cfg, 7)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    calls = []
    orig = ssd_scan.ssd_scan_ref

    def spy(*a, **kw):
        calls.append(kw.get("return_states", False))
        return orig(*a, **kw)
    grads = {}
    ssd_scan.ssd_scan_ref = spy
    try:
        for remat in (False, True):
            calls.clear()
            pr = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            loss, _ = api.lm_loss_fn(cfg, remat=remat)(pr, batch)
            grads[remat] = torch.autograd.grad(loss, list(pr.values()))
            assert calls == [True] * cfg.num_layers * (2 if remat else 1)
    finally:
        ssd_scan.ssd_scan_ref = orig
    for a, b in zip(grads[False], grads[True]):
        assert (a - b).abs().max() <= 1e-5 * a.abs().max()


def test_convert_carries_the_hybrid_adamw_state(jref):
    """The hybrid's worker-stacked AdamW state (m, v over the super-layers'
    stacked leaves and the tail's list, count) goes across and back leaf
    for leaf, and one more step on it matches the reference's."""
    jcfg = jref.smoke(ARCH).replace(dtype="float32", num_layers=3)
    jp, _ = jref.api.init(jcfg, jax.random.PRNGKey(2), tp=1)
    jtc = jref.Train(optimizer="adamw", lr=3e-4, grad_clip=1.0)
    tc = TrainConfig(optimizer="adamw", lr=3e-4, grad_clip=1.0)
    rng = np.random.default_rng(0)
    jpw = jax.tree.map(lambda x: jnp.stack([x, x + 0.01]), jp)
    g1, g2 = (jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
        x.shape), jnp.float32), jpw) for _ in range(2))
    jstate = jax.tree.map(lambda x: jnp.broadcast_to(x, (2,) + x.shape),
                          jref.opt.adamw_init(jp))
    jp1, jstate1 = jref.opt.adamw_update(jpw, g1, jstate, jtc)
    jp2, jstate2 = jref.opt.adamw_update(jp1, g2, jstate1, jtc)

    state = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate1))
    assert "m" in state and any(k.startswith("tail.0.") for k in state["m"])
    back = convert.opt_state_to_jax(state)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jstate1))
    for a, b in zip(_leaves(back), _leaves(jstate1)):
        np.testing.assert_array_equal(a, b)
    p1 = convert.params_from_jax(jax.tree.map(np.asarray, jp1))
    p2, state2 = optimizers.adamw_update(
        p1, convert.params_from_jax(jax.tree.map(np.asarray, g2)), state, tc)
    got = convert.opt_state_to_jax(state2)
    for name, a, b in [("params", convert.params_to_jax(p2), jp2),
                       ("m", got["m"], jstate2["m"]),
                       ("v", got["v"], jstate2["v"])]:
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6, err_msg=name)


def test_fused_trust_path_refuses_the_hybrid(jref):
    """zamba2 mixes bf16 weights with f32 A_log, dt_bias and D, so its tree
    does not pack: ``fused_trust_path="on"`` raises in both packages, and
    ``auto`` takes the per-leaf path."""
    cfg = get_smoke_config(ARCH)
    p = api.init(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    assert {v.dtype for v in p.values()} == {torch.bfloat16, torch.float32}
    on = FederationConfig(fused_trust_path="on")
    with pytest.raises(ValueError, match="packable"):
        fl_step.fused_round_enabled(cfg, on, p)
    assert not fl_step.fused_round_enabled(
        cfg, FederationConfig(fused_trust_path="auto"), p)
    from repro.core import fl_step as jfl
    jp, _ = jref.api.init(jref.smoke(ARCH), jax.random.PRNGKey(0), tp=1)
    with pytest.raises(ValueError):
        jfl.fused_round_enabled(jref.smoke(ARCH),
                                jref.Fed(fused_trust_path="on"), jp)


def _fed_kw(async_mode):
    return dict(num_clusters=2, workers_per_cluster=2, trust_threshold=T,
                top_k_rewarded=TOP_K, async_mode=async_mode,
                fused_trust_path="off")


def _run_both(jref, async_mode):
    jproto = jref.Protocol(jref.smoke(ARCH), jref.Fed(**_fed_kw(async_mode)),
                           jref.Train(**TC), use_blockchain=True, seed=0)
    fed, tc = FederationConfig(**_fed_kw(async_mode)), TrainConfig(**TC)
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

    def get(async_mode):
        if async_mode not in cache:
            cache[async_mode] = _run_both(jref, async_mode)
        return cache[async_mode]
    yield get
    for jproto, proto, _ in cache.values():
        for p in (jproto, proto):
            if not p.node._closed:
                p.finalize()


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
def test_hybrid_protocol_matches_reference(runs, async_mode):
    jproto, proto, recs = runs(async_mode)
    for jrec, rec in recs:
        np.testing.assert_allclose(rec.scores, jrec.scores, rtol=0,
                                   atol=SCORE_TOL)
        np.testing.assert_allclose(rec.weights, jrec.weights, rtol=0,
                                   atol=SCORE_TOL)
        np.testing.assert_allclose(rec.losses, jrec.losses, rtol=0,
                                   atol=PROTO_LOSS_TOL)
        assert np.isfinite(rec.losses).all()
        if async_mode:
            np.testing.assert_array_equal(rec.staleness, jrec.staleness)
            assert rec.weights[rec.participation == 0].sum() == 0
    got = convert.params_to_jax(proto.global_params)
    for a, b in zip(jax.tree.leaves(got),
                    jax.tree.leaves(jproto.global_params)):
        f32 = b.dtype == np.float32
        b = np.asarray(b, np.float32)
        d, steps = np.abs(a - b), PARAM_RTOL * np.abs(b)
        assert np.all(d <= steps + 6 * TC["lr"])
        if f32:
            assert np.all(d <= 2 * TC["lr"])
        else:
            assert np.mean(d > steps + 1e-6) <= 0.03
    assert proto.task.async_state is None or isinstance(
        proto.task.async_state.pending, dict)


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
def test_hybrid_settlement_decisions_match_reference(runs, async_mode):
    jproto, proto, recs = runs(async_mode)
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


def test_hybrid_finalize_pays_the_same(runs):
    jproto, proto, _ = runs(False)
    assert proto.finalize() == jproto.finalize()


def test_train_launcher_runs_zamba2_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train --arch zamba2-7b --device cpu
    --rounds 2``: its JSON lines, a verified ledger, value conserved;
    ``--async`` runs the arrival scheduler's cohorts."""
    from repro_torch.launch import train
    assert "zamba2-7b" in train.TRAIN_ARCHS
    for extra in ([], ["--async"]):
        out = train.main(["--arch", ARCH, "--rounds", "2", "--device", "cpu",
                          *extra])
        proto = out["proto"]
        assert [e["round"] for e in out["log"]] == [1, 2]
        assert all(np.isfinite(e["loss"]) and e["aux"] == 0.0
                   for e in out["log"])
        assert len(proto.history) == 2 and proto.cfg.family == "hybrid"
        assert proto.ledger.verify_chain(deep=True)
        assert len(out["payouts"]) == 8
        if extra:
            assert all(r.participation is not None for r in proto.history)
    lines = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("ledger: 4 blocks, verified=True")
               for ln in lines) == 2


def test_federated_llm_example_runs_zamba2(capsys):
    from repro_torch.examples import federated_llm
    assert ARCH in federated_llm.LLM_ARCHS
    out = federated_llm.main(arch=ARCH, rounds=2, device="cpu")
    assert out["verified"] and out["blocks"] == 4
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("round 1: mean_loss=")
    assert lines[-1] == "ledger verified: True"
