"""The port's model pieces against the JAX package: weight conversion, the
CNN's logits, losses and per-worker gradients, the flat pack, the
optimizers, the even-W median rule and the dropout-mask rule.

Inputs come from a seed with numpy. The JAX model API is imported through
the ``jref`` fixture, which works around a fault of the reference on this
JAX version (ROADMAP.md, Queue 3, F1): ``repro.models.sharding`` registers
a batching rule by testing ``prim in batching.primitive_batchers``, which
JAX 0.9 answers with a TypeError. While that module is imported the table
is replaced by a dict that already holds the primitive, then restored.

Tolerances: logits and losses 1e-5 and gradients 1e-5 absolute (f32 on the
CPU, the two frameworks' convolutions sum in different orders); the
optimizers 1e-6 (elementwise f32, same formula).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import FederationConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import fl_step, trust
from repro_torch.kernels import pack
from repro_torch.models import api, cnn
from repro_torch.optim import optimizers

jax.config.update("jax_enable_x64", False)


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
    from repro.configs.registry import get_config as jget_config
    from repro.core import fl_step as jfl_step
    from repro.core import trust as jtrust
    from repro.kernels import pack as jpack
    from repro.models import api as japi
    from repro.optim import optimizers as jopt
    return types.SimpleNamespace(api=japi, fl_step=jfl_step, trust=jtrust,
                                 pack=jpack, opt=jopt,
                                 cfg=jget_config("paper-net"))


def _jax_params(jref, seed):
    gp, _ = jref.api.init(jref.cfg, jax.random.PRNGKey(seed), tp=1)
    return jax.tree.map(np.asarray, gp)


def _batch(W, B, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((W, B, 28, 28, 1)).astype(np.float32),
            rng.integers(0, 10, (W, B)).astype(np.int32))


def _perturbed(tree, W, seed):
    """W different workers' params around ``tree`` (JAX layout, numpy)."""
    rng = np.random.default_rng(seed)
    return [jax.tree.map(
        lambda x: (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32),
        tree) for _ in range(W)]


def _stack_port(trees):
    ps = [convert.params_from_jax(t) for t in trees]
    return {k: torch.stack([p[k] for p in ps]) for k in ps[0]}


def test_convert_round_trip(jref):
    tree = _jax_params(jref, 0)
    port = convert.params_from_jax(tree)
    assert list(port) == sorted(port)
    assert port["conv1.w"].shape == (10, 1, 5, 5)
    assert port["conv2.w"].shape == (20, 10, 5, 5)
    assert port["fc1.w"].shape == (50, 320)
    assert port["fc2.w"].shape == (10, 50)
    back = convert.params_to_jax(port)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_cnn_logits_loss_and_grads_match_jax(jref):
    W, B = 3, 5
    trees = _perturbed(_jax_params(jref, 1), W, 2)
    images, labels = _batch(W, B, 3)
    cfg = get_config("paper-net")

    params_w = {k: v.requires_grad_(True)
                for k, v in _stack_port(trees).items()}
    logits = cnn.cnn_forward(params_w, cfg, torch.from_numpy(images))
    losses, metrics = api.loss_fn(cfg)(
        params_w, {"images": torch.from_numpy(images),
                   "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(losses.sum(), list(params_w.values()))
    grads = dict(zip(params_w, grads))

    jloss = jref.api.loss_fn(jref.cfg)
    from repro.models.cnn import cnn_forward as jforward
    for w in range(W):
        jp = jax.tree.map(jnp.asarray, trees[w])
        jb = {"images": jnp.asarray(images[w]),
              "labels": jnp.asarray(labels[w])}
        np.testing.assert_allclose(
            logits[w].detach().numpy(),
            np.asarray(jforward(jp, jref.cfg, jb["images"])), atol=1e-5)
        (l, m), g = jax.value_and_grad(jloss, has_aux=True)(jp, jb)
        np.testing.assert_allclose(losses[w].item(), float(l), atol=1e-5)
        np.testing.assert_allclose(metrics["accuracy"][w].item(),
                                   float(m["accuracy"]), atol=0)
        got = convert.params_to_jax({k: v[w] for k, v in grads.items()})
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(g)):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)


def test_pack_order_width_and_delta_rule(jref):
    cfg = get_config("paper-net")
    tree = _jax_params(jref, 4)
    g = convert.params_from_jax(tree)
    spec = pack.pack_spec(g)
    assert spec.keys == ("conv1.b", "conv1.w", "conv2.b", "conv2.w",
                         "fc1.b", "fc1.w", "fc2.b", "fc2.w")
    jspec = jref.pack.pack_spec(tree)
    assert spec.total == jspec.total == 21840
    assert spec.sizes == jspec.sizes and spec.offsets == jspec.offsets
    # deltas: the same values per leaf, each leaf in its framework's layout
    trees = _perturbed(tree, 4, 5)
    new_w = _stack_port(trees)
    flat = pack.pack_delta(new_w, g, spec)
    jflat = jref.pack.pack_delta(
        jax.tree.map(lambda *x: jnp.stack(x), *trees), tree, jspec)
    assert flat.shape == (4, 21840) and flat.dtype == torch.float32
    for w in range(4):
        got = convert.params_to_jax(pack.unpack_vector(flat[w], spec))
        want = jref.pack.unpack_vector(jflat[w], jspec)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))
    back = pack.unpack_stack(pack.pack_stack(new_w, spec), spec)
    for k in new_w:
        torch.testing.assert_close(back[k], new_w[k], rtol=0, atol=0)
    assert fl_step.fused_round_enabled(cfg, FederationConfig(), g)
    assert not fl_step.fused_round_enabled(
        cfg, FederationConfig(fused_trust_path="off"), g)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_optimizer_updates_match_jax(jref, optimizer):
    W = 3
    tc = TrainConfig(optimizer=optimizer, weight_decay=0.01, grad_clip=0.5,
                     lr=0.05)
    rng = np.random.default_rng(6)
    shapes = {"a": (W, 4, 3), "b": (W, 7)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    gr = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tg = optimizers.clip_grads({k: torch.from_numpy(v)
                                for k, v in gr.items()}, tc.grad_clip)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jg = jax.vmap(lambda g: jref.opt.clip_grads(g, tc.grad_clip))(
        {k: jnp.asarray(v) for k, v in gr.items()})
    for k in p:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   atol=1e-6)
    ts = fl_step._stack_state(optimizers.init_opt(
        {k: v[0] for k, v in tp.items()}, tc), W)
    js = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (W,) + x.shape),
                      jref.opt.init_opt({k: v[0] for k, v in jp.items()},
                                        tc))
    for _ in range(2):
        tp, ts = optimizers.opt_update(tp, tg, ts, tc)
        jp, js = jref.opt.opt_update(jp, jg, js, tc)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6)
    if optimizer == "adamw":
        np.testing.assert_array_equal(ts["count"].numpy(),
                                      np.asarray(js["count"]))


@pytest.mark.parametrize("W", [4, 5, 16])
def test_median_and_scores_match_jax_even_and_odd(jref, W):
    rng = np.random.default_rng(W)
    norms = rng.random(W).astype(np.float32) + 0.1
    torch.testing.assert_close(trust.median(torch.from_numpy(norms)),
                               torch.tensor(float(np.median(norms))),
                               rtol=0, atol=1e-7)
    assert float(trust.median(torch.tensor([1.0, 2.0, 3.0, 4.0]))) == 2.5
    dot = rng.standard_normal(W).astype(np.float32)
    sq_u = (norms ** 2).astype(np.float32)
    sq_c = np.float32(0.3)
    ld = rng.standard_normal(W).astype(np.float32)
    fed = FederationConfig(num_clusters=1, workers_per_cluster=W)
    got = trust.scores_from_stats(trust.TrustStats(
        *(torch.from_numpy(np.asarray(x)) for x in (dot, sq_u, sq_c, ld))),
        fed)
    want = jref.trust.scores_from_stats(jref.trust.TrustStats(
        *(jnp.asarray(x) for x in (dot, sq_u, sq_c, ld))), fed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_dropout_mask_rule_and_reeval_reuses_the_mask():
    cfg = get_config("paper-net")
    W, B = 4, 6
    gen = torch.Generator().manual_seed(0)
    mask = cnn.dropout_mask(gen, W, B, cfg, torch.device("cpu"))
    assert mask.shape == (W, B, 20) and mask.dtype == torch.bool
    assert 0.3 < mask.float().mean().item() < 0.7
    # kept maps are scaled by 2 and dropped maps are zero, per sample and
    # channel: a mask of all-keep doubles conv2's maps before the pool
    params = fl_step.hierarchy.broadcast_to_workers(
        api.init(cfg, torch.Generator().manual_seed(1),
                 torch.device("cpu")), W)
    images, labels = _batch(W, B, 7)
    images = torch.from_numpy(images)
    ones = torch.ones((W, B, 20), dtype=torch.bool)
    zeros = torch.zeros((W, B, 20), dtype=torch.bool)
    dropped = cnn.cnn_forward(params, cfg, images, mask=zeros)
    # every map dropped: the logits are fc2(relu(fc1 bias)), per worker
    h = torch.relu(params["fc1.b"])[:, None]
    expect = torch.baddbmm(params["fc2.b"][:, None], h.expand(W, B, 50),
                           params["fc2.w"].transpose(1, 2))
    torch.testing.assert_close(dropped, expect)
    assert not torch.equal(cnn.cnn_forward(params, cfg, images, mask=ones),
                           cnn.cnn_forward(params, cfg, images))

    # the round draws ONE mask per local step and re-evaluates the post-step
    # loss with that same mask
    fed = FederationConfig(num_clusters=1, workers_per_cluster=W,
                           trust_threshold=0.0)
    tc = TrainConfig()
    gp = api.init(cfg, torch.Generator().manual_seed(1), torch.device("cpu"))
    batch = {"images": images[:, None], "labels": torch.from_numpy(labels)[
        :, None]}
    fn = fl_step.make_fl_round(cfg, fed, tc, device="cpu")
    g1 = torch.Generator().manual_seed(9)
    out = fn(gp, fl_step.init_worker_opt(gp, fed, tc), batch, g1)

    g2 = torch.Generator().manual_seed(9)
    m = cnn.dropout_mask(g2, W, B, cfg, torch.device("cpu"))
    loss_fn = api.loss_fn(cfg)
    step = {"images": images, "labels": batch["labels"][:, 0]}
    pw = {k: v.detach().requires_grad_(True)
          for k, v in fl_step.hierarchy.broadcast_to_workers(gp, W).items()}
    l_pre, _ = loss_fn(pw, step, m)
    grads = torch.autograd.grad(l_pre.sum(), list(pw.values()))
    new_p = {k: (v - tc.lr * g).detach() for (k, v), g in zip(pw.items(),
                                                               grads)}
    with torch.no_grad():
        l_post, _ = loss_fn(new_p, step, m)
    torch.testing.assert_close(out.losses, l_post, rtol=0, atol=1e-6)
    torch.testing.assert_close(out.metrics["mean_loss_delta"],
                               (l_pre - l_post).mean().detach(),
                               rtol=0, atol=1e-6)
    # exactly one draw was consumed
    assert torch.equal(cnn.dropout_mask(g1, W, B, cfg, torch.device("cpu")),
                       cnn.dropout_mask(g2, W, B, cfg, torch.device("cpu")))
