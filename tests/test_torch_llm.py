"""The port's LLM training pieces against the JAX package on the CPU: the
causal-LM loss (``models.api.lm_loss_fn`` and the W-stacked ``loss_fn``),
its gradients through the decoder, ``_chunked_xent`` below and above its
512-position chunk, ``blocked_attention`` under grad with more KV than one
chunk, one AdamW step with gradient clipping, and the optimizer state
carried across by ``convert``.

Inputs and weights come from a seed (the JAX init, converted; tokens from
numpy). Tolerances, each against the reference's value:

  f32 loss            2e-5 absolute   two f32 passes of the same decoder
  f32 gradients       2e-5 · max|g|   per leaf; sums in other orders
                                      (measured ≤ 2.5e-6 · max|g|)
  bf16 loss           2e-3 absolute   products rounded to bf16 at other
                                      places (measured ≤ 8.6e-4)
  bf16 gradients      5e-2 · max|g|   per leaf: one or two bf16 steps of
                                      the leaf's largest value (the
                                      reference's bf16 statistics
                                      tolerance); measured ≤ 2.1e-2
  attention, xent     1e-5 relative   f32, the same formula
  AdamW, clip         1e-6 absolute   elementwise f32, the same formula
                                      (the optimizers' tolerance in
                                      tests/test_torch_model.py)

The JAX package is imported through the ``jref`` fixture, the workaround
for fault F1 of the reference (ROADMAP.md, Queue 3): see
``tests/test_torch_model.py``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import api, layers
from repro_torch.optim import optimizers

jax.config.update("jax_enable_x64", False)

LOSS_TOL = {"float32": 2e-5, "bfloat16": 2e-3}
GRAD_TOL = {"float32": 2e-5, "bfloat16": 5e-2}
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
    from repro.configs.base import TrainConfig as JTrain
    from repro.configs.registry import get_smoke_config as jsmoke
    from repro.models import api as japi
    from repro.models import layers as jlayers
    from repro.optim import optimizers as jopt
    return types.SimpleNamespace(api=japi, layers=jlayers, opt=jopt,
                                 smoke=jsmoke, Train=JTrain)


def _models(jref, arch, dtype, seed=1):
    jcfg = jref.smoke(arch).replace(dtype=dtype)
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    jp, _ = jref.api.init(jcfg, jax.random.PRNGKey(seed), tp=1)
    return jcfg, cfg, jp, convert.params_from_jax(jax.tree.map(np.asarray,
                                                               jp))


def _tokens(cfg, B, S, seed):
    """Tokens and labels (B, S) int32; the last 5 labels of each row are
    masked (-100), so the loss's masking is exercised."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = toks.copy()
    labels[:, -5:] = -100
    return toks, labels


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


# (arch, dtype, B, S, remat): S = 1024 runs four KV chunks of 256 in every
# layer's attention (danube's smoke window, 64, masks within and across
# them) and two 512-position chunks of the cross-entropy
CASES = [("smollm-135m", "float32", 2, 128, False),
         ("smollm-135m", "float32", 1, 1024, True),
         ("yi-6b", "float32", 2, 128, False),
         ("h2o-danube-1.8b", "float32", 1, 1024, True),
         ("smollm-135m", "bfloat16", 2, 128, True),
         ("yi-6b", "bfloat16", 2, 128, False)]


@pytest.mark.parametrize("arch,dtype,B,S,remat", CASES,
                         ids=[f"{a}-{d}-S{s}-{'remat' if r else 'plain'}"
                              for a, d, _, s, r in CASES])
def test_lm_loss_and_grads_match_reference(jref, arch, dtype, B, S, remat):
    jcfg, cfg, jp, p = _models(jref, arch, dtype)
    toks, labels = _tokens(cfg, B, S, seed=S)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jl, jm), jg = jax.value_and_grad(
        jref.api.loss_fn(jcfg, kv_chunk=KV_CHUNK), has_aux=True)(jp, jb)

    pr = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    loss, m = api.lm_loss_fn(cfg, remat=remat, kv_chunk=KV_CHUNK)(pr, batch)
    g = dict(zip(pr, torch.autograd.grad(loss, list(pr.values()))))
    loss = loss.detach()
    assert loss.dtype == torch.float32 and float(m["aux"]) == 0.0
    assert abs(float(loss) - float(jl)) <= LOSS_TOL[dtype]
    assert float(m["loss"].detach()) == float(loss)
    got = convert.params_to_jax(g)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, jg))
    for a, b in zip(_leaves(got), _leaves(jg)):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= GRAD_TOL[dtype] * np.abs(b).max()


def test_stacked_loss_fn_is_each_workers_loss(jref):
    """``loss_fn`` over (W, ...) params and (W, B, S) batches gives each
    worker's ``lm_loss_fn`` on its own slice, and evaluates without
    building a graph under ``no_grad``."""
    _, cfg, _, p = _models(jref, "smollm-135m", "float32")
    W = 3
    rng = np.random.default_rng(4)
    params_w = {k: v[None] + 0.01 * torch.from_numpy(
        rng.standard_normal((W,) + tuple(v.shape)).astype(np.float32))
        for k, v in p.items()}
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (W, 2, 64)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    with torch.no_grad():
        losses, metrics = api.loss_fn(cfg)(params_w, batch)
    assert losses.shape == (W,) and metrics["aux"].shape == (W,)
    assert not losses.requires_grad
    lm = api.lm_loss_fn(cfg)
    for w in range(W):
        want, _ = lm(api.worker(params_w, w), api.worker(batch, w))
        assert float(losses[w]) == float(want)


@pytest.mark.parametrize("S", [300, 1024])
def test_chunked_xent_matches_reference(jref, S):
    """Below or off the chunk (one block) and above it (two 512-position
    chunks, each checkpointed): value and gradients of x and the head."""
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    head = (0.3 * rng.standard_normal((32, 96))).astype(np.float32)
    tgt = rng.integers(0, 96, (2, S)).astype(np.int32)
    tgt[:, ::7] = -100
    jv, (jgx, jgh) = jax.value_and_grad(
        lambda a, h: jref.api._chunked_xent(a, h, jnp.asarray(tgt)),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(head).requires_grad_(True)
    v = api._chunked_xent(tx, th, torch.from_numpy(tgt).long())
    gx, gh = torch.autograd.grad(v, (tx, th))
    np.testing.assert_allclose(float(v.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jgx)).max())
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jgh)).max())


def test_shifted_targets_match_reference(jref):
    labels = np.arange(12, dtype=np.int32).reshape(2, 6)
    want = np.asarray(jref.api._shifted_targets(jnp.asarray(labels), 6, 0))
    got = api._shifted_targets(torch.from_numpy(labels), 6, 0)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("window", [0, 96])
def test_blocked_attention_grad_matches_reference(jref, window):
    """S = 256 over 64-slot KV chunks (the chunked branch, which serve runs
    in place): under grad the output and the gradients of q, k and v match
    ``jax.grad`` of the reference, and the output equals the in-place
    (no-grad) one bit for bit."""
    rng = np.random.default_rng(window)
    B, S, H, KV, hd = 1, 256, 4, 2, 16
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    cot = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    pos = np.arange(S)
    kw = dict(causal=True, window=window, kv_chunk=64)

    def jf(q_, k_, v_):
        o = jref.layers.blocked_attention(
            q_, k_, v_, q_positions=jnp.asarray(pos),
            kv_positions=jnp.asarray(pos), **kw)
        return jnp.sum(o * cot), o
    (_, jo), jgs = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tp = torch.from_numpy(pos)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = layers.blocked_attention(*ts, q_positions=tp, kv_positions=tp, **kw)
    gs = torch.autograd.grad((o * torch.from_numpy(cot)).sum(), ts)
    with torch.no_grad():
        o_serve = layers.blocked_attention(*ts, q_positions=tp,
                                           kv_positions=tp, **kw)
    assert torch.equal(o.detach(), o_serve)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(gs, jgs):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


def test_adamw_step_and_clip_match_reference(jref):
    """From a state the reference reached in one step (carried across by
    ``convert.opt_state_from_jax``), one more clipped AdamW step on (W,
    ...) leaves: params, m, v and count equal within 1e-6. The gradients
    are large, so the clip scales them (by worker, as the reference clips
    inside its worker vmap)."""
    W = 3
    tc = TrainConfig(optimizer="adamw", lr=3e-4, grad_clip=1.0,
                     weight_decay=0.01)
    jtc = jref.Train(optimizer="adamw", lr=3e-4, grad_clip=1.0,
                     weight_decay=0.01)
    rng = np.random.default_rng(0)

    def tree():
        return {"embed": rng.standard_normal((W, 7, 5)).astype(np.float32),
                "final_norm": rng.standard_normal((W, 5)).astype(np.float32),
                "layers": {"mlp": {"w_up": rng.standard_normal(
                    (W, 2, 5, 6)).astype(np.float32)}}}
    jp, g1, g2 = tree(), tree(), tree()
    g2 = jax.tree.map(lambda x: 40.0 * x, g2)
    jclip = jax.vmap(lambda g: jref.opt.clip_grads(g, jtc.grad_clip))
    jstate = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (W,) + x.shape),
        jref.opt.adamw_init(jax.tree.map(lambda x: x[0], jp)))
    jp1, jstate = jref.opt.adamw_update(jp, jclip(g1), jstate, jtc)
    jp2, jstate2 = jref.opt.adamw_update(jp1, jclip(g2), jstate, jtc)

    p1 = convert.params_from_jax(jax.tree.map(np.asarray, jp1))
    state = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate))
    assert state["count"].dtype == torch.int32
    assert state["count"].tolist() == [1] * W
    grads = optimizers.clip_grads(convert.params_from_jax(g2), tc.grad_clip)
    p2, state2 = optimizers.adamw_update(p1, grads, state, tc)
    got = convert.opt_state_to_jax(state2)
    np.testing.assert_array_equal(got["count"], np.asarray(jstate2["count"]))
    for name, a, b in [("params", convert.params_to_jax(p2), jp2),
                       ("m", got["m"], jstate2["m"]),
                       ("v", got["v"], jstate2["v"])]:
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6, err_msg=name)
    # the clip scaled the large gradients: no worker's norm is above 1
    sq = sum(g.square().reshape(W, -1).sum(1) for g in grads.values())
    assert torch.all(sq.sqrt() <= 1.0 + 1e-6)


def test_convert_carries_a_tied_decoder(jref):
    """smollm ties its embeddings: no ``lm_head`` on either side, and the
    tree goes across and back leaf for leaf, bf16 bit for bit."""
    jcfg, cfg, jp, p = _models(jref, "smollm-135m", "bfloat16")
    assert cfg.tie_embeddings and "lm_head" not in p and "lm_head" not in jp
    back = convert.params_to_jax(p)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for a, b in zip(_leaves(back), _leaves(jp)):
        np.testing.assert_array_equal(a, b)
    assert p["embed"].dtype == torch.bfloat16


def test_configs_reach_rope_and_head():
    """yi's RoPE theta (5e6) reaches ``apply_rope`` through the decoder,
    and smollm's tied head is the embedding's transpose."""
    yi = get_smoke_config("yi-6b")
    assert yi.rope_theta == 5_000_000.0
    seen = []
    orig = layers.apply_rope

    def spy(x, positions, theta):
        seen.append(theta)
        return orig(x, positions, theta)
    layers.apply_rope = spy
    try:
        p = api.init(yi.replace(dtype="float32"),
                     torch.Generator().manual_seed(0), torch.device("cpu"))
        api.forward(p, yi.replace(dtype="float32"),
                    {"tokens": torch.zeros((1, 4), dtype=torch.long)})
    finally:
        layers.apply_rope = orig
    assert seen and set(seen) == {5_000_000.0}

    sm = get_smoke_config("smollm-135m").replace(dtype="float32")
    p = api.init(sm, torch.Generator().manual_seed(0), torch.device("cpu"))
    toks = torch.tensor([[1, 2, 3]])
    logits, _ = api.forward(p, sm, {"tokens": toks})
    x, _ = api.TF.decoder_forward(p, sm, toks, return_hidden=True)
    torch.testing.assert_close(logits, x @ p["embed"].T, rtol=0, atol=0)


def test_hybrid_loss_trains_through_the_ssd_function():
    """zamba2 trains: ``loss_fn`` gives each worker's loss, and the loss's
    graph runs through K4's ``autograd.Function`` (on the CPU its plain
    forward and backward), so every leaf, the Mamba2 gates included, gets a
    finite gradient that is not all zero."""
    cfg = get_smoke_config("zamba2-7b").replace(dtype="float32")
    p = api.init(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    toks = torch.randint(0, cfg.vocab_size, (2, 1, 64),
                         generator=torch.Generator().manual_seed(1))
    pw = {k: v.detach().requires_grad_(True)
          for k, v in api.stack(p, 2).items()}
    losses, m = api.loss_fn(cfg)(pw, {"tokens": toks, "labels": toks})
    assert losses.shape == (2,) and set(m) == {"loss", "aux"}
    seen, todo = set(), [losses.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo += [f for f, _ in fn.next_functions]
    assert "_SSDScanBackward" in {type(f).__name__ for f in seen}
    g = torch.autograd.grad(losses.sum(), list(pw.values()))
    for name, x in zip(pw, g):
        assert torch.isfinite(x).all() and x.abs().sum() > 0, name
