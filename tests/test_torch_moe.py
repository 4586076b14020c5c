"""The port's MoE family against the JAX package on the CPU: the MoE layer
(``models.moe.apply_moe``, the capacity ``gather`` path and the ``dense``
oracle) with the experts it picks and the tokens it drops, padded experts
through ``convert``, the causal-LM loss and gradients of qwen2-moe-a2.7b's
and olmoe-1b-7b's smoke configs (remat on and off), prefill and decode
steps, the AdamW state of the nested ``moe.shared`` leaves through
``convert``, a 2 × 2 ``SDFLBProtocol`` over qwen2's smoke config (it has
shared experts) in both packages, sync and async with the chain on, and
``launch.train --arch olmoe-1b-7b`` and ``federated_llm --arch
qwen2-moe-a2.7b`` on the CPU.

Inputs come from numpy with a seed; weights are the JAX init, converted.
Ties are built in on purpose: top-1 routing, identical tokens (the
reference's own ``tests/test_models.py`` feeds ``jnp.ones``) and rows that
start with the same token, so capacity boundaries fall between equal
weights, which the reference breaks by the lower index.

Tolerances, each against the reference's value:

  MoE layer, f32      2e-5 absolute on outputs, 2e-5 · max(1, max|g|)
                      per gradient (measured ≤ 1.2e-6 and 1.1e-6 of
                      max|g|); the aux loss 1e-6
  selection           exact: the same top-k experts, the same C tokens an
                      expert (fill slots included), the same drops
  LM loss, gradients  ``tests/test_torch_llm.py``'s LOSS_TOL and GRAD_TOL
                      (f32 2e-5, 2e-5 · max|g|; bf16 2e-3, 5e-2 · max|g|),
                      in bf16 widened by the reference's own bf16-vs-f32
                      gap on the leaf, as for zamba2
                      (``tests/test_torch_hybrid_train.py``): a bf16
                      rounding flips a few routing choices, and a flipped
                      token moves the gradients by far more than a
                      rounding (the reference's gap reaches 0.36 of max|g|
                      on olmoe's head, the port's distance to it 0.20); the
                      reported aux 1e-6 (f32), 1e-4 (bf16)
  prefill, decode     logits 1e-4 (f32), as ``tests/test_torch_serve.py``

The protocol (two rounds of AdamW lr 3e-4, clip 1.0, the losses each
worker's after its step), in f32 and in the config's bf16:

  f32    scores, weights and losses 1e-5 (measured ≤ 8.4e-7 and 9.6e-7),
         params 0.1 · lr (measured ≤ 6.3e-6 = 0.021 lr)
  bf16   ``tests/test_torch_hybrid_train.py``'s: scores and weights 2e-3
         (measured ≤ 1.0e-3), params two bf16 steps plus 6 lr with at
         most 3 % of a leaf's elements beyond the two steps (measured
         ≤ 4.6 lr), the f32 router and shared gate within 6 · lr with at
         most 1 % of their elements beyond 2 · lr (measured ≤ 2.04 lr,
         0.59 % beyond: a flipped routing choice turns a gradient's
         sign, and AdamW steps each element ~lr · sign(g)); losses
         1e-2 plus the reference's own bf16-vs-f32 gap on the worker's
         loss (a flipped routing choice; measured ≤ 1.6e-2)

and identical settlement decisions in both, at a threshold that splits the
workers with a margin.

The JAX package is imported through the ``jref`` fixture, the workaround
for fault F1 of the reference (ROADMAP.md, Queue 3; see
``tests/test_torch_llm.py``).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import FederationConfig, MoEConfig, \
    TrainConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core import fl_step
from repro_torch.core.protocol import SDFLBProtocol
from repro_torch.data.datasets import synthetic_tokens
from repro_torch.models import api
from repro_torch.models import moe as M
from repro_torch.optim import optimizers

jax.config.update("jax_enable_x64", False)

QWEN, OLMOE = "qwen2-moe-a2.7b", "olmoe-1b-7b"
LAYER_TOL, AUX_TOL = 2e-5, {"float32": 1e-6, "bfloat16": 1e-4}
LOSS_TOL = {"float32": 2e-5, "bfloat16": 2e-3}
GRAD_TOL = {"float32": 2e-5, "bfloat16": 5e-2}
LOGIT_TOL = 1e-4
KV_CHUNK = 256
W, B, S, ROUNDS = 4, 2, 128, 2
SCORE_TOL, PROTO_LOSS_TOL, PARAM_RTOL = 2e-3, 1e-2, 2.0 ** -7
PROTO_F32_TOL = 1e-5
T_SPLIT, TOP_K = 0.47, 2
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
    from repro.configs.base import MoEConfig as JMoE
    from repro.configs.base import TrainConfig as JTrain
    from repro.configs.registry import get_smoke_config as jsmoke
    from repro.core.protocol import SDFLBProtocol as JProtocol
    from repro.models import api as japi
    from repro.models import moe as jmoe
    from repro.optim import optimizers as jopt
    return types.SimpleNamespace(api=japi, moe=jmoe, opt=jopt, smoke=jsmoke,
                                 MoE=JMoE, Protocol=JProtocol, Fed=JFed,
                                 Train=JTrain)


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _flat_moe(jp):
    """The reference's ``init_moe`` tree → the port's flat layer dict."""
    out = {}
    for k, v in jp.items():
        if isinstance(v, dict):
            out.update({f"{k}.{a}": torch.from_numpy(np.array(b))
                        for a, b in v.items()})
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _layer_x(case, B_, S_, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B_, S_, d)).astype(np.float32)
    if case == "ones":                      # tests/test_models.py's drops
        x[:] = 1.0
    elif case == "repeats":                 # 4 distinct tokens, repeated
        x = np.tile(x[:, :4], (1, S_ // 4, 1))
    elif case == "row_start":               # rows start with one token
        x[:, 0] = x[0, 0]
    return x


# (name, experts, top_k, shared experts, capacity factor, x)
LAYER_CASES = [("plain", 4, 2, 1, 1.25, "random"),
               ("no_shared", 8, 2, 0, 1.0, "random"),
               ("top1_ties", 8, 1, 0, 1.0, "repeats"),
               ("ones_drops", 4, 2, 1, 1.0, "ones"),
               ("row_start", 4, 2, 1, 1.0, "row_start"),
               ("top2_ties", 4, 2, 0, 0.5, "repeats")]


@pytest.mark.parametrize("name,e,k,sh,cf,xcase", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_moe_layer_picks_and_drops_as_the_reference(jref, name, e, k, sh,
                                                    cf, xcase):
    """The same top-k experts a token, the same C tokens an expert (fill
    slots too) and so the same dropped tokens; outputs, aux loss and every
    gradient within 2e-5, gather and dense."""
    d, f, B_, S_ = 16, 32, 2, 24
    kw = dict(num_experts=e, top_k=k, d_ff_expert=f, num_shared_experts=sh,
              d_ff_shared=16 if sh else 0, capacity_factor=cf)
    jc, c = jref.MoE(**kw), MoEConfig(**kw)
    jp, _ = jref.moe.init_moe(jax.random.PRNGKey(e + k), d, jc, tp=1,
                              dtype=jnp.float32)
    p = _flat_moe(jp)
    x = _layer_x(xcase, B_, S_, d, seed=e * 10 + k)
    T = B_ * S_
    xf = jnp.asarray(x.reshape(T, d))

    # the selection
    jprobs, _ = jref.moe._router_probs(jp, xf, jc)
    jw = jref.moe._topk_weights(jprobs, k)
    C = M.capacity(c, T, cf)
    _, jtop = jax.lax.top_k(jw.T, C)
    probs, _ = M._router_probs(p, torch.from_numpy(x.reshape(T, d)), c)
    w, idx = M._topk_weights(probs, k)
    np.testing.assert_array_equal(w.numpy() > 0, np.asarray(jw) > 0)
    top_idx, ek, flat, kept = M._routes(w, idx, C)
    np.testing.assert_array_equal(top_idx.numpy(), np.asarray(jtop))
    jtop = np.asarray(jtop)
    jkept = np.array([[t in jtop[ex] for ex in row]
                      for t, row in enumerate(ek.numpy())])
    np.testing.assert_array_equal(kept.numpy(), jkept)
    if xcase in ("ones", "repeats"):
        assert (~jkept).any()               # the case does drop tokens
        assert not np.isin(np.arange(T), jtop).all() or k * T > e * C

    for impl in ("gather", "dense"):
        def jf(params, xx):
            o, a = jref.moe.apply_moe(params, xx, jc, impl=impl)
            return jnp.sum(jnp.sin(o)) + a, (o, a)
        (_, (jo, ja)), jg = jax.value_and_grad(jf, argnums=(0, 1),
                                               has_aux=True)(jp, jnp.asarray(x))
        pr = {kk: v.clone().requires_grad_(True) for kk, v in p.items()}
        xr = torch.from_numpy(x).requires_grad_(True)
        o, a = M.apply_moe(pr, xr, c, impl=impl)
        (o.sin().sum() + a).backward()
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                                   rtol=0, atol=LAYER_TOL)
        assert abs(float(a.detach()) - float(ja)) <= AUX_TOL["float32"]
        grads = {"x": (xr.grad, np.asarray(jg[1]))}
        grads.update({kk: (pr[kk].grad, g.numpy())
                      for kk, g in _flat_moe(jg[0]).items()})
        for kk, (got, want) in grads.items():
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=LAYER_TOL * max(1.0, np.abs(want).max()), err_msg=kk)


@pytest.mark.parametrize("e,k,seed", [(4, 1, 0), (4, 2, 7), (8, 1, 13),
                                      (8, 2, 50)])
def test_moe_gather_matches_dense(e, k, seed):
    """``tests/test_models.py``'s check on the port: with capacity for every
    token (cf = E / k) the gather path is the dense oracle."""
    d, f = 16, 32
    c = MoEConfig(num_experts=e, top_k=k, d_ff_expert=f,
                  capacity_factor=float(e) / k)
    gen = torch.Generator().manual_seed(seed)
    p = M.init_moe(gen, d, c, torch.float32, "cpu")
    x = torch.randn((2, 24, d), generator=gen)
    out_g, aux_g = M.apply_moe(p, x, c, impl="gather")
    out_d, aux_d = M.apply_moe(p, x, c, impl="dense")
    torch.testing.assert_close(out_g, out_d, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux_g, aux_d, rtol=1e-5, atol=0)


def test_moe_gathers_add_as_the_scatter_add_on_the_cpu():
    """The gather combine and the gather backward of the dispatch give the
    bits of the scatter-adds they replace (``index_add_``, which the CPU
    applies in index order, i.e. ascending (expert, slot)), at bf16
    experts with drops and fill slots."""
    c = MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                  capacity_factor=1.0)
    gen = torch.Generator().manual_seed(3)
    p = M.init_moe(gen, 16, c, torch.bfloat16, "cpu")
    x = torch.randn((2, 40, 16), generator=gen).to(torch.bfloat16)
    x[:, 20:] = x[:, :20]                     # ties at the boundaries
    T, d = 80, 16
    xf = x.reshape(T, d)
    probs, _ = M._router_probs(p, xf, c)
    w, idx = M._topk_weights(probs, c.top_k)
    C = M.capacity(c, T, c.capacity_factor)
    top_idx, ek, flat, kept = M._routes(w, idx, C)
    assert (~kept).any()

    def via_index_add(xx, ww):
        xe = xx[top_idx.reshape(-1)].reshape(8, C, d)
        ye = M._expert_ffn(p, xe).float()
        ye = ye * ww.T.gather(1, top_idx)[..., None]
        return torch.zeros((T, d)).index_add(0, top_idx.reshape(-1),
                                             ye.reshape(-1, d))

    def via_gathers(xx, ww):
        xe = M._Dispatch.apply(xx, top_idx, flat, kept).reshape(8, C, d)
        ye = M._expert_ffn(p, xe).float().reshape(-1, d)
        return M._Combine.apply(ye, ww, top_idx, ek, flat, kept)

    dout = torch.randn((T, d), generator=gen)
    res = []
    for fn in (via_index_add, via_gathers):
        xx = xf.detach().clone().requires_grad_(True)
        ww = w.detach().clone().requires_grad_(True)
        out = fn(xx, ww)
        gx, gw = torch.autograd.grad(out, (xx, ww), dout)
        res.append((out, gx, gw * (w > 0)))
    for a, b in zip(*res):
        assert torch.equal(a, b)


def test_moe_padded_experts_through_convert(jref):
    """A reference decoder built at tp = 4 with 3 experts has a 4th, padded
    router column and expert; the port takes E from the router, never
    routes to the pad and gives the reference's logits."""
    jcfg = jref.smoke(OLMOE).replace(
        dtype="float32", moe=jref.MoE(num_experts=3, top_k=2,
                                      d_ff_expert=128))
    cfg = get_smoke_config(OLMOE).replace(
        dtype="float32", moe=MoEConfig(num_experts=3, top_k=2,
                                       d_ff_expert=128))
    jp, _ = jref.api.init(jcfg, jax.random.PRNGKey(0), tp=4)
    p = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    assert p["layers.moe.router"].shape == (2, 256, 4)
    assert p["layers.moe.w_gate"].shape == (2, 4, 256, 128)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((16, 256)).astype(np.float32))
    lp = {"router": p["layers.moe.router"][0]}
    probs, _ = M._router_probs(lp, x, cfg.moe)
    assert float(probs[:, 3].max()) < 1e-12
    assert (M._topk_weights(probs, 2)[1] < 3).all()
    toks = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    want, _ = jref.api.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, _ = api.forward(p, cfg, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)


def test_moe_configs_and_init():
    """Both configs at full size, and the port's init: the reference's
    keys, shapes and dtypes (router and shared gate f32)."""
    q, o = get_config(QWEN), get_config(OLMOE)
    assert (q.num_layers, q.d_model, q.vocab_size, q.moe.num_experts,
            q.moe.top_k, q.moe.d_ff_expert, q.moe.num_shared_experts,
            q.moe.d_ff_shared) == (24, 2048, 151936, 60, 4, 1408, 4, 1408)
    assert (o.num_layers, o.d_model, o.vocab_size, o.moe.num_experts,
            o.moe.top_k, o.moe.d_ff_expert, o.moe.num_shared_experts) == (
                16, 2048, 50304, 64, 8, 1024, 0)
    cfg = get_smoke_config(QWEN)
    p = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    L_, d = cfg.num_layers, cfg.d_model
    want = {"layers.moe.router": ((L_, d, 4), torch.float32),
            "layers.moe.w_gate": ((L_, 4, d, 128), torch.bfloat16),
            "layers.moe.w_down": ((L_, 4, 128, d), torch.bfloat16),
            "layers.moe.shared.w_up": ((L_, d, 128), torch.bfloat16),
            "layers.moe.shared.gate": ((L_, d, 1), torch.float32)}
    for k, (shape, dt) in want.items():
        assert (tuple(p[k].shape), p[k].dtype) == (shape, dt), k
    assert not any(k.startswith("layers.mlp.") for k in p)


# ---------------------------------------------------------------------------
# the decoder: loss, gradients, decode
# ---------------------------------------------------------------------------

def _models(jref, arch, dtype, seed=1):
    jcfg = jref.smoke(arch).replace(dtype=dtype)
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    jp, _ = jref.api.init(jcfg, jax.random.PRNGKey(seed), tp=1)
    return jcfg, cfg, jp, convert.params_from_jax(jax.tree.map(np.asarray,
                                                               jp))


def _tokens(cfg, B_, S_, seed, same_rows=False):
    """Tokens and labels (B, S) int32, the last 5 labels of each row masked
    (-100); every row starts with the same token (position 0 routes alike
    in every layer), and ``same_rows`` repeats the first row."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B_, S_)).astype(np.int32)
    toks[:, 0] = toks[0, 0]
    if same_rows:
        toks[:] = toks[0]
    labels = toks.copy()
    labels[:, -5:] = -100
    return toks, labels


# (arch, dtype, B, S, remat, same rows)
LOSS_CASES = [(QWEN, "float32", 2, 128, False, False),
              (QWEN, "float32", 2, 128, True, True),
              (OLMOE, "float32", 2, 128, True, False),
              (OLMOE, "float32", 2, 64, False, True),
              (QWEN, "bfloat16", 2, 128, True, False),
              (OLMOE, "bfloat16", 2, 128, False, False)]


@pytest.mark.parametrize(
    "arch,dtype,B_,S_,remat,same", LOSS_CASES,
    ids=[f"{a.split('-')[0]}-{d}-S{s}-{'remat' if r else 'plain'}"
         f"{'-same_rows' if m else ''}" for a, d, _, s, r, m in LOSS_CASES])
def test_moe_lm_loss_and_grads_match_reference(jref, arch, dtype, B_, S_,
                                               remat, same):
    jcfg, cfg, jp, p = _models(jref, arch, dtype)
    toks, labels = _tokens(cfg, B_, S_, seed=S_, same_rows=same)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jl, jm), jg = jax.value_and_grad(
        jref.api.loss_fn(jcfg, kv_chunk=KV_CHUNK), has_aux=True)(jp, jb)

    pr = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    loss, m = api.lm_loss_fn(cfg, remat=remat, kv_chunk=KV_CHUNK)(pr, batch)
    g = dict(zip(pr, torch.autograd.grad(loss, list(pr.values()))))
    loss = loss.detach()
    aux = float(m["aux"].detach())
    assert loss.dtype == torch.float32 and aux > 0
    assert abs(float(loss) - float(jl)) <= LOSS_TOL[dtype]
    assert abs(aux - float(jm["aux"])) <= AUX_TOL[dtype]
    got = convert.params_to_jax(g)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, jg))
    gap = [0.0] * len(_leaves(jg))
    if dtype == "bfloat16":
        # what bf16 alone moves each gradient in the reference: the same
        # weights in f32 (routing decisions flip between the two)
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


def test_moe_remat_keeps_the_aux_loss_and_gradients():
    """With ``remat`` each checkpointed layer returns its aux loss: the loss,
    the aux and the gradients equal those without, bit for bit."""
    cfg = get_smoke_config(OLMOE).replace(dtype="float32")
    p = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks, labels = _tokens(cfg, 2, 64, seed=4)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    out = []
    for remat in (False, True):
        pr = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss, m = api.lm_loss_fn(cfg, remat=remat)(pr, batch)
        out.append((loss.detach(), m["aux"].detach(),
                    torch.autograd.grad(loss, list(pr.values()))))
    assert float(out[0][1]) > 0
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    for a, b in zip(out[0][2], out[1][2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", [QWEN, OLMOE])
def test_moe_prefill_and_decode_match_reference(jref, arch):
    """Prefill a 40-token prompt (no aux returned), then 4 greedy decode
    steps at twice the capacity factor: f32 logits within 1e-4, the port
    fed the reference's tokens, and its own greedy tokens equal."""
    jcfg, cfg, jp, p = _models(jref, arch, "float32", seed=2)
    toks, _ = _tokens(cfg, 3, 40, seed=9)
    L_ = 40 + 4
    jlg, jc = jref.api.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, L_)
    tlg, tc = api.prefill(p, cfg, {"tokens": torch.from_numpy(toks).long()},
                          L_)
    for step in range(5):
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=0,
                                   atol=LOGIT_TOL)
        jt = np.array(jnp.argmax(jlg[:, -1], -1)[:, None], np.int32)
        np.testing.assert_array_equal(
            tlg[:, -1].argmax(-1, keepdim=True).numpy(), jt)
        if step == 4:
            break
        jlg, jc = jref.api.decode_step(jp, jcfg, jc, jnp.asarray(jt),
                                       40 + step)
        tlg, tc = api.decode_step(p, cfg, tc, torch.from_numpy(jt).long(),
                                  40 + step)


def test_moe_decode_runs_at_twice_the_capacity_factor(monkeypatch):
    """Decode steps call the MoE layers at 2 × cf, the forward at cf."""
    cfg = get_smoke_config(QWEN).replace(dtype="float32")
    p = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    seen = []
    orig = M.apply_moe

    def spy(params, x, moe_cfg, *, capacity_factor=0.0, impl="gather"):
        seen.append(capacity_factor or moe_cfg.capacity_factor)
        return orig(params, x, moe_cfg, capacity_factor=capacity_factor,
                    impl=impl)
    monkeypatch.setattr(M, "apply_moe", spy)
    toks = torch.zeros((4, 8), dtype=torch.long)
    _, cache = api.prefill(p, cfg, {"tokens": toks}, 9)
    api.decode_step(p, cfg, cache, toks[:, :1], 8)
    cf = cfg.moe.capacity_factor
    assert seen == [cf] * cfg.num_layers + [2 * cf] * cfg.num_layers
    # qwen2 at full size decodes 4 rows at C = 1 (ceil(4·4/60·2.5) = 1)
    assert M.capacity(get_config(QWEN).moe, 4, 2 * cf) == 1


def test_convert_carries_the_moe_adamw_state(jref):
    """The nested ``moe.shared`` leaves of qwen2's params and worker-stacked
    AdamW state go across and back leaf for leaf, and one more step on them
    matches the reference's."""
    jcfg = jref.smoke(QWEN).replace(dtype="float32")
    jp, _ = jref.api.init(jcfg, jax.random.PRNGKey(2), tp=1)
    p = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    assert "layers.moe.shared.gate" in p
    back = convert.params_to_jax(p)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
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
    assert "layers.moe.shared.w_down" in state["v"]
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


def test_moe_takes_the_per_leaf_trust_path(jref):
    """The f32 router and shared gate beside bf16 experts: the tree does not
    pack in either package, and ``auto`` takes the per-leaf path."""
    cfg = get_smoke_config(QWEN)
    p = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {v.dtype for v in p.values()} == {torch.bfloat16, torch.float32}
    with pytest.raises(ValueError, match="packable"):
        fl_step.fused_round_enabled(
            cfg, FederationConfig(fused_trust_path="on"), p)
    assert not fl_step.fused_round_enabled(cfg, FederationConfig(), p)
    from repro.core import fl_step as jfl
    jp, _ = jref.api.init(jref.smoke(QWEN), jax.random.PRNGKey(0), tp=1)
    assert not jfl.fused_round_enabled(jref.smoke(QWEN), jref.Fed(), jp)


# ---------------------------------------------------------------------------
# the protocol and the entry points
# ---------------------------------------------------------------------------

def _fed_kw(async_mode):
    return dict(num_clusters=2, workers_per_cluster=2,
                trust_threshold=T_SPLIT, top_k_rewarded=TOP_K,
                async_mode=async_mode)


def _run_both(jref, dtype, async_mode):
    jproto = jref.Protocol(jref.smoke(QWEN).replace(dtype=dtype),
                           jref.Fed(**_fed_kw(async_mode)),
                           jref.Train(**TC), use_blockchain=True, seed=0)
    fed, tc = FederationConfig(**_fed_kw(async_mode)), TrainConfig(**TC)
    cfg = get_smoke_config(QWEN).replace(dtype=dtype)
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
def test_moe_protocol_matches_reference(runs, dtype, async_mode):
    jproto, proto, recs = runs(dtype, async_mode)
    if dtype == "float32":
        score_tol, loss_tol = PROTO_F32_TOL, [PROTO_F32_TOL] * ROUNDS
    else:
        # what bf16 alone moves each worker's post-step loss in the
        # reference: the same run in f32
        ref32 = runs("float32", async_mode)[2]
        score_tol = SCORE_TOL
        loss_tol = [PROTO_LOSS_TOL + np.abs(j.losses - j32.losses)
                    for (j, _), (j32, _) in zip(recs, ref32)]
    for (jrec, rec), ltol in zip(recs, loss_tol):
        np.testing.assert_allclose(rec.scores, jrec.scores, rtol=0,
                                   atol=score_tol)
        np.testing.assert_allclose(rec.weights, jrec.weights, rtol=0,
                                   atol=score_tol)
        assert np.all(np.abs(rec.losses - jrec.losses) <= ltol)
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
        if dtype == "float32":
            assert np.all(d <= 0.1 * TC["lr"])
            continue
        steps = PARAM_RTOL * np.abs(b)
        assert np.all(d <= steps + 6 * TC["lr"])
        if f32:
            assert np.mean(d > 2 * TC["lr"]) <= 0.01
        else:
            assert np.mean(d > steps + 1e-6) <= 0.03
    assert isinstance(proto.task.async_state.pending, dict) \
        if async_mode else proto.task.async_state is None


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_settlement_decisions_match_reference(runs, dtype, async_mode):
    jproto, proto, recs = runs(dtype, async_mode)
    js = np.stack([j.scores for j, _ in recs])
    assert np.abs(js - T_SPLIT).min() > SCORE_TOL, "scores too close to T"
    assert (js < T_SPLIT).any() and (js > T_SPLIT).any()
    mean = np.sort(js.mean(axis=0))[::-1]
    assert mean[TOP_K - 1] - mean[TOP_K] > SCORE_TOL, "too close at top-k"
    for j, r in recs:
        np.testing.assert_array_equal(j.scores < T_SPLIT, r.scores < T_SPLIT)
        np.testing.assert_array_equal(j.penalties, r.penalties)
    jc, c = jproto.contract, proto.contract
    np.testing.assert_array_equal(jc.stake, c.stake)
    np.testing.assert_array_equal(jc.balance, c.balance)
    assert jc.requester_balance == c.requester_balance
    assert proto.ledger.verify_chain(deep=True)


def test_moe_finalize_pays_the_same(runs):
    jproto, proto, _ = runs("bfloat16", False)
    assert proto.finalize() == jproto.finalize()


def test_train_launcher_runs_olmoe_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train --arch olmoe-1b-7b --device cpu
    --rounds 2``: its JSON lines (with the aux loss), a verified ledger,
    value conserved; ``--async`` runs the arrival scheduler's cohorts."""
    from repro_torch.launch import train
    assert OLMOE in train.TRAIN_ARCHS and QWEN in train.TRAIN_ARCHS
    for extra in ([], ["--async"]):
        out = train.main(["--arch", OLMOE, "--rounds", "2", "--device",
                          "cpu", "--batch", "4", "--seq", "64", *extra])
        proto = out["proto"]
        assert [e["round"] for e in out["log"]] == [1, 2]
        assert all(np.isfinite(e["loss"]) and e["aux"] > 0
                   for e in out["log"])
        assert len(proto.history) == 2 and proto.cfg.family == "moe"
        assert proto.ledger.verify_chain(deep=True)
        assert len(out["payouts"]) == 8
        if extra:
            assert all(r.participation is not None for r in proto.history)
    lines = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("ledger: 4 blocks, verified=True")
               for ln in lines) == 2


def test_federated_llm_example_runs_qwen2_moe(capsys):
    """The reference example's own call, ``--arch qwen2-moe-a2.7b``."""
    from repro_torch.examples import federated_llm
    assert QWEN in federated_llm.LLM_ARCHS
    out = federated_llm.main(arch=QWEN, rounds=2, device="cpu")
    assert out["verified"] and out["blocks"] == 4
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("round 1: mean_loss=")
    assert lines[-1] == "ledger verified: True"


def test_serve_runs_the_moe_smoke_configs_on_the_cpu(capsys):
    """``launch.serve`` over both MoE archs on the CPU: greedy tokens are the
    logits' argmax and repeat run to run."""
    from repro_torch.launch import serve as serve_mod
    for arch in (QWEN, OLMOE):
        kw = dict(batch=2, prompt_len=24, gen=4, device="cpu")
        r = serve_mod.serve(get_smoke_config(arch), **kw)
        assert r.tokens.shape == (2, 4)
        assert torch.equal(r.tokens, r.logits.float().argmax(-1))
        assert torch.equal(serve_mod.serve(get_smoke_config(arch),
                                           **kw).tokens, r.tokens)
    serve_mod.main(["--arch", QWEN, "--batch", "2", "--prompt-len", "16",
                    "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"arch={QWEN} B=2 prompt=16 gen=3"
