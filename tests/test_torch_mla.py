"""The port's Multi-head Latent Attention (minicpm3-4b) against the JAX
package on the CPU: ``layers.apply_mla`` in prefill (the direct and the
chunked attention core) and in its absorbed decode, the decoder's prefill
and greedy decode over the latent cache, the reference's
prefill→decode consistency run on the port, the LM loss and every leaf's
gradient (remat off and on), one ``make_fl_round`` round in both
packages, ``convert`` both ways and the serve CLI.

Config: minicpm3-4b's smoke config (2 layers, d 256, 4 heads, q rank 64,
latent rank 32, nope 32 + rope 16 head dims, v 32, vocab 512). Weights are
the JAX init, converted; every other input is made from a seed with numpy
and handed to both packages. The JAX package is imported through the
``jref`` fixture, the workaround for fault F1 of the reference (ROADMAP.md,
Queue 3; see ``tests/test_torch_serve.py``).

Tolerances, absolute (the losses' and gradients' and the round's as
stated):

  attention (one layer)   ATTN_TOL f32 2e-4, bf16 3e-2, as
                          ``tests/test_torch_serve.py``'s
  logits                  LOGIT_TOL f32 1e-4, bf16 0.125, as there
  loss                    LOSS_TOL f32 2e-5, bf16 2e-3, and gradients
                          GRAD_TOL · max|g| a leaf, f32 2e-5, bf16 5e-2,
                          as ``tests/test_torch_llm.py``'s
  prefill→decode          2e-2 of max|logit|, the reference's own
                          (``tests/test_arch_smoke.py``), f32
  round, f32              scores, weights and losses 1e-5, params 0.1 · lr,
                          as ``tests/test_torch_moe.py``'s protocol
  round, bf16             scores and weights 2e-3, losses 1e-2 (each
                          worker's loss after its step), as the MoE and
                          hybrid protocols' (``tests/test_torch_moe.py``);
                          params two bf16 steps plus 6 · lr, as
                          ``tests/test_torch_train.py``'s, with at most 1 %
                          of the elements above 64 · lr (where two bf16
                          steps exceed lr / 2) beyond the two steps, as
                          ``tests/test_torch_encdec.py``'s
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
from repro_torch.launch import serve as serve_mod
from repro_torch.models import api, layers, transformer

jax.config.update("jax_enable_x64", False)

ARCH = "minicpm3-4b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ATTN_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.125}
LOSS_TOL = {"float32": 2e-5, "bfloat16": 2e-3}
GRAD_TOL = {"float32": 2e-5, "bfloat16": 5e-2}
ROUND_TOL = {"float32": dict(score=1e-5, loss=1e-5),
             "bfloat16": dict(score=2e-3, loss=1e-2)}
LR = 3e-4


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
    from repro.core import fl_step as jfl_step
    from repro.models import api as japi
    from repro.models import layers as jlayers
    return types.SimpleNamespace(api=japi, layers=jlayers, fl_step=jfl_step,
                                 smoke=jsmoke, Fed=JFed, Train=JTrain)


@pytest.fixture(scope="module")
def models(jref):
    """(jax config, port config, JAX params, port params) of a dtype: the
    JAX init (seed 1), converted; made once a module. The bf16 init is the
    f32 one rounded (the reference draws in f32 and casts each leaf)."""
    jp32 = jax.jit(lambda k: jref.api.init(
        jref.smoke(ARCH).replace(dtype="float32"), k, tp=1)[0])(
            jax.random.PRNGKey(1))
    made = {}

    def get(dtype):
        if dtype not in made:
            jp = jax.tree.map(lambda x: x.astype(DTYPES[dtype][0]), jp32)
            made[dtype] = (jref.smoke(ARCH).replace(dtype=dtype),
                           get_smoke_config(ARCH).replace(dtype=dtype),
                           jp, convert.params_from_jax(
                               jax.tree.map(np.asarray, jp)))
        return made[dtype]
    return get


def _pair(x, dtype):
    """numpy f32 → (jax array, torch tensor) in ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _err(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def _layer(jp, p, cfg):
    """Layer 0's attention params in both packages."""
    return (jax.tree.map(lambda t: t[0], jp["layers"]["attn"]),
            transformer.all_layer_params(p, cfg)[0]["attn"])


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_chunk", [1024, 16], ids=["direct", "chunked"])
def test_mla_prefill_matches_reference(jref, models, dtype, kv_chunk):
    """Prefill: the direct attention core (64 keys) and the chunked one
    (four chunks of 16); the output and the cache entry (normed latent and
    roped key)."""
    jcfg, cfg, jp, p = models(dtype)
    jl, tl = _layer(jp, p, cfg)
    x = np.random.default_rng(2).standard_normal((2, 64, cfg.d_model)
                                                 ).astype(np.float32)
    jx, tx = _pair(x, dtype)
    kw = dict(num_heads=cfg.num_heads, mla=cfg.mla, rope_theta=cfg.rope_theta,
              kv_chunk=kv_chunk)
    jo, jkv = jax.jit(lambda lp, x: jref.layers.apply_mla(
        lp, x, positions=jnp.arange(64), return_kv=True, **kw))(jl, jx)
    o, kv = layers.apply_mla(tl, tx, positions=torch.arange(64), **kw)
    assert o.dtype == tx.dtype and kv["latent"].shape == (2, 64, 48)
    assert _err(o, jo) <= ATTN_TOL[dtype]
    assert _err(kv["latent"], jkv["latent"]) <= ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_absorbed_decode_matches_reference(jref, models, dtype):
    """The absorbed decode over a latent cache of 40 slots filled at random,
    at cur_index 23 (later slots masked): the output and the cache, whose
    slot 23 the port writes in place."""
    jcfg, cfg, jp, p = models(dtype)
    jl, tl = _layer(jp, p, cfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    lat = rng.standard_normal((2, 40, 48)).astype(np.float32)
    (jx, tx), (jc, tc) = _pair(x, dtype), _pair(lat, dtype)
    kw = dict(num_heads=cfg.num_heads, mla=cfg.mla, rope_theta=cfg.rope_theta,
              cur_index=23)
    jo, jnew = jax.jit(lambda lp, x, c: jref.layers.apply_mla(
        lp, x, positions=jnp.full((1,), 23), cache={"latent": c}, **kw))(
            jl, jx, jc)
    cache = {"latent": tc.clone()}
    o, new = layers.apply_mla(tl, tx, positions=torch.full((1,), 23),
                              cache=cache, **kw)
    assert new["latent"] is cache["latent"] and o.shape == (2, 1, 256)
    assert _err(o, jo) <= ATTN_TOL[dtype]
    assert _err(new["latent"], jnew["latent"]) <= ATTN_TOL[dtype]
    # only slot 23 moved
    moved = (new["latent"] != tc).any(dim=(0, 2)).nonzero().flatten()
    assert moved.tolist() == [23]


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(jref, models, dtype):
    """``api.prefill`` of a 24-token prompt and 4 decode steps: logits and
    the latent cache, (L, B, S, kv_lora_rank + rope_dim)."""
    jcfg, cfg, jp, p = models(dtype)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 28)
                                             ).astype(np.int32)
    jdecode = jax.jit(lambda p, c, t, i: jref.api.decode_step(p, jcfg, c, t,
                                                              i))
    jlg, jc = jax.jit(lambda p, t: jref.api.prefill(p, jcfg, {"tokens": t},
                                                    32))(jp, toks[:, :24])
    with torch.no_grad():
        lg, c = api.prefill(p, cfg, {"tokens": torch.from_numpy(toks[:, :24])},
                            32)
    assert c["latent"].shape == api.cache_shape(cfg, 2, 32)["latent"] == \
        (2, 2, 32, 48)
    errs = [_err(lg, jlg)]
    for t in range(24, 28):
        jlg, jc = jdecode(jp, jc, toks[:, t:t + 1], t)
        with torch.no_grad():
            lg, c = api.decode_step(p, cfg, c, torch.from_numpy(
                toks[:, t:t + 1]), t)
        errs.append(_err(lg, jlg))
    assert max(errs) <= LOGIT_TOL[dtype], errs
    # layer 0's latents come from the embeddings as in one layer's test;
    # layer 1's from a residual stream rounded to bf16 at other places
    assert _err(c["latent"][0], jc["latent"][0]) <= ATTN_TOL[dtype]
    assert _err(c["latent"], jc["latent"]) <= max(ATTN_TOL[dtype],
                                                  LOGIT_TOL[dtype])


def test_prefill_decode_matches_forward_on_the_port():
    """The reference's consistency check (``tests/test_arch_smoke.py``) on
    the port: prefill of 16 tokens and 4 absorbed decode steps against the
    full forward's logits at those positions, f32."""
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    params = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tk = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 32)))
    with torch.no_grad():
        last, cache = api.prefill(params, cfg, {"tokens": tk[:, :16]}, 32)
        steps = [last[:, 0]]
        for t in range(16, 20):
            lg, cache = api.decode_step(params, cfg, cache, tk[:, t:t + 1], t)
            steps.append(lg[:, 0])
        full, _ = api.forward(params, cfg, {"tokens": tk})
    ref = full[:, 15:20]
    dec = torch.stack(steps, dim=1)
    assert float((dec - ref).abs().max() / ref.abs().max()) < 0.02


def test_the_cache_holds_the_latent_only():
    """The cache a token is kv_lora_rank + rope_dim values a layer, not
    2 · heads · head_dim: 35.7 KB against 794 KB in bf16 at full size."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(ARCH)
    per_token = {k: s[0] * s[-1] * 2 for k, s in
                 api.cache_shape(cfg, 1, 1).items()}
    assert per_token == {"latent": 62 * 288 * 2}
    m = cfg.mla
    expanded = 62 * 2 * cfg.num_heads * (m.qk_nope_head_dim
                                         + m.qk_rope_head_dim) * 2
    assert per_token["latent"] == 35_712 and expanded == 952_320
    assert 62 * cfg.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim
                                 + m.v_head_dim) * 2 == 793_600


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

LM_CASES = [("float32", False), ("float32", True), ("bfloat16", False)]
_JAX_LOSS = {}


def _jax_loss_and_grads(jref, jcfg, jp, jb):
    """The reference's loss and gradients, once a dtype (the remat cases
    differ on the port's side only)."""
    if jcfg.dtype not in _JAX_LOSS:
        _JAX_LOSS[jcfg.dtype] = jax.jit(jax.value_and_grad(
            jref.api.loss_fn(jcfg, kv_chunk=32), has_aux=True))(jp, jb)
    return _JAX_LOSS[jcfg.dtype]


@pytest.mark.parametrize("dtype,remat", LM_CASES,
                         ids=["f32-plain", "f32-remat", "bf16-plain"])
def test_lm_loss_and_grads_match_reference(jref, models, dtype, remat):
    """B 2, S 96 with kv_chunk 32: the chunked attention under grad."""
    jcfg, cfg, jp, p = models(dtype)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 96)).astype(np.int32)
    labels = toks.copy()
    labels[:, -5:] = -100
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jl, _), jg = _jax_loss_and_grads(jref, jcfg, jp, jb)
    pr = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    loss, _ = api.lm_loss_fn(cfg, remat=remat, kv_chunk=32)(pr, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    g = dict(zip(pr, torch.autograd.grad(loss, list(pr.values()))))
    assert abs(float(loss) - float(jl)) <= LOSS_TOL[dtype]
    got = convert.params_to_jax(g)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, jg))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jg)):
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= GRAD_TOL[dtype] * np.abs(b).max()


def _round_batch(cfg, W, B, S, seed):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (W, 1, B, S)).astype(np.int32)
    return {"tokens": toks, "labels": toks.copy()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fl_round_matches_reference(jref, models, dtype):
    """One ``make_fl_round`` round (2 × 2 workers, batch 2, seq 64, AdamW
    lr 3e-4, clip 1.0, per-leaf) in both packages on the same batch:
    scores, weights, losses and the new global params."""
    jcfg, cfg, jp, p = models(dtype)
    fed_kw = dict(num_clusters=2, workers_per_cluster=2, trust_threshold=0.0)
    tc_kw = dict(optimizer="adamw", lr=LR, remat=False, grad_clip=1.0)
    jfed, jtc = jref.Fed(**fed_kw), jref.Train(**tc_kw)
    fed, tc = FederationConfig(**fed_kw), TrainConfig(**tc_kw)
    batch = _round_batch(cfg, 4, 2, 64, seed=7)
    jopt = jax.jit(lambda p: jref.fl_step.init_worker_opt(p, jfed, jtc))(jp)
    jout = jax.jit(jref.fl_step.make_fl_round(jcfg, jfed, jtc))(
        jp, jopt,
        {k: jnp.asarray(v) for k, v in batch.items()})
    out = fl_step.make_fl_round(cfg, fed, tc, device="cpu")(
        p, fl_step.init_worker_opt(p, fed, tc),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    _check_round(jout, out, dtype)


def _check_round(jout, out, dtype):
    tol = ROUND_TOL[dtype]
    for name in ("scores", "weights"):
        assert _err(getattr(out, name), getattr(jout, name)) <= tol["score"]
    assert _err(out.losses, jout.losses) <= tol["loss"]
    got = convert.params_to_jax(out.global_params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jout.global_params)):
        b = np.asarray(b, np.float32)
        d = np.abs(a - b)
        if dtype == "float32":
            assert d.max() <= 0.1 * LR
        else:
            steps = 2.0 ** -7 * np.abs(b)
            assert (d <= steps + 6 * LR).all()
            big = np.abs(b) > 64 * LR
            assert (d[big] > steps[big]).mean() <= 0.01 if big.any() else 1


# ---------------------------------------------------------------------------
# convert and the serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip_mla(models, dtype):
    """The MLA leaves carry over key for key both ways, and the port's own
    init has the reference's keys, shapes and dtypes."""
    jcfg, cfg, jp, p = models(dtype)
    assert {k for k in p if k.startswith("layers.attn.")} == {
        f"layers.attn.{n}" for n in ("wq_a", "q_a_norm", "wq_b", "wkv_a",
                                     "kv_a_norm", "wkv_b", "wo")}
    back = convert.params_to_jax(p)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    again = convert.params_from_jax(back)
    for k in p:
        assert torch.equal(again[k].to(p[k].dtype), p[k])
    mine = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in p.items()}


def test_serve_cli_runs_mla_on_cpu(capsys):
    serve_mod.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "16",
                    "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"arch={ARCH} B=2 prompt=16 gen=3"
    assert out[1].startswith("prefill:") and out[2].startswith("decode :")
    assert out[3].startswith("sample token ids:")
