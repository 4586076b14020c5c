"""The port's encoder-decoder (whisper-base, ``models/encdec.py``) against
the JAX package on the CPU: ``layers.layer_norm``, the GELU MLP (tanh
approximation), ``apply_gqa`` without a causal mask and over
``cross_kv``, ``encode``, ``decode_train`` on the encoder's states, the
prefill and greedy decode over the self and cross caches, the reference's
prefill→decode consistency run on the port, the LM loss and every leaf's
gradient (remat off and on), one ``make_fl_round`` round with frames in
both packages, ``convert`` both ways and the serve CLI.

Config: whisper-base's smoke config (2 encoder and 2 decoder layers,
encoder_seq 64, d 256, 4 heads of 64, d_ff 512, vocab 512). Weights are
the JAX init, converted; tokens and frames (the stub frontend's
embeddings) are made from a seed with numpy and handed to both packages.
The JAX package is imported through the ``jref`` fixture, the workaround
for fault F1 of the reference (ROADMAP.md, Queue 3; see
``tests/test_torch_serve.py``).

Tolerances, absolute (the gradients' and the round's as stated):

  layers, one block       ATTN_TOL f32 2e-4, bf16 3e-2, as
                          ``tests/test_torch_serve.py``'s attention
  encoder states          ATTN_TOL; in bf16 LOGIT_TOL: two layers round
                          their activations to bf16 at other places
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
                          hybrid protocols'; params two bf16 steps plus
                          6 · lr, as ``tests/test_torch_train.py``'s, and at
                          most 1 % of the elements above 64 · lr (where two
                          bf16 steps exceed lr / 2) beyond the two steps:
                          the zero-initialised biases sit at ~lr after a
                          step, where one worker's near-zero gradient
                          taking the other sign moves the mean by lr / 2
                          (measured: 0 of the large elements beyond; 33-42
                          % of each bias's elements, by ≤ 0.5 lr)
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
from repro_torch.models import api, encdec, layers
from repro_torch.models.transformer import layer_views

jax.config.update("jax_enable_x64", False)

ARCH = "whisper-base"
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
    from repro.models import encdec as jencdec
    from repro.models import layers as jlayers
    return types.SimpleNamespace(api=japi, layers=jlayers, encdec=jencdec,
                                 fl_step=jfl_step, smoke=jsmoke, Fed=JFed,
                                 Train=JTrain)


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


def _frames(cfg, B, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _dec_layer(jp, p, cfg, group):
    """Decoder layer 0's ``group`` params in both packages."""
    return (jax.tree.map(lambda t: t[0], jp["dec"][group]),
            layer_views(p, "dec.", cfg.num_layers)[0][group])


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_gelu_mlp_match_reference(jref, models, dtype):
    """LayerNorm with a nonzero bias on inputs off zero mean and unit
    scale, and the GELU MLP (``jax.nn.gelu``'s tanh approximation, not
    erf) with a N(0, 1) input bias, so its pre-activations reach its
    tails."""
    jcfg, cfg, jp, p = models(dtype)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 256)).astype(np.float32)
    w, b = (rng.standard_normal((2, 256)).astype(np.float32))
    (jx, tx), (jw, tw), (jb, tb) = (_pair(v, dtype) for v in (x, w, b))
    jx3, tx3 = _pair(3 * x + 0.5, dtype)
    assert _err(layers.layer_norm(tx3, tw, tb),
                jax.jit(jref.layers.layer_norm)(jx3, jw, jb)) <= ATTN_TOL[dtype]
    jm, m = _dec_layer(jp, p, cfg, "mlp")
    jm = dict(jm, b_in=jnp.asarray(rng.standard_normal(512), jm["b_in"].dtype))
    m = dict(m, b_in=torch.from_numpy(np.asarray(jm["b_in"], np.float32)
                                      ).to(m["b_in"].dtype))
    want = jax.jit(jref.layers.apply_gelu_mlp)(jm, jx)
    assert _err(layers.apply_gelu_mlp(m, tx), want) <= ATTN_TOL[dtype]
    if dtype == "float32":
        # the tanh approximation: erf's GELU fails the f32 tolerance
        h = tx @ m["w_in"] + m["b_in"]
        erf = torch.nn.functional.gelu(h) @ m["w_out"] + m["b_out"]
        assert _err(erf, want) > ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_without_causal_mask_matches_reference(jref, models, dtype):
    """The encoder's self-attention: every position sees every other, with
    RoPE; the direct core (64 keys) and the chunked one (chunks of 16)."""
    jcfg, cfg, jp, p = models(dtype)
    jl = jax.tree.map(lambda t: t[0], jp["enc"]["attn"])
    tl = layer_views(p, "enc.", cfg.encoder_layers)[0]["attn"]
    x = np.random.default_rng(3).standard_normal((2, 64, 256)
                                                 ).astype(np.float32)
    jx, tx = _pair(x, dtype)
    kw = dict(num_heads=4, num_kv_heads=4, head_dim=64,
              rope_theta=cfg.rope_theta, causal=False)
    for chunk in (1024, 16):
        want = jax.jit(lambda lp, x: jref.layers.apply_gqa(
            lp, x, positions=jnp.arange(64), kv_chunk=chunk, **kw))(jl, jx)
        got, _ = layers.apply_gqa(tl, tx, positions=torch.arange(64),
                                  kv_chunk=chunk, **kw)
        assert _err(got, want) <= ATTN_TOL[dtype], chunk
    causal, _ = layers.apply_gqa(tl, tx, positions=torch.arange(64),
                                 **dict(kw, causal=True))
    assert _err(causal, want) > 10 * ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(jref, models, dtype):
    """Decoder queries over 64 encoder states: neither q nor k roped, no
    mask; the output and the projected cross K/V."""
    jcfg, cfg, jp, p = models(dtype)
    jl, tl = _dec_layer(jp, p, cfg, "xattn")
    rng = np.random.default_rng(4)
    (jx, tx), (je, te) = (_pair(rng.standard_normal(s).astype(np.float32),
                                dtype) for s in ((2, 12, 256), (2, 64, 256)))
    kw = dict(num_heads=4, num_kv_heads=4, head_dim=64,
              rope_theta=cfg.rope_theta)
    jo, jkv = jax.jit(lambda lp, x, e: jref.layers.apply_gqa(
        lp, x, positions=jnp.arange(12), cross_kv=e, return_kv=True, **kw))(
            jl, jx, je)
    o, kv = layers.apply_gqa(tl, tx, positions=torch.arange(12),
                             cross_kv=te, **kw)
    assert kv["k"].shape == (2, 64, 4, 64)
    assert _err(o, jo) <= ATTN_TOL[dtype]
    for name in ("k", "v"):
        assert _err(kv[name], jkv[name]) <= ATTN_TOL[dtype]
    # positions move nothing on the cross path: no RoPE
    shifted, _ = layers.apply_gqa(tl, tx, positions=torch.arange(12) + 100,
                                  cross_kv=te, **kw)
    assert torch.equal(shifted, o)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_decode_train_match_reference(jref, models, dtype):
    """``encode`` of 64 frames (``enc_pos`` added), then ``decode_train``
    of 24 tokens over the encoder's states, each against the reference;
    the decoder runs on the reference's states, so its error is its own."""
    jcfg, cfg, jp, p = models(dtype)
    jf, tf = _pair(_frames(cfg, 2, 5), dtype)
    toks = np.random.default_rng(6).integers(0, 512, (2, 24)
                                             ).astype(np.int32)
    jenc = jax.jit(lambda p, f: jref.encdec.encode(p, jcfg, f))(jp, jf)
    with torch.no_grad():
        enc = encdec.encode(p, cfg, tf)
        assert enc.dtype == tf.dtype and enc.shape == (2, 64, 256)
        tol = ATTN_TOL[dtype] if dtype == "float32" else LOGIT_TOL[dtype]
        assert _err(enc, jenc) <= tol
        jlg, _ = jax.jit(lambda p, t, e: jref.encdec.decode_train(
            p, jcfg, t, e))(jp, toks, jenc)
        lg, aux = encdec.decode_train(p, cfg, torch.from_numpy(toks),
                                      torch.from_numpy(_np(jenc)).to(
                                          tf.dtype))
    assert aux == 0.0 and lg.shape == (2, 24, 512)
    assert _err(lg, jlg) <= LOGIT_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(jref, models, dtype):
    """``api.prefill`` of a 24-token prompt with frames and 4 decode steps
    (self-attention over the cache, cross-attention to the prefill's cross
    K/V): logits, and both caches."""
    jcfg, cfg, jp, p = models(dtype)
    jf, tf = _pair(_frames(cfg, 2, 7), dtype)
    toks = np.random.default_rng(8).integers(0, 512, (2, 28)
                                             ).astype(np.int32)
    jdecode = jax.jit(lambda p, c, t, i: jref.api.decode_step(p, jcfg, c, t,
                                                              i))
    jlg, jc = jax.jit(lambda p, t, f: jref.api.prefill(
        p, jcfg, {"tokens": t, "frames": f}, 32))(jp, toks[:, :24], jf)
    with torch.no_grad():
        lg, c = api.prefill(p, cfg, {"tokens": torch.from_numpy(toks[:, :24]),
                                     "frames": tf}, 32)
    assert {g: {k: tuple(v.shape) for k, v in leaves.items()}
            for g, leaves in c.items()} == api.cache_shape(cfg, 2, 32) == {
        "self": {"k": (2, 2, 32, 4, 64), "v": (2, 2, 32, 4, 64)},
        "cross_kv": {"k": (2, 2, 64, 4, 64), "v": (2, 2, 64, 4, 64)}}
    errs = [_err(lg, jlg)]
    for t in range(24, 28):
        jlg, jc = jdecode(jp, jc, toks[:, t:t + 1], t)
        with torch.no_grad():
            lg, c = api.decode_step(p, cfg, c, torch.from_numpy(
                toks[:, t:t + 1]), t)
        errs.append(_err(lg, jlg))
    assert max(errs) <= LOGIT_TOL[dtype], errs
    tol = ATTN_TOL[dtype] if dtype == "float32" else LOGIT_TOL[dtype]
    for g in ("self", "cross_kv"):
        for k in ("k", "v"):
            assert _err(c[g][k], jc[g][k]) <= tol, (g, k)


def test_prefill_decode_matches_forward_on_the_port():
    """The reference's consistency check (``tests/test_arch_smoke.py``) on
    the port: prefill of 16 tokens and 4 decode steps against the full
    forward's logits at those positions, f32."""
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    params = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tk = torch.from_numpy(np.random.default_rng(9).integers(0, 512, (2, 32)))
    fr = torch.from_numpy(_frames(cfg, 2, 10))
    with torch.no_grad():
        last, cache = api.prefill(params, cfg,
                                  {"tokens": tk[:, :16], "frames": fr}, 32)
        steps = [last[:, 0]]
        for t in range(16, 20):
            lg, cache = api.decode_step(params, cfg, cache, tk[:, t:t + 1], t)
            steps.append(lg[:, 0])
        full, _ = api.forward(params, cfg, {"tokens": tk, "frames": fr})
    ref = full[:, 15:20]
    dec = torch.stack(steps, dim=1)
    assert float((dec - ref).abs().max() / ref.abs().max()) < 0.02


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

LM_CASES = [("float32", False), ("float32", True), ("bfloat16", False)]
_JAX_LOSS = {}


@pytest.mark.parametrize("dtype,remat", LM_CASES,
                         ids=["f32-plain", "f32-remat", "bf16-plain"])
def test_lm_loss_and_grads_match_reference(jref, models, dtype, remat):
    """B 2, 40 tokens and 64 frames, kv_chunk 8: the decoder's chunked
    self-attention under grad; the tied head."""
    jcfg, cfg, jp, p = models(dtype)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 512, (2, 40)).astype(np.int32)
    labels = toks.copy()
    labels[:, -5:] = -100
    fr = _frames(cfg, 2, 12)
    jf, tf = _pair(fr, dtype)
    if dtype not in _JAX_LOSS:
        _JAX_LOSS[dtype] = jax.jit(jax.value_and_grad(
            jref.api.loss_fn(jcfg, kv_chunk=8), has_aux=True))(
                jp, {"tokens": toks, "labels": labels, "frames": jf})
    (jl, _), jg = _JAX_LOSS[dtype]
    pr = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    loss, _ = api.lm_loss_fn(cfg, remat=remat, kv_chunk=8)(pr, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
        "frames": tf})
    g = dict(zip(pr, torch.autograd.grad(loss, list(pr.values()))))
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_TOL[dtype]
    got = convert.params_to_jax(g)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, jg))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jg)):
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= GRAD_TOL[dtype] * np.abs(b).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fl_round_matches_reference(jref, models, dtype):
    """One ``make_fl_round`` round (2 × 2 workers, batch 2, 32 tokens and
    64 frames a sample, AdamW lr 3e-4, clip 1.0, per-leaf) in both
    packages on the same batch, frames sliced by worker: scores, weights,
    losses and the new global params."""
    jcfg, cfg, jp, p = models(dtype)
    fed_kw = dict(num_clusters=2, workers_per_cluster=2, trust_threshold=0.0)
    tc_kw = dict(optimizer="adamw", lr=LR, remat=False, grad_clip=1.0)
    jfed, jtc = jref.Fed(**fed_kw), jref.Train(**tc_kw)
    fed, tc = FederationConfig(**fed_kw), TrainConfig(**tc_kw)
    rng = np.random.default_rng(13)
    toks = rng.integers(0, 512, (4, 1, 2, 32)).astype(np.int32)
    fr = rng.standard_normal((4, 1, 2, cfg.encoder_seq, cfg.d_model)
                             ).astype(np.float32)
    jfr, tfr = _pair(fr, dtype)
    jopt = jax.jit(lambda p: jref.fl_step.init_worker_opt(p, jfed, jtc))(jp)
    jout = jax.jit(jref.fl_step.make_fl_round(jcfg, jfed, jtc))(
        jp, jopt,
        {"tokens": toks, "labels": toks, "frames": jfr})
    t = torch.from_numpy(toks)
    out = fl_step.make_fl_round(cfg, fed, tc, device="cpu")(
        p, fl_step.init_worker_opt(p, fed, tc),
        {"tokens": t, "labels": t, "frames": tfr})
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
def test_convert_round_trip_encdec(models, dtype):
    """whisper's tree (``enc.*``, ``dec.*``, ``enc_pos``, ``enc_norm.w/b``,
    ``dec_norm.w/b``) carries over key for key both ways, and the port's
    own init has the reference's keys, shapes and dtypes."""
    jcfg, cfg, jp, p = models(dtype)
    assert {k for k in p if not k.startswith(("enc.", "dec."))} == {
        "embed", "enc_pos", "enc_norm.w", "enc_norm.b", "dec_norm.w",
        "dec_norm.b"}
    assert p["dec.xattn.wq"].shape == (2, 256, 256)
    assert p["enc.ln1.b"].shape == (2, 256)
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


def test_serve_cli_runs_whisper_on_cpu(capsys):
    serve_mod.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "16",
                    "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"arch={ARCH} B=2 prompt=16 gen=3"
    assert out[1].startswith("prefill:") and out[2].startswith("decode :")
    assert out[3].startswith("sample token ids:")


def test_serve_draws_the_same_frames_on_every_device():
    """The frames come from a CPU generator of the seed, as the prompts:
    two serves of one seed emit the same tokens, another seed others."""
    cfg = get_smoke_config(ARCH)
    kw = dict(batch=2, prompt_len=8, gen=4, device="cpu")
    a, b = serve_mod.serve(cfg, **kw), serve_mod.serve(cfg, **kw)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.logits, b.logits)
    c = serve_mod.serve(cfg, seed=1, **kw)
    assert not torch.equal(c.logits, a.logits)
