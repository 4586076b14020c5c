"""The port's VLM family (chameleon-34b: the dense decoder fed early-fused
patch embeddings) against the JAX package on the CPU: ``embed_tokens``
with the stub VQ frontend's ``patch_embeds`` before the tokens, the full
forward, the prefill and greedy decode over a cache of P + prompt + gen
slots (decode indices counting the patches), the reference's
prefill→decode consistency run on the port, the LM loss (head
``lm_head``, the patch positions masked) and every leaf's gradient (remat
off and on), one sync and one async ``make_fl_round`` round at W = 4 in
both packages, ``convert`` both ways, ``serve`` drawing the same patches
on every device and the serve CLI.

Config: chameleon-34b's smoke config (2 layers, d 256, 8 heads and 2 KV
heads of 32, d_ff 512, vocab 512, 16 patch tokens). Weights are the JAX
init, converted; tokens, labels and patch embeddings are made from a seed
with numpy and handed to both packages. The JAX package is imported
through the ``jref`` fixture, the workaround for fault F1 of the
reference (ROADMAP.md, Queue 3; see ``tests/test_torch_serve.py``).

Tolerances, absolute (the gradients' and the round's as stated), those of
``tests/test_torch_encdec.py``:

  embeddings              exact: a lookup and a cast
  logits                  LOGIT_TOL f32 1e-4, bf16 0.125, as
                          ``tests/test_torch_serve.py``'s
  loss                    LOSS_TOL f32 2e-5, bf16 2e-3, and gradients
                          GRAD_TOL · max|g| a leaf, f32 2e-5, bf16 5e-2,
                          as ``tests/test_torch_llm.py``'s
  prefill→decode          2e-2 of max|logit|, the reference's own
                          (``tests/test_arch_smoke.py``), f32
  round, f32              scores, weights and losses 1e-5, params 0.1 · lr,
                          as ``tests/test_torch_moe.py``'s protocol
  round, bf16             scores and weights 2e-3, losses 1e-2, params two
                          bf16 steps plus 6 · lr with at most 1 % of the
                          elements above 64 · lr beyond the two steps, as
                          ``tests/test_torch_encdec.py``'s
"""
import subprocess
import sys
import types
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import FederationConfig, TrainConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core import fl_step
from repro_torch.launch import serve as serve_mod
from repro_torch.models import api, transformer

jax.config.update("jax_enable_x64", False)

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH = "chameleon-34b"
P = 16                                   # the smoke config's patch tokens
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
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
    from repro.models import transformer as jtransformer
    return types.SimpleNamespace(api=japi, transformer=jtransformer,
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


def _patches(B, seed, lead=()):
    """(*lead, B, P, d) f32 patch embeddings, normal, from numpy."""
    return np.random.default_rng(seed).standard_normal(
        lead + (B, P, 256)).astype(np.float32)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape
                                                ).astype(np.int32)


def test_smoke_and_full_configs_are_the_reference_s():
    cfg, full = get_smoke_config(ARCH), get_config(ARCH)
    assert cfg.family == full.family == "vlm"
    assert cfg.num_patch_tokens == P and cfg.attn_type == "gqa"
    assert (full.num_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.d_ff, full.vocab_size,
            full.num_patch_tokens, full.window, full.tie_embeddings) == (
                48, 8192, 64, 8, 22016, 65536, 256, 0, False)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_tokens_puts_the_patches_first(jref, models, dtype):
    """Early fusion: the patches (cast to the embedding's dtype) then the
    token rows, bit for bit the reference's."""
    jcfg, cfg, jp, p = models(dtype)
    toks = _tokens((2, 12), 2)
    jpe, tpe = _pair(_patches(2, 3), dtype)
    want = jax.jit(lambda p, t, e: jref.transformer.embed_tokens(
        p, jcfg, t, e))(jp, toks, jpe.astype(jnp.float32))
    got = transformer.embed_tokens(p, cfg, torch.from_numpy(toks),
                                   tpe.float())
    assert got.dtype == DTYPES[dtype][1] and got.shape == (2, P + 12, 256)
    assert _err(got, want) == 0.0
    assert torch.equal(got[:, :P], tpe.float().to(got.dtype))
    assert torch.equal(transformer.embed_tokens(p, cfg,
                                                torch.from_numpy(toks)),
                       got[:, P:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(jref, models, dtype):
    """``api.forward`` over 16 patches and 24 tokens: logits at all 40
    fused positions."""
    jcfg, cfg, jp, p = models(dtype)
    toks = _tokens((2, 24), 4)
    jpe, tpe = _pair(_patches(2, 5), dtype)
    jlg, _ = jax.jit(lambda p, t, e: jref.api.forward(
        p, jcfg, {"tokens": t, "patch_embeds": e}))(jp, toks, jpe)
    with torch.no_grad():
        lg, aux = api.forward(p, cfg, {"tokens": torch.from_numpy(toks),
                                       "patch_embeds": tpe})
    assert lg.shape == (2, P + 24, 512) and aux == 0.0
    assert _err(lg, jlg) <= LOGIT_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(jref, models, dtype):
    """``api.prefill`` of 16 patches and a 24-token prompt into a cache of
    P + 24 + 4 = 44 slots, then 4 decode steps at P + 24 … P + 27: logits
    and the K/V cache, whose first P + 24 slots the prefill fills."""
    jcfg, cfg, jp, p = models(dtype)
    toks = _tokens((2, 28), 6)
    jpe, tpe = _pair(_patches(2, 7), dtype)
    cache_len = P + 28
    jdecode = jax.jit(lambda p, c, t, i: jref.api.decode_step(p, jcfg, c, t,
                                                              i))
    jlg, jc = jax.jit(lambda p, t, e: jref.api.prefill(
        p, jcfg, {"tokens": t, "patch_embeds": e}, cache_len))(
            jp, toks[:, :24], jpe)
    with torch.no_grad():
        lg, c = api.prefill(p, cfg, {"tokens": torch.from_numpy(toks[:, :24]),
                                     "patch_embeds": tpe}, cache_len)
    assert {k: tuple(v.shape) for k, v in c.items()} == \
        api.cache_shape(cfg, 2, cache_len) == {"k": (2, 2, 44, 2, 32),
                                               "v": (2, 2, 44, 2, 32)}
    filled = (c["k"] != 0).any(dim=(0, 1, 3, 4))
    assert filled.nonzero().flatten().tolist() == list(range(P + 24))
    errs = [_err(lg, jlg)]
    for t in range(24, 28):
        jlg, jc = jdecode(jp, jc, toks[:, t:t + 1], P + t)
        with torch.no_grad():
            lg, c = api.decode_step(p, cfg, c, torch.from_numpy(
                toks[:, t:t + 1]), P + t)
        errs.append(_err(lg, jlg))
    assert max(errs) <= LOGIT_TOL[dtype], errs
    for k in ("k", "v"):
        assert _err(c[k], jc[k]) <= LOGIT_TOL[dtype], k


def test_prefill_decode_matches_forward_on_the_port():
    """The reference's consistency check (``tests/test_arch_smoke.py``) on
    the port: prefill of the patches and 16 tokens, then 4 decode steps at
    P + 16 …, against the full forward's logits at those positions, f32."""
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    params = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tk = torch.from_numpy(_tokens((2, 32), 9)).long()
    pe = torch.from_numpy(_patches(2, 10))
    with torch.no_grad():
        last, cache = api.prefill(params, cfg, {"tokens": tk[:, :16],
                                                "patch_embeds": pe}, P + 32)
        steps = [last[:, 0]]
        for t in range(16, 20):
            lg, cache = api.decode_step(params, cfg, cache, tk[:, t:t + 1],
                                        P + t)
            steps.append(lg[:, 0])
        full, _ = api.forward(params, cfg, {"tokens": tk,
                                            "patch_embeds": pe})
    ref = full[:, P + 15:P + 20]
    dec = torch.stack(steps, dim=1)
    assert float((dec - ref).abs().max() / ref.abs().max()) < 0.02


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

LM_CASES = [("float32", False), ("float32", True), ("bfloat16", False),
            ("bfloat16", True)]
_JAX_LOSS = {}


def _lm_batch(seed):
    toks = _tokens((2, 40), seed)
    labels = toks.copy()
    labels[:, -5:] = -100
    return toks, labels, _patches(2, seed + 1)


@pytest.mark.parametrize("dtype,remat", LM_CASES,
                         ids=["f32-plain", "f32-remat", "bf16-plain",
                              "bf16-remat"])
def test_lm_loss_and_grads_match_reference(jref, models, dtype, remat):
    """B 2, 16 patches and 40 tokens (the last 5 labels -100), kv_chunk 8:
    the chunked attention under grad, head ``lm_head``; the loss and every
    leaf's gradient against ``jax.value_and_grad`` of the reference's
    ``loss_fn``."""
    jcfg, cfg, jp, p = models(dtype)
    toks, labels, pe = _lm_batch(11)
    jpe, tpe = _pair(pe, dtype)
    if dtype not in _JAX_LOSS:
        _JAX_LOSS[dtype] = jax.jit(jax.value_and_grad(
            jref.api.loss_fn(jcfg, kv_chunk=8), has_aux=True))(
                jp, {"tokens": toks, "labels": labels, "patch_embeds": jpe})
    (jl, _), jg = _JAX_LOSS[dtype]
    pr = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    loss, _ = api.lm_loss_fn(cfg, remat=remat, kv_chunk=8)(pr, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
        "patch_embeds": tpe})
    g = dict(zip(pr, torch.autograd.grad(loss, list(pr.values()))))
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_TOL[dtype]
    got = convert.params_to_jax(g)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, jg))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jg)):
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= GRAD_TOL[dtype] * np.abs(b).max()


def test_lm_loss_masks_the_patch_positions(models):
    """The loss is the mean cross-entropy of the logits at fused positions
    P … P + 38 against the text's next tokens, nothing at the patches':
    taken from ``api.forward``'s logits by hand, it equals
    ``lm_loss_fn``'s; targets at offset 0 (the patches scored against the
    text) give another loss. f32."""
    _, cfg, _, p = models("float32")
    toks, labels, pe = _lm_batch(11)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels),
             "patch_embeds": torch.from_numpy(pe)}
    with torch.no_grad():
        loss, _ = api.lm_loss_fn(cfg, kv_chunk=8)(p, batch)
        lg, _ = api.forward(p, cfg, batch)
    tgt = torch.from_numpy(labels[:, 1:]).long()
    by_hand = torch.nn.functional.cross_entropy(
        lg[:, P:P + 39].reshape(-1, 512), tgt.reshape(-1),
        ignore_index=-100)
    assert abs(float(loss) - float(by_hand)) <= 1e-6
    unmasked = torch.nn.functional.cross_entropy(
        lg[:, :39].reshape(-1, 512), tgt.reshape(-1), ignore_index=-100)
    assert abs(float(unmasked) - float(loss)) > 1e-2


def test_chunked_loss_carries_the_offset_across_chunks(jref, models):
    """16 patches and 1008 tokens fill 1024 fused positions, two of the
    loss's 512-position chunks: the patch positions' -100 targets sit in
    the first; the loss and the lm_head's gradient against the
    reference's, f32."""
    jcfg, cfg, jp, p = models("float32")
    toks = _tokens((1, 1008), 13)
    pe = _patches(1, 14)
    jfn = jax.jit(jax.value_and_grad(jref.api.loss_fn(jcfg, kv_chunk=512),
                                     has_aux=True))
    (jl, _), jg = jfn(jp, {"tokens": toks, "labels": toks,
                           "patch_embeds": jnp.asarray(pe)})
    pr = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    loss, _ = api.lm_loss_fn(cfg, kv_chunk=512)(pr, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks),
        "patch_embeds": torch.from_numpy(pe)})
    (g,) = torch.autograd.grad(loss, [pr["lm_head"]])
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_TOL["float32"]
    want = np.asarray(jg["lm_head"])
    assert np.abs(g.numpy() - want).max() <= \
        GRAD_TOL["float32"] * np.abs(want).max()


ROUND_CASES = [("float32", False), ("float32", True), ("bfloat16", False),
               ("bfloat16", True)]
PARTICIPATION = np.array([1, 0, 1, 1], np.int32)


@pytest.mark.parametrize("dtype,async_mode", ROUND_CASES,
                         ids=["f32-sync", "f32-async", "bf16-sync",
                              "bf16-async"])
def test_fl_round_matches_reference(jref, models, dtype, async_mode):
    """One ``make_fl_round`` round (2 × 2 workers, batch 2, 16 patches and
    32 tokens a sample, AdamW lr 3e-4, clip 1.0, per-leaf) in both
    packages on the same batch, patches sliced by worker; async: workers
    1, 0, 1, 1 take part, from fresh async states. Scores, weights,
    losses and the new global params; async also the staleness and each
    pending update."""
    jcfg, cfg, jp, p = models(dtype)
    fed_kw = dict(num_clusters=2, workers_per_cluster=2, trust_threshold=0.0,
                  async_mode=async_mode)
    tc_kw = dict(optimizer="adamw", lr=LR, remat=False, grad_clip=1.0)
    jfed, jtc = jref.Fed(**fed_kw), jref.Train(**tc_kw)
    fed, tc = FederationConfig(**fed_kw), TrainConfig(**tc_kw)
    toks = _tokens((4, 1, 2, 32), 15)
    jpe, tpe = _pair(_patches(2, 16, lead=(4, 1)), dtype)
    jbatch = {"tokens": toks, "labels": toks, "patch_embeds": jpe}
    t = torch.from_numpy(toks)
    batch = {"tokens": t, "labels": t, "patch_embeds": tpe}
    jopt = jax.jit(lambda p: jref.fl_step.init_worker_opt(p, jfed, jtc))(jp)
    jfn = jax.jit(jref.fl_step.make_fl_round(jcfg, jfed, jtc))
    fn = fl_step.make_fl_round(cfg, fed, tc, device="cpu")
    opt = fl_step.init_worker_opt(p, fed, tc)
    if async_mode:
        jout, jst = jfn(jp, jopt, jbatch, None,
                        jnp.asarray(PARTICIPATION, jnp.float32),
                        jref.fl_step.init_async_state_for(jcfg, jfed, jp, 4))
        out, st = fn(p, opt, batch, None, torch.from_numpy(PARTICIPATION),
                     fl_step.init_async_state_for(cfg, fed, p, 4))
    else:
        jout, out = jfn(jp, jopt, jbatch), fn(p, opt, batch)
    tol = ROUND_TOL[dtype]
    for name in ("scores", "weights"):
        assert _err(getattr(out, name), getattr(jout, name)) <= tol["score"]
    assert _err(out.losses, jout.losses) <= tol["loss"]
    _check_params(convert.params_to_jax(out.global_params),
                  jout.global_params, dtype)
    if async_mode:
        # a pending update is the worker's new params less the global
        # ones: its gap is the new params' gap, held as they are
        assert st.staleness.tolist() == np.asarray(jst.staleness).tolist()
        assert st.staleness.tolist() == [0, 1, 0, 0]
        start = jax.tree.leaves(convert.params_to_jax(p))
        for w in range(4):
            mine = convert.params_to_jax({k: v[w]
                                          for k, v in st.pending.items()})
            theirs = jax.tree.map(lambda x: x[w], jst.pending)
            held = 0.0
            for a, b, g0 in zip(jax.tree.leaves(mine),
                                jax.tree.leaves(theirs), start):
                b = np.asarray(b, np.float32)
                held = max(held, float(np.abs(b).max()))
                if PARTICIPATION[w]:
                    assert not a.any() and not b.any()
                    continue
                bound = (0.1 * LR if dtype == "float32"
                         else 2.0 ** -7 * np.abs(g0) + 6 * LR)
                assert (np.abs(a - b) <= bound).all()
            assert (held > 0) == (not PARTICIPATION[w])


def _check_params(got, want_tree, dtype):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want_tree)):
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
# convert and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip_vlm(models, dtype):
    """chameleon's tree (the dense keys and an untied ``lm_head``) carries
    over key for key both ways, and the port's own init has the
    reference's keys, shapes and dtypes."""
    jcfg, cfg, jp, p = models(dtype)
    assert {k for k in p if not k.startswith("layers.")} == {
        "embed", "final_norm", "lm_head"}
    assert p["lm_head"].shape == (256, 512)
    assert p["layers.attn.wk"].shape == (2, 256, 64)
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


def test_serve_draws_the_same_patches_on_every_device():
    """The patches come from a CPU generator of seed + 2, as the prompts
    from seed + 1: two serves of one seed emit the same tokens, another
    seed others; the first token's logits are those of ``api.prefill``
    over those patches and prompts (cache P + prompt + gen)."""
    cfg = get_smoke_config(ARCH)
    kw = dict(batch=2, prompt_len=8, gen=4, device="cpu")
    a, b = serve_mod.serve(cfg, **kw), serve_mod.serve(cfg, **kw)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.logits, b.logits)
    c = serve_mod.serve(cfg, seed=1, **kw)
    assert not torch.equal(c.logits, a.logits)
    params = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    pe = torch.randn((2, P, 256), generator=torch.Generator().manual_seed(2)
                     ).to(getattr(torch, cfg.dtype))
    with torch.no_grad():
        lg, cache = api.prefill(params, cfg, {"tokens": a.prompts,
                                              "patch_embeds": pe}, P + 12)
    assert torch.equal(lg[:, -1], a.logits[:, 0])
    assert cache["k"].shape[2] == P + 12


def test_serve_cli_runs_chameleon_on_cpu():
    """``python -m repro_torch.launch.serve --arch chameleon-34b --device
    cpu`` at its defaults (batch 4, prompt 64, 32 tokens): the reference's
    lines."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == f"arch={ARCH} B=4 prompt=64 gen=32"
    assert lines[1].startswith("prefill:") and lines[2].startswith("decode :")
    assert lines[3].startswith("sample token ids:")
