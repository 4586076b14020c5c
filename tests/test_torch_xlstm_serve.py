"""The port's xLSTM serve path (the ``ssm`` family) against the JAX package
on the CPU: the stack's forward, prefill (logits and every cache leaf) and
greedy decode, the decode cache's leaf dtypes, the weight conversion of the
xLSTM tree, the serve entry point and CLI, the training entry points that
take the family, and the registry. ``tests/test_torch_xlstm.py`` holds the
blocks.

Configs: xlstm-1.3b's smoke config (one super-layer of one mLSTM and one
sLSTM block, d 256, 4 heads, mLSTM heads of dh 128 with chunk 64, vocab
512) and a variant of two super-layers. Weights are the JAX init
converted; prompts come from a numpy seed. The JAX package is imported
through the ``jref`` fixture, the workaround for fault F1 of the reference
(ROADMAP.md, Queue 3; see ``tests/test_torch_hybrid.py``).

Tolerances, absolute (the hybrid's, ``tests/test_torch_hybrid.py``):

  logits          f32 1e-4; bf16 0.125 (a bf16 step at |logit| ~ 4 is
                  1/32, and the blocks round their activations to bf16 at
                  other places than XLA); the forward's logits at every
                  position in bf16: 0.125 plus the reference's own
                  bf16-vs-f32 gap
  cache leaves    f32 1e-4; bf16 model: the f32 recurrent states (``ssm``,
                  ``c``, ``n``, ``h``, ``m``) 1e-2 of their largest value,
                  the bf16 conv tails 0.125
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.registry import ARCH_IDS, get_config, \
    get_smoke_config
from repro_torch.kernels import ssd_scan, swa_decode
from repro_torch.launch import serve as serve_mod
from repro_torch.models import api, xlstm

jax.config.update("jax_enable_x64", False)

ARCH = "xlstm-1.3b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.125}
CACHE_TOL = {"float32": {"state": 1e-4, "other": 1e-4},
             "bfloat16": {"state": 1e-2, "other": 0.125}}
F32_LEAVES = ("ssm", "c", "n", "h", "m")
PROMPT, STEPS = 128, 4          # two 64-position chunks, then decode


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
    from repro.configs.registry import get_smoke_config as jsmoke
    from repro.models import api as japi
    return types.SimpleNamespace(api=japi, smoke=jsmoke)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what, rel=False):
    want = _np(want)
    atol = tol * max(np.abs(want).max(), 1e-30) if rel else tol
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=atol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------

def _models(jref, dtype, num_layers, seed=0):
    jcfg = jref.smoke(ARCH).replace(dtype=dtype, num_layers=num_layers)
    cfg = get_smoke_config(ARCH).replace(dtype=dtype, num_layers=num_layers)
    jp, _ = jref.api.init(jcfg, jax.random.PRNGKey(seed), tp=1)
    return jcfg, cfg, jp, convert.params_from_jax(jp)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _check_cache(tc, jc, dtype):
    assert set(tc) == set(jc) == {"m", "s"}
    assert set(tc["m"]) == {"ssm", "conv"}
    assert set(tc["s"]) == {"c", "n", "h", "m"}
    for group in jc:
        for name, want in jc[group].items():
            got = tc[group][name]
            assert tuple(got.shape) == tuple(want.shape), (group, name)
            state = name in F32_LEAVES
            assert got.dtype == (torch.float32 if state
                                 else DTYPES[dtype][1]), (group, name)
            tol = CACHE_TOL[dtype]["state" if state else "other"]
            _close(got, want, tol, f"{group}.{name}",
                   state and dtype == "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_forward_logits_match_reference(jref, dtype):
    """Every position's logits. In bf16 the tolerance is widened by the
    reference's own bf16-vs-f32 gap on the logits (its f32 run on the same
    bf16 weights), as for the MoE models: over 128 positions the two bf16
    runs each stray up to ~0.27 from f32 (measured 0.267 for the
    reference, 0.248 for the port, 0.234 between them)."""
    jcfg, cfg, jp, p = _models(jref, dtype, 2)
    toks = _tokens(cfg, 2, PROMPT, seed=1)
    want, _ = jref.api.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = api.forward(p, cfg, {"tokens": torch.from_numpy(toks).long()})
    assert aux == 0.0
    assert got.shape == (2, PROMPT, cfg.vocab_size)
    assert got.dtype == DTYPES[dtype][1]
    gap = 0.0
    if dtype == "bfloat16":
        jp32 = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
        want32, _ = jref.api.forward(jp32, jcfg.replace(dtype="float32"),
                                     {"tokens": jnp.asarray(toks)})
        gap = float(np.abs(_np(want) - _np(want32)).max())
    _close(got, want, LOGIT_TOL[dtype] + gap, "logits")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_layers", [2, 4])
def test_xlstm_prefill_and_greedy_decode_match_reference(jref, dtype,
                                                         num_layers):
    """Prefill a 128-token prompt, then greedy decode steps: logits and
    every cache leaf after the prefill and after the last step. Both models
    are fed the reference's greedy tokens; the port's own choice must equal
    the reference's wherever the reference's top-2 margin exceeds twice the
    logit tolerance: every step in f32, at least a third of the (row, step)
    pairs in bf16. The port writes its cache in place."""
    jcfg, cfg, jp, p = _models(jref, dtype, num_layers)
    toks = _tokens(cfg, 2, PROMPT, seed=0)
    L = PROMPT + STEPS
    jlg, jc = jref.api.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, L)
    tlg, tc = api.prefill(p, cfg, {"tokens": torch.from_numpy(toks).long()},
                          L)
    assert {g: {n: tuple(t.shape) for n, t in leaves.items()}
            for g, leaves in tc.items()} == api.cache_shape(cfg, 2, L)
    _check_cache(tc, jc, dtype)
    tol = LOGIT_TOL[dtype]
    compared = []
    for step in range(STEPS + 1):
        _close(tlg, jlg, tol, f"logits {step}")
        top2 = np.sort(_np(jlg)[:, -1], axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * tol
        jt = np.array(jnp.argmax(jlg[:, -1], -1)[:, None], np.int32)
        tt = tlg[:, -1].float().argmax(-1, keepdim=True).numpy()
        np.testing.assert_array_equal(tt[clear], jt[clear])
        compared.append(clear)
        if step == STEPS:
            break
        jlg, jc = jref.api.decode_step(jp, jcfg, jc, jnp.asarray(jt),
                                       PROMPT + step)
        leaves = {(g, n): t for g in tc for n, t in tc[g].items()}
        tlg, tc = api.decode_step(p, cfg, tc, torch.from_numpy(jt).long(),
                                  PROMPT + step)
        for (g, n), t in leaves.items():
            assert tc[g][n] is t
    _check_cache(tc, jc, dtype)
    compared = np.stack(compared)
    assert compared.all() if dtype == "float32" else \
        compared.sum() >= compared.size // 3


def test_make_cache_has_the_reference_leaf_dtypes(jref):
    cfg = get_smoke_config(ARCH).replace(dtype="bfloat16")
    jcfg = jref.smoke(ARCH).replace(dtype="bfloat16")
    tc = api.make_cache(cfg, 3, 70, "cpu")
    jc = jref.api.make_cache(jcfg, 3, 70)
    for g in jc:
        for n, want in jc[g].items():
            assert tuple(tc[g][n].shape) == tuple(want.shape)
            assert str(tc[g][n].dtype).split(".")[-1] == str(want.dtype)
            assert not tc[g][n].any()


# ---------------------------------------------------------------------------
# conversion, entry points, registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip_xlstm(jref, dtype):
    """``params_to_jax(params_from_jax(t))`` equals ``t`` leaf for leaf,
    bf16 bit for bit: ``super.m``'s leaves on their (n_super, n_m) axes,
    ``super.s``'s on (n_super,), no ``tail``; and the port's own init has
    the converted keys, shapes and dtypes."""
    jcfg, cfg, jp, p = _models(jref, dtype, 4, seed=3)
    assert p["super.m.mlstm.w_up"].shape == (2, 1, 256, 1024)
    assert p["super.s.slstm.r_gates"].shape == (2, 4, 64, 256)
    assert p["super.m.mlstm.w_f"].dtype == torch.float32
    back = convert.params_to_jax(p)
    assert "tail" not in back
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    again = convert.params_from_jax(back)
    for k in p:
        torch.testing.assert_close(again[k].to(p[k].dtype), p[k], rtol=0,
                                   atol=0)
    mine = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in p.items()}


def test_xlstm_serve_runs_greedy_on_cpu_without_kernels():
    cfg = get_smoke_config(ARCH)
    kw = dict(batch=2, prompt_len=PROMPT, gen=4, device="cpu")
    before = (swa_decode.swa_decode.launches, ssd_scan.ssd_scan.launches)
    r = serve_mod.serve(cfg, **kw)
    assert r.tokens.shape == (2, 4) and r.logits.shape == (2, 4, 512)
    assert torch.equal(r.tokens, r.logits.float().argmax(-1))
    assert torch.equal(serve_mod.serve(cfg, **kw).tokens, r.tokens)
    assert (swa_decode.swa_decode.launches,
            ssd_scan.ssd_scan.launches) == before
    with pytest.raises(ValueError, match="whole chunks"):
        serve_mod.serve(cfg, batch=1, prompt_len=80, gen=1, device="cpu")


def test_xlstm_serve_cli_prints_the_reference_lines(capsys):
    serve_mod.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "64",
                    "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"arch={ARCH} B=2 prompt=64 gen=3"
    assert out[1].startswith("prefill:") and out[2].startswith("decode :")
    assert out[3].startswith("sample token ids:")


def test_xlstm_is_a_train_arch():
    """xLSTM trains through the launcher and the example (its loss and
    gradients against the reference: ``tests/test_torch_xlstm_train.py``)."""
    from repro_torch.examples import federated_llm
    from repro_torch.launch import train
    assert ARCH in train.TRAIN_ARCHS and ARCH in federated_llm.LLM_ARCHS
    assert callable(api.lm_loss_fn(get_smoke_config(ARCH)))


def test_registry_holds_xlstm_at_its_published_size():
    assert ARCH in ARCH_IDS
    full = get_config(ARCH)
    assert (full.family, full.num_layers, full.d_model, full.num_heads,
            full.vocab_size, full.slstm_every) == ("ssm", 48, 2048, 4,
                                                   50304, 8)
    assert (full.ssm.expand, full.ssm.num_ssm_heads, full.ssm.chunk_size,
            full.ssm.conv_width) == (2, 4, 256, 4)
    assert xlstm._split_layers(full) == (7, 6)
    shapes = api.cache_shape(full, 4, 1056)
    assert shapes["m"]["ssm"] == (6, 7, 4, 4, 1024, 1025)
    assert shapes["s"]["m"] == (6, 4, 4)
