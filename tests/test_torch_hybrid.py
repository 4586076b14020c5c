"""The port's zamba2 serve path against the JAX package at smoke size: the
hybrid's forward logits, prefill (logits and every cache leaf) and greedy
decode, the serve entry point and CLI on the CPU, and the weight conversion
of the hybrid tree.

Configs: zamba2-7b's smoke config (2 Mamba2 layers in one super-layer with
the shared block, no tail: the reference then keeps a zeros tail cache) and
a 3-layer variant with one tail layer; d 256, 4 heads of 64, SSD state 16,
chunk 64, vocab 512. Weights are the JAX init converted; prompts are made
from a seed with numpy and handed to both packages. The JAX model API is
imported through the ``jref`` fixture, the workaround for fault F1 of the
reference (ROADMAP.md, Queue 3; see ``tests/test_torch_serve.py``).

Tolerances, absolute:

  logits          f32 1e-4 (measured ≤ 7e-6: f32 sums of 256–512 terms in
                  other orders); bf16 0.125 (logits reach ~4.3, where a
                  bf16 step is 1/32, and the layers round their activations
                  to bf16 at other places; measured ≤ 0.08)
  cache leaves    f32 1e-4 (measured ≤ 7e-6); bf16 model: the f32 ``ssm``
                  states 1e-2 (measured ≤ 3.2e-3), the bf16 conv and K/V
                  leaves 0.125 (values reach ~4; measured ≤ 0.0625)
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
from repro_torch.models import api, hybrid

jax.config.update("jax_enable_x64", False)

ARCH = "zamba2-7b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.125}
CACHE_TOL = {"float32": {"ssm": 1e-4, "other": 1e-4},
             "bfloat16": {"ssm": 1e-2, "other": 0.125}}
PROMPT, STEPS = 128, 6          # two 64-position SSD chunks, then decode


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


def _models(jref, dtype, num_layers, seed=0):
    jcfg = jref.smoke(ARCH).replace(dtype=dtype, num_layers=num_layers)
    cfg = get_smoke_config(ARCH).replace(dtype=dtype, num_layers=num_layers)
    jp, _ = jref.api.init(jcfg, jax.random.PRNGKey(seed), tp=1)
    return jcfg, cfg, jp, convert.params_from_jax(jp)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _check_cache(tc, jc, dtype):
    """Every leaf of the port's nested cache against the reference's:
    same groups, names, shapes and dtypes, values within tolerance."""
    assert set(tc) == set(jc) == {"super_ssm", "tail_ssm", "shared_attn"}
    for group in jc:
        assert set(tc[group]) == set(jc[group])
        for name, want in jc[group].items():
            got = tc[group][name]
            assert tuple(got.shape) == tuple(want.shape), (group, name)
            assert got.dtype == (torch.float32 if name == "ssm"
                                 else DTYPES[dtype][1]), (group, name)
            tol = CACHE_TOL[dtype]["ssm" if name == "ssm" else "other"]
            np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol,
                                       err_msg=f"{group}.{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_layers", [2, 3])
def test_hybrid_forward_logits_match_reference(jref, dtype, num_layers):
    jcfg, cfg, jp, p = _models(jref, dtype, num_layers)
    per_layer = sum(key.startswith("super.") for key in p)
    assert sum(key.startswith("tail.") for key in p) == \
        per_layer * (num_layers - 2)
    toks = _tokens(cfg, 2, PROMPT, seed=1)
    want, _ = jref.api.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    before = ssd_scan.ssd_scan.launches
    got, _ = api.forward(p, cfg, {"tokens": torch.from_numpy(toks).long()})
    assert ssd_scan.ssd_scan.launches == before      # CPU: plain version
    assert got.shape == (2, PROMPT, cfg.vocab_size)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=LOGIT_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_layers", [2, 3])
def test_hybrid_prefill_and_greedy_decode_match_reference(jref, dtype,
                                                          num_layers):
    """Prefill a 128-token prompt, then 6 greedy decode steps: logits and
    every cache leaf after the prefill and after the last step. Both models
    are fed the reference's greedy tokens; the port's own choice must equal
    the reference's wherever the reference's top-2 margin exceeds twice the
    logit tolerance (a nearer tie may flip on rounding within it): every
    step in f32, at least a third of the (row, step) pairs in bf16."""
    jcfg, cfg, jp, p = _models(jref, dtype, num_layers)
    toks = _tokens(cfg, 2, PROMPT, seed=0)
    L = PROMPT + STEPS
    jlg, jc = jref.api.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, L)
    tlg, tc = api.prefill(p, cfg, {"tokens": torch.from_numpy(toks).long()},
                          L)
    shapes = api.cache_shape(cfg, 2, L)
    assert {g: {n: tuple(t.shape) for n, t in leaves.items()}
            for g, leaves in tc.items()} == shapes
    _check_cache(tc, jc, dtype)
    tol = LOGIT_TOL[dtype]
    compared = []
    for step in range(STEPS + 1):
        np.testing.assert_allclose(_np(tlg), _np(jlg), rtol=0, atol=tol)
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
        for (g, n), t in leaves.items():          # written in place
            assert tc[g][n] is t
    _check_cache(tc, jc, dtype)
    compared = np.stack(compared)
    assert compared.all() if dtype == "float32" else \
        compared.sum() >= compared.size // 3


def test_zamba_serve_runs_greedy_on_cpu_without_k5():
    """``serve`` end to end on the CPU: greedy output is its logits' argmax
    and repeats run to run; the shared block (window 0) takes the plain
    decode attention, never K5."""
    cfg = get_smoke_config(ARCH)
    assert cfg.window == 0
    kw = dict(batch=2, prompt_len=PROMPT, gen=5, device="cpu")
    before = (swa_decode.swa_decode.launches, ssd_scan.ssd_scan.launches)
    r = serve_mod.serve(cfg, **kw)
    assert r.tokens.shape == (2, 5) and r.logits.shape == (2, 5, 512)
    assert torch.equal(r.tokens, r.logits.float().argmax(-1))
    assert torch.equal(serve_mod.serve(cfg, **kw).tokens, r.tokens)
    assert (swa_decode.swa_decode.launches,
            ssd_scan.ssd_scan.launches) == before


@pytest.mark.parametrize("prompt_len", [80, 200])
def test_zamba_serve_rejects_a_prompt_of_partial_chunks(prompt_len):
    """The prefill scans whole chunks of min(chunk_size, prompt_len): 80
    and 200 are no multiple of the smoke config's 64 (a 40-token prompt,
    one short chunk, is fine)."""
    cfg = get_smoke_config(ARCH)
    with pytest.raises(ValueError, match="whole chunks"):
        serve_mod.serve(cfg, batch=1, prompt_len=prompt_len, gen=1,
                        device="cpu")
    r = serve_mod.serve(cfg, batch=1, prompt_len=40, gen=2, device="cpu")
    assert r.tokens.shape == (1, 2)


def test_zamba_serve_cli_prints_the_reference_lines(capsys):
    serve_mod.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "64",
                    "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"arch={ARCH} B=2 prompt=64 gen=3"
    assert out[1].startswith("prefill:") and out[2].startswith("decode :")
    assert out[3].startswith("sample token ids:")


def test_registry_holds_zamba2_at_its_published_size():
    assert ARCH in ARCH_IDS
    full = get_config(ARCH)
    assert (full.family, full.num_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.resolved_head_dim, full.d_ff,
            full.shared_attn_every) == ("hybrid", 81, 3584, 32, 32, 112,
                                        14336, 6)
    assert (full.ssm.state_dim, full.ssm.chunk_size, full.ssm.expand) == \
        (64, 128, 2)
    k, n_super, n_tail = hybrid._split_layers(full)
    assert (k, n_super, n_tail) == (6, 13, 3)


@pytest.mark.parametrize("num_layers", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip_hybrid(jref, dtype, num_layers):
    """``params_to_jax(params_from_jax(t))`` equals ``t`` leaf for leaf:
    ``tail`` a list (empty without a tail layer), ``super``'s leaves on
    their (n_super, k) axes; and the port's own init has the converted
    keys, shapes and dtypes."""
    jcfg, cfg, jp, p = _models(jref, dtype, num_layers, seed=3)
    assert isinstance(jp["tail"], list) and len(jp["tail"]) == num_layers - 2
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(p) == len(flat)
    assert p["super.mamba.w_x"].shape == (1, 2, 256, 512)
    torch_dt = DTYPES[dtype][1]
    back = convert.params_to_jax(p)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    assert isinstance(back["tail"], list)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    again = convert.params_from_jax(back)
    for k in p:
        assert again[k].dtype == p[k].dtype or p[k].dtype == torch_dt
        torch.testing.assert_close(again[k].to(p[k].dtype), p[k], rtol=0,
                                   atol=0)
    mine = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in p.items()}
