"""The port's danube serve path against the JAX package at smoke size: the
K5 wrapper (its plain version on the CPU), the attention cores, the decoder
forward, prefill plus greedy decode across the sliding window, and the
weight conversion.

Config: h2o-danube-1.8b's smoke config (2 layers, d 256, GQA 8/2, hd 32,
window 64, vocab 512). Weights are the JAX init converted; every other input
is made from a seed with numpy and handed to both packages. The JAX model
API is imported through the ``jref`` fixture, the workaround for fault F1
of the reference (ROADMAP.md, Queue 3; see ``tests/test_torch_model.py``).

Tolerances, absolute:

  K5 and decode attention   f32 2e-4, bf16 3e-2: the reference's own
                            (``tests/test_kernels.py``); both sides are f32
                            inside and differ in summation order and, for
                            the model's decode, where bf16 rounds
  blocked attention         f32 1e-5, bf16 3e-2: same algorithm, outputs of
                            unit size
  logits                    f32 1e-4: two f32 stacks summing 256–512 terms
                            per product in different orders (measured
                            ~6e-6); bf16 0.125: logits reach ~4, where one
                            bf16 step is 1/32, and two layers round their
                            activations to bf16 at different places
                            (measured ~0.06)
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
from repro_torch.kernels import ref, swa_decode
from repro_torch.launch import serve as serve_mod
from repro_torch.models import api, layers, transformer

jax.config.update("jax_enable_x64", False)

ARCH = "h2o-danube-1.8b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ATTN_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.125}
PROMPT, STEPS = 80, 8          # decode runs cur = 80..87, past window 64


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
    from repro.kernels import ops as jops
    from repro.kernels import ref as jkref
    from repro.models import api as japi
    from repro.models import layers as jlayers
    return types.SimpleNamespace(api=japi, layers=jlayers, ops=jops,
                                 ref=jkref, smoke=jsmoke)


def _cfgs(jref, dtype):
    return (jref.smoke(ARCH).replace(dtype=dtype),
            get_smoke_config(ARCH).replace(dtype=dtype))


def _pair(x, dtype):
    """numpy f32 → (jax array, torch tensor) in ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _swa_inputs(B, H, KV, hd, S, dtype, seed=0):
    rng = np.random.default_rng(seed + S)
    return [_pair(rng.standard_normal(s).astype(np.float32), dtype)
            for s in ((B, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cur,window", [(0, 64), (63, 64), (64, 64),
                                        (511, 64), (300, 512)])
def test_swa_wrapper_matches_pallas_kernel(jref, dtype, cur, window):
    """Block-aligned S (512 = 2 blocks of 256): the Pallas kernel runs in
    interpret mode; cur below, at and past the window."""
    (jq, tq), (jk, tk), (jv, tv) = _swa_inputs(2, 8, 2, 32, 512, dtype)
    want = jref.ops._swa_decode(jq, jk, jv, cur, window=window, block_s=256,
                                interpret=True)
    got = swa_decode.swa_decode(tq, tk, tv, cur, window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,hd,S,window,cur", [
    (1, 1, 1, 16, 37, 16, 36), (3, 4, 1, 8, 300, 64, 299),
    (2, 8, 2, 32, 100, 1, 50)])
def test_swa_wrapper_matches_oracle_for_any_S(jref, dtype, B, H, KV, hd, S,
                                             window, cur):
    (jq, tq), (jk, tk), (jv, tv) = _swa_inputs(B, H, KV, hd, S, dtype)
    want = jref.ref.swa_decode_ref(jq, jk, jv, cur, window)
    got = swa_decode.swa_decode(tq, tk, tv, cur, window)
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_swa_wrapper_rejects_what_the_function_does_not_define():
    q, k, v = (torch.zeros(s) for s in ((1, 4, 8), (1, 10, 2, 8),
                                        (1, 10, 2, 8)))
    with pytest.raises(ValueError, match="cur_index"):
        swa_decode.swa_decode(q, k, v, 10, 4)
    with pytest.raises(ValueError, match="window"):
        swa_decode.swa_decode(q, k, v, 3, 0)
    with pytest.raises(TypeError):
        swa_decode.swa_decode(q, k.bfloat16(), v, 3, 4)
    with pytest.raises(ValueError, match="multiple"):
        swa_decode.swa_decode(torch.zeros(1, 3, 8), k, v, 3, 4)


def test_swa_head_widths_are_the_kernels_instantiations():
    """HEAD_DIMS lists the hd that csrc/swa_decode.cu is built for."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "swa_decode.cu").read_text()
    built = [int(h) for h in re.findall(r"^\s*REPRO_SWA_HD\((\d+)\);", src,
                                        re.M)]
    assert tuple(built) == swa_decode.HEAD_DIMS


@pytest.mark.parametrize("H,KV,hd,ok", [(32, 8, 80, True), (4, 2, 32, True),
                                        (32, 2, 80, True), (8, 2, 16, False),
                                        (8, 2, 96, False), (32, 32, 112, False),
                                        (34, 2, 80, False)])
def test_swa_card_path_takes_only_the_built_shapes(H, KV, hd, ok):
    """Before a launch the wrapper refuses what the kernel is not built
    for: hd outside HEAD_DIMS (zamba2's 112 among them) or more than MAX_G
    query rows per KV head."""
    q, k, v = torch.zeros(2, H, hd), torch.zeros(2, 40, KV, hd), \
        torch.zeros(2, 40, KV, hd)
    if ok:
        swa_decode._check_card(q, k, v)
    else:
        with pytest.raises(ValueError, match="the kernel takes"):
            swa_decode._check_card(q, k, v)


def test_swa_hbm_bytes_counts_the_window_only():
    b = swa_decode.hbm_bytes(4, 32, 8, 80, 4096, 5183, 2)
    assert b["kv_read"] == 2 * 4 * 8 * 4096 * 80 * 2      # ~42 MB per layer
    assert b["minimum"] == b["kv_read"] + 2 * 4 * 32 * 80 * 2
    # 8 chunks' f32 partials (m, l for 16 rows, acc (4, 80)), written and
    # read once: 1.6 % of the window's bytes
    assert b["total"] - b["minimum"] == 2 * 4 * 8 * 8 * (32 + 4 * 80) * 4
    early = swa_decode.hbm_bytes(4, 32, 8, 80, 4096, 99, 2)
    assert early["kv_read"] == 2 * 4 * 8 * 100 * 80 * 2
    assert early["total"] - early["minimum"] == 2 * 4 * 8 * 2 * 352 * 4
    short = swa_decode.hbm_bytes(4, 32, 8, 80, 4096, 7, 2)
    assert short["total"] == short["minimum"]       # one chunk: no partials


@pytest.mark.parametrize("window", [1, 2, 7, 8, 9, 63, 64, 65, 100, 255,
                                    256, 1000, 4095, 4096, 5000])
def test_swa_plan_covers_the_window_once_in_chunk_order(window):
    """K5's launch plan: chunks of whole 64-slot steps, none empty, at most
    MAX_CHUNKS blocks per (b, kv), that together take each slot of
    [max(cur - window + 1, 0), cur] once, in order."""
    for cur in sorted({0, 1, 3, 7, 8, window - 2, window - 1, window,
                       window + 1, 2 * window + 5, 5182} - {-1}):
        p = swa_decode.plan(cur, window)
        assert p.chunk % swa_decode.CHUNK_ALIGN == 0
        assert 1 <= p.nchunks <= swa_decode.MAX_CHUNKS
        slots = [pos for c in range(p.nchunks)
                 for pos in range(p.lo + c * p.chunk,
                                  min(p.lo + (c + 1) * p.chunk, cur + 1))]
        assert slots == list(range(max(cur - window + 1, 0), cur + 1))
        assert p.lo + (p.nchunks - 1) * p.chunk <= cur        # none empty


def test_swa_plan_at_the_serve_shape():
    """danube's last decode step: 4096 window slots in 8 chunks of 512 per
    (b, kv); a short window takes one chunk."""
    assert swa_decode.plan(5182, 4096) == (1087, 512, 8)
    assert swa_decode.plan(3, 4096) == (0, 64, 1)


# ---------------------------------------------------------------------------
# attention cores and small layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 64])
def test_decode_attention_matches_reference(jref, dtype, window):
    rng = np.random.default_rng(3)
    (jq, tq), = [_pair(rng.standard_normal((2, 1, 8, 32)).astype(np.float32),
                       dtype)]
    (jk, tk), (jv, tv) = [_pair(rng.standard_normal((2, 150, 2, 32)).astype(
        np.float32), dtype) for _ in range(2)]
    tol = ATTN_TOL[dtype]
    for cur in (0, 70, 149):
        want = jref.layers.decode_attention(jq, jk, jv, cur_index=cur,
                                            window=window)
        got = layers.decode_attention(tq, tk, tv, cur_index=cur,
                                      window=window)
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
        if window:        # the model's decode takes K5 for window > 0
            k5 = swa_decode.swa_decode(tq[:, 0], tk, tv, cur, window)
            np.testing.assert_allclose(_np(k5), _np(want)[:, 0], rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,kv_chunk,window", [
    (100, 1024, 0), (100, 1024, 16), (128, 32, 0), (128, 32, 40)])
def test_blocked_attention_matches_reference(jref, dtype, S, kv_chunk,
                                             window):
    """Both branches: direct (S <= kv_chunk) and chunked online softmax
    (S a multiple of kv_chunk), with and without a window."""
    rng = np.random.default_rng(S + window)
    (jq, tq), (jk, tk), (jv, tv) = [
        _pair(rng.standard_normal(s).astype(np.float32), dtype)
        for s in ((2, S, 8, 16), (2, S, 2, 16), (2, S, 2, 16))]
    pos = np.arange(S)
    want = jref.layers.blocked_attention(
        jq, jk, jv, q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
        causal=True, window=window, kv_chunk=kv_chunk)
    got = layers.blocked_attention(
        tq, tk, tv, q_positions=torch.from_numpy(pos),
        kv_positions=torch.from_numpy(pos), causal=True, window=window,
        kv_chunk=kv_chunk)
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_rms_norm_and_rope_match_reference(jref):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    pos = np.arange(3, 10)
    np.testing.assert_allclose(
        _np(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w))),
        _np(jref.layers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        _np(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              10_000.0)),
        _np(jref.layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                   10_000.0)),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

def _models(jref, dtype, seed=0):
    jcfg, cfg = _cfgs(jref, dtype)
    jp, _ = jref.api.init(jcfg, jax.random.PRNGKey(seed), tp=1)
    return jcfg, cfg, jp, convert.params_from_jax(jp)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_forward_logits_match_reference(jref, dtype):
    jcfg, cfg, jp, p = _models(jref, dtype)
    toks = _tokens(cfg, 2, 40, seed=1)
    want, _ = jref.api.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, _ = api.forward(p, cfg, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 40, cfg.vocab_size) and got.dtype == DTYPES[
        dtype][1]
    tol = LOGIT_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_greedy_decode_match_reference(jref, dtype):
    """Prefill an 80-token prompt, then 8 greedy decode steps across the
    64-slot window: logits and prefill cache within tolerance. Both models
    are fed the reference's greedy tokens, and the port's own greedy choice
    must equal the reference's wherever the reference's top-2 logit margin
    exceeds twice the tolerance, since a nearer tie may flip on rounding
    within it. In f32 that is every step; in bf16 at least a third of the
    (row, step) pairs."""
    jcfg, cfg, jp, p = _models(jref, dtype)
    toks = _tokens(cfg, 2, PROMPT, seed=0)
    L = PROMPT + STEPS
    jlg, jc = jref.api.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, L)
    tlg, tc = api.prefill(p, cfg, {"tokens": torch.from_numpy(toks).long()},
                          L)
    tol = LOGIT_TOL[dtype]
    assert tc["k"].shape == tuple(api.cache_shape(cfg, 2, L)["k"])
    assert tc["k"].dtype == DTYPES[dtype][1]
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), rtol=0,
                                   atol=tol)
    before = swa_decode.swa_decode.launches
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
        out_cache = tc
        tlg, tc = api.decode_step(p, cfg, tc, torch.from_numpy(jt).long(),
                                  PROMPT + step)
        assert tc["k"] is out_cache["k"]           # written in place
    compared = np.stack(compared)
    assert compared.all() if dtype == "float32" else \
        compared.sum() >= compared.size // 3
    assert swa_decode.swa_decode.launches == before   # CPU: plain version


def test_serve_runs_greedy_and_sampled_on_cpu(jref):
    """``serve`` end to end on the CPU: greedy output is its logits'
    argmax and repeats run to run; sampling at a temperature is seeded."""
    cfg = get_smoke_config(ARCH)
    kw = dict(batch=2, prompt_len=PROMPT, gen=6, device="cpu")
    r = serve_mod.serve(cfg, **kw)
    assert r.tokens.shape == (2, 6) and r.logits.shape == (2, 6, 512)
    assert torch.equal(r.tokens, r.logits.float().argmax(-1))
    assert torch.equal(serve_mod.serve(cfg, **kw).tokens, r.tokens)
    hot = [serve_mod.serve(cfg, temperature=1.0, **kw).tokens
           for _ in range(2)]
    assert torch.equal(hot[0], hot[1])
    assert r.prefill_s > 0 and r.decode_s > 0


def test_serve_cli_prints_the_reference_lines(capsys):
    serve_mod.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "16",
                    "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"arch={ARCH} B=2 prompt=16 gen=3"
    assert out[1].startswith("prefill:") and out[2].startswith("decode :")
    assert out[3].startswith("sample token ids:")


def test_registry_holds_only_ported_archs(jref):
    """Every arch of the reference is ported: the port's ``ARCH_IDS`` is
    the reference's, in its order, and an unknown arch raises."""
    from repro.configs.registry import ARCH_IDS as JARCH_IDS
    assert ARCH_IDS == JARCH_IDS and len(ARCH_IDS) == 10
    assert ARCH in ARCH_IDS and "paper-net" not in ARCH_IDS
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.resolved_head_dim, full.window) == (24, 2560, 32, 8, 80,
                                                     4096)
    sm, yi = get_config("smollm-135m"), get_config("yi-6b")
    assert (sm.num_layers, sm.d_model, sm.num_heads, sm.num_kv_heads,
            sm.d_ff, sm.vocab_size, sm.tie_embeddings) == (
                30, 576, 9, 3, 1536, 49152, True)
    assert (yi.num_layers, yi.d_model, yi.num_kv_heads, yi.rope_theta,
            yi.window) == (32, 4096, 4, 5_000_000.0, 0)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip_decoder(jref, dtype):
    jcfg, cfg, jp, p = _models(jref, dtype, seed=3)
    flat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    assert len(p) == len(flat) == 12
    torch_dt = DTYPES[dtype][1]
    for k, v in p.items():
        assert v.dtype == torch_dt
    back = convert.params_to_jax(p)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    again = convert.params_from_jax(back)
    for k in p:
        torch.testing.assert_close(again[k].to(torch_dt), p[k], rtol=0,
                                   atol=0)
    # the port's own init has the reference's keys, shapes and dtypes
    mine = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in p.items()}
    assert transformer.all_layer_params(mine, cfg)[1]["attn"]["wq"].shape \
        == (256, 256)
