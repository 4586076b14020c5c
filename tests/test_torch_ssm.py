"""The port's Mamba2 path against the JAX package at small size: K4's plain
version (what the ``ssd_scan`` wrapper runs on the CPU) against the
reference's ``chunked_decay_attention``, its Pallas kernel in interpret mode
and the strict recurrence; the card tolerance against planted faults; and
the Mamba2 block — decode step, causal conv, prefill and decode — on
converted weights.

Inputs are made from a seed with numpy and handed to both packages; q and k
are head-stride-0 views, as Mamba2 passes them. The JAX model modules are
imported through the ``jref`` fixture, the workaround for fault F1 of the
reference (ROADMAP.md, Queue 3; see ``tests/test_torch_serve.py``).

Tolerances, absolute and relative:

  K4's plain version    f32 3e-4, bf16 5e-2: the reference's own
                        (``tests/test_kernels.py``); strict recurrence 2e-4
  Mamba2 block          f32 1e-5 on outputs of unit size (the two sum
                        256–512 products in different orders; measured
                        ~1e-6); bf16 5e-2 (one bf16 step at the outputs'
                        size is 1/128–1/64, and the two round at different
                        places); states f32 1e-5, bf16 model 1e-2
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import ref, ssd_scan
from repro_torch.models import hybrid, layers, ssm

jax.config.update("jax_enable_x64", False)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SSD_TOL = {"float32": 3e-4, "bfloat16": 5e-2}
BLOCK_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
STATE_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


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
    from repro.kernels import ssd_scan as jssd
    from repro.models import ssm as jssm
    from repro.models import api as japi
    from repro.configs.registry import get_smoke_config as jsmoke
    return types.SimpleNamespace(ssm=jssm, ssd=jssd, api=japi, smoke=jsmoke)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _ssd_inputs(B, S, H, dk, dv, dtype, *, gentle=False, init=False,
                seed=0):
    """numpy operands → (jax tuple, torch tuple). q and k are one row per
    (b, s) broadcast over the heads: ``broadcast_to`` in JAX, a
    head-stride-0 ``expand`` in PyTorch. Gates as the reference's test
    draws them, a ∈ [-0.4, 0], or gentle, a ∈ [-0.02, 0]."""
    rng = np.random.default_rng(seed + 100 * S + H)
    f = np.float32
    q = rng.standard_normal((B, S, 1, dk)).astype(f)
    k = rng.standard_normal((B, S, 1, dk)).astype(f)
    v = rng.standard_normal((B, S, H, dv)).astype(f)
    a = -(rng.random((B, S, H)) * (0.02 if gentle else 0.4)).astype(f)
    i = rng.random((B, S, H)).astype(f)
    h0 = rng.standard_normal((B, H, dk, dv)).astype(f) if init else None
    jdt, tdt = DTYPES[dtype]
    jops = (jnp.broadcast_to(jnp.asarray(q).astype(jdt), (B, S, H, dk)),
            jnp.broadcast_to(jnp.asarray(k).astype(jdt), (B, S, H, dk)),
            jnp.asarray(v).astype(jdt), jnp.asarray(a), jnp.asarray(i),
            None if h0 is None else jnp.asarray(h0))
    tops = (torch.from_numpy(q).to(tdt).expand(B, S, H, dk),
            torch.from_numpy(k).to(tdt).expand(B, S, H, dk),
            torch.from_numpy(v).to(tdt), torch.from_numpy(a),
            torch.from_numpy(i),
            None if h0 is None else torch.from_numpy(h0))
    return jops, tops


# ---------------------------------------------------------------------------
# K4's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("B,S,H,dk,dv,chunk", [
    (2, 128, 3, 16, 8, 32), (1, 128, 4, 16, 64, 64), (2, 48, 2, 8, 16, 48)])
def test_ssd_scan_matches_chunked_decay_attention(jref, dtype, init, B, S, H,
                                                  dk, dv, chunk):
    """y and the final state of the wrapper (its plain version on the CPU)
    against the reference's jnp function; (1, 128, 4, 16, 64, 64) is the
    smoke config's SSD shape, (.., 48, .., 48) a single chunk."""
    (jq, jk, jv, ja, ji, jh0), (tq, tk, tv, ta, ti, th0) = _ssd_inputs(
        B, S, H, dk, dv, dtype, init=init)
    assert tq.stride(2) == 0
    wy, wh = jref.ssm.chunked_decay_attention(
        jq, jk, jv, ja, ji, chunk=chunk, initial_state=jh0, return_state=True)
    gy, gh = ssd_scan.ssd_scan(tq, tk, tv, ta, ti, chunk=chunk,
                               initial_state=th0)
    assert gy.dtype == tv.dtype and gh.dtype == torch.float32
    tol = SSD_TOL[dtype]
    np.testing.assert_allclose(_np(gy), _np(wy), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(gh), _np(wh), rtol=tol, atol=tol)
    got = ssm.chunked_decay_attention(tq, tk, tv, ta, ti, chunk=chunk,
                                      initial_state=th0)
    assert torch.equal(got, gy)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", [(64, 16), (128, 32)])
def test_ssd_scan_matches_pallas_kernel(jref, dtype, S, chunk):
    (jq, jk, jv, ja, ji, _), (tq, tk, tv, ta, ti, _) = _ssd_inputs(
        2, S, 3, 16, 8, dtype)
    want = jref.ssd.ssd_scan(jq, jk, jv, ja.astype(jq.dtype),
                             ji.astype(jq.dtype), chunk=chunk,
                             interpret=True)
    got, _ = ssd_scan.ssd_scan(tq, tk, tv, ta.to(tq.dtype), ti.to(tq.dtype),
                               chunk=chunk)
    tol = SSD_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_ssd_scan_matches_strict_recurrence(jref):
    """The chunked plain version equals the step-by-step recurrence, the
    reference's and the port's ``decay_attention_step`` alike."""
    (jq, jk, jv, ja, ji, _), (tq, tk, tv, ta, ti, _) = _ssd_inputs(
        1, 64, 2, 8, 4, "float32", seed=3)
    got, gh = ssd_scan.ssd_scan(tq, tk, tv, ta, ti, chunk=16)
    jstate = jnp.zeros((1, 2, 8, 4))
    tstate = torch.zeros((1, 2, 8, 4))
    for t in range(64):
        jy, jstate = jref.ssm.decay_attention_step(
            jq[:, t], jk[:, t], jv[:, t], ja[:, t], ji[:, t], jstate)
        ty, tstate = ssm.decay_attention_step(
            tq[:, t], tk[:, t], tv[:, t], ta[:, t], ti[:, t], tstate)
        np.testing.assert_allclose(_np(got[:, t]), _np(jy), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(gh), _np(jstate), rtol=2e-4, atol=2e-4)


def test_segsum_matches_reference(jref):
    a = -np.random.default_rng(1).random((3, 9)).astype(np.float32)
    want = np.asarray(jref.ssm._segsum(jnp.asarray(a)))
    got = ssd_scan.segsum(torch.from_numpy(a)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,dk,dv,chunk", [(1, 256, 4, 16, 64, 64),
                                               (2, 256, 3, 64, 64, 128)])
def test_card_tolerance_rejects_planted_faults(dtype, B, S, H, dk, dv,
                                               chunk):
    """The check the card holds K4 to (``ssd_scan.excess``) passes the
    plain version's own result in the working dtype and fails each planted
    fault at gentle gates, where a chunk keeps most of the carried state:
    at zamba2's own gates the carry is ~e^-97 per chunk and no model-level
    test could see it dropped."""
    _, (q, k, v, a, i, _) = _ssd_inputs(B, S, H, dk, dv, dtype, gentle=True)
    y32, h32 = ref.ssd_scan_ref(q.float(), k.float(), v.float(), a, i,
                                chunk=chunk)
    y, h = ref.ssd_scan_ref(q, k, v, a, i, chunk=chunk)
    rtol = ssd_scan.RTOL[v.dtype]
    assert ssd_scan.excess(y, y32, rtol) <= 0
    assert ssd_scan.excess(h, h32) <= 0
    for fault in ssd_scan.FAULTS:
        fy, fh = ref.ssd_scan_ref(q, k, v, a, i, chunk=chunk, fault=fault)
        assert max(ssd_scan.excess(fy, y32, rtol),
                   ssd_scan.excess(fh, h32)) > 0, fault
    with pytest.raises(ValueError, match="fault"):
        ref.ssd_scan_ref(q, k, v, a, i, chunk=chunk, fault="typo")


def test_ssd_wrapper_checks_its_operands():
    _, (q, k, v, a, i, _) = _ssd_inputs(1, 64, 2, 8, 8, "float32")
    before = ssd_scan.ssd_scan.launches
    with pytest.raises(ValueError, match="multiple"):
        ssd_scan.ssd_scan(q, k, v, a, i, chunk=48)
    with pytest.raises(ValueError, match="a must"):
        ssd_scan.ssd_scan(q, k, v, a[:, :, :1], i, chunk=16)
    with pytest.raises(ValueError, match="initial_state"):
        ssd_scan.ssd_scan(q, k, v, a, i, chunk=16,
                          initial_state=torch.zeros(1, 2, 8, 9))
    assert ssd_scan.ssd_scan.launches == before


def test_ssd_accounting_at_the_serve_shape():
    """zamba2-7b's prefill shape: q and k are one row per position for all
    112 heads, so they count once; the causal half of the chunk's scores."""
    b = ssd_scan.hbm_bytes(4, 4096, 112, 64, 64, 2)
    assert b["qk"] == 2 * 4 * 4096 * 64 * 2
    assert b["v_y"] == 2 * 4 * 4096 * 112 * 64 * 2
    assert 0.49e9 < b["minimum"] < 0.50e9
    fl = ssd_scan.flops(4, 4096, 112, 64, 64, 128)
    assert fl == 2 * 4 * 112 * 32 * (128 * 129 // 2 * 128 + 2 * 128 * 64 * 64)


def test_ssd_bound_at_the_serve_shape():
    """K4's bound at zamba2-7b's prefill shape on an H100 SXM (3.35 TB/s,
    989 TFLOP/s dense bf16, 67 TFLOP/s f32): its bytes bound it in both
    dtypes, 495,976,448 B in bf16 and 969,932,800 B in f32; the f32-core
    figure is the ordinary-core design's bound, 0.901 ms."""
    shape = (4, 4096, 112, 64, 64, 128)
    assert ssd_scan.hbm_bytes(*shape[:5], 2)["minimum"] == 495_976_448
    assert ssd_scan.hbm_bytes(*shape[:5], 4)["minimum"] == 969_932_800
    bf = ssd_scan.bound(*shape, 2, 3.35e12, 989e12, 67e12)
    f32 = ssd_scan.bound(*shape, 4, 3.35e12, 989e12, 67e12)
    assert bf["bound_by"] == f32["bound_by"] == "bytes"
    assert bf["bound_ms"] == pytest.approx(495_976_448 / 3.35e9)
    assert f32["bound_ms"] == pytest.approx(969_932_800 / 3.35e9)
    assert round(bf["bound_ms"], 3) == 0.148
    assert round(f32["bound_ms"], 3) == 0.290
    assert bf["f32_core_bound_ms"] == pytest.approx(60_364_423_168 / 67e9)
    assert round(bf["f32_core_bound_ms"], 3) == 0.901


@pytest.mark.parametrize("gates", ["model", "gentle"])
def test_two_part_split_stays_inside_the_card_tolerance(gates):
    """The kernel's bf16 path splits the gated scores P, the carried state
    h and w·v into two bf16 parts each. Emulated in the plain version
    (``parts=2``) at a cut of the serve shape (S 512, H 8, dk = dv = 64,
    chunk 128, bf16 operands), that stays inside ``ssd_scan.excess``
    around the plain f32 result, while P rounded once to bf16 (the fault
    ``p_one_part``, a lost low part) falls outside it. Gates as the model
    draws them (i = softplus(N(0, 1)), a = i · -linspace(1, 16, H)) or
    gentle (a ~ U(-0.02, 0))."""
    B, S, H, dk, dv, chunk = 2, 512, 8, 64, 64, 128
    rng = np.random.default_rng(11)
    f = np.float32
    bc = torch.from_numpy(rng.standard_normal((B, S, 2 * dk)).astype(f))
    bc = bc.to(torch.bfloat16)
    k = bc[..., :dk][:, :, None].expand(B, S, H, dk)
    q = bc[..., dk:][:, :, None].expand(B, S, H, dk)
    v = torch.from_numpy(rng.standard_normal((B, S, H, dv)).astype(f))
    v = v.to(torch.bfloat16)
    i = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((B, S, H)).astype(f)))
    a = (i * -torch.linspace(1.0, 16.0, H) if gates == "model" else
         -0.02 * torch.from_numpy(rng.random((B, S, H)).astype(f)))
    y32, h32 = ref.ssd_scan_ref(q.float(), k.float(), v.float(), a, i,
                                chunk=chunk)
    rtol = ssd_scan.RTOL[torch.bfloat16]
    y, h = ref.ssd_scan_ref(q, k, v, a, i, chunk=chunk, parts=2)
    assert ssd_scan.excess(y, y32, rtol) <= 0
    assert ssd_scan.excess(h, h32) <= 0
    fy, fh = ref.ssd_scan_ref(q, k, v, a, i, chunk=chunk,
                              fault="p_one_part")
    assert max(ssd_scan.excess(fy, y32, rtol), ssd_scan.excess(fh, h32)) > 0


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def _mamba(jref, dtype, seed=0):
    """The first Mamba2 layer of the reference's zamba2 smoke model, and
    the same layer of its conversion to the port."""
    jcfg = jref.smoke("zamba2-7b").replace(dtype=dtype)
    cfg = get_smoke_config("zamba2-7b").replace(dtype=dtype)
    jp, _ = jref.api.init(jcfg, jax.random.PRNGKey(seed), tp=1)
    p = convert.params_from_jax(jp)
    return (jcfg, cfg, jax.tree.map(lambda t: t[0, 0], jp["super"]["mamba"]),
            layers.param_group(p, hybrid.SUPER, (0, 0))["mamba"])


def _x(cfg, B, S, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x).astype(DTYPES[dtype][0]), \
        torch.from_numpy(x).to(DTYPES[dtype][1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decay_attention_step_matches_reference(jref, dtype):
    rng = np.random.default_rng(4)
    f = np.float32
    ops = [rng.standard_normal(s).astype(f) for s in
           ((2, 3, 8), (2, 3, 8), (2, 3, 5))]
    gates = [-rng.random((2, 3)).astype(f), rng.random((2, 3)).astype(f)]
    state = rng.standard_normal((2, 3, 8, 5)).astype(f)
    jdt, tdt = DTYPES[dtype]
    jy, js = jref.ssm.decay_attention_step(
        *[jnp.asarray(o).astype(jdt) for o in ops],
        *[jnp.asarray(g) for g in gates], jnp.asarray(state))
    ty, ts = ssm.decay_attention_step(
        *[torch.from_numpy(o).to(tdt) for o in ops],
        *[torch.from_numpy(g) for g in gates], torch.from_numpy(state))
    assert ty.dtype == ts.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ts), _np(js), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(jref, dtype):
    """Without a state (prefill) and with one (the streaming decode)."""
    rng = np.random.default_rng(6)
    jdt, tdt = DTYPES[dtype]
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = (rng.standard_normal((4, 12)) * 0.5).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    jw, tw = jnp.asarray(w).astype(jdt), torch.from_numpy(w).to(tdt)
    tol = BLOCK_TOL[dtype]
    want, none = jref.ssm._causal_conv(jnp.asarray(x).astype(jdt), jw)
    got, nothing = ssm._causal_conv(torch.from_numpy(x).to(tdt), tw)
    assert none is None and nothing is None and got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    x1 = x[:, :1]
    want, wst = jref.ssm._causal_conv(jnp.asarray(x1).astype(jdt), jw,
                                      jnp.asarray(st).astype(jdt))
    got, gst = ssm._causal_conv(torch.from_numpy(x1).to(tdt), tw,
                                torch.from_numpy(st).to(tdt))
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    np.testing.assert_array_equal(_np(gst), _np(wst))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mamba2_prefill_and_decode_match_reference(jref, dtype):
    """Prefill of 128 positions (two 64-position chunks) with the cache
    hand-off (``return_state``), the plain forward, then three decode steps
    from the prefill's states."""
    jcfg, cfg, jp, p = _mamba(jref, dtype)
    jx, tx = _x(cfg, 2, 128, dtype)
    tol, stol = BLOCK_TOL[dtype], STATE_TOL[dtype]
    want, (jst, (jcx, jcbc)) = jref.ssm.apply_mamba2(jp, jx, jcfg.ssm,
                                                     return_state=True)
    got, (tst, (tcx, tcbc)) = ssm.apply_mamba2(p, tx, cfg.ssm,
                                               return_state=True)
    assert got.dtype == tx.dtype and tst.dtype == torch.float32
    assert tuple(tst.shape) == ssm.mamba2_state_shape(2, cfg.d_model,
                                                      cfg.ssm)["ssm"]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(tst), _np(jst), rtol=stol, atol=stol)
    np.testing.assert_allclose(_np(tcx), _np(jcx), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(tcbc), _np(jcbc), rtol=tol, atol=tol)
    plain = ssm.apply_mamba2(p, tx, cfg.ssm)
    assert torch.equal(plain, got)
    rng = np.random.default_rng(9)
    for _ in range(3):
        x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jx1 = jnp.asarray(x1).astype(DTYPES[dtype][0])
        tx1 = torch.from_numpy(x1).to(DTYPES[dtype][1])
        want, (jst, (jcx, jcbc)) = jref.ssm.apply_mamba2(
            jp, jx1, jcfg.ssm, state=jst, conv_state=(jcx, jcbc))
        got, (tst, (tcx, tcbc)) = ssm.apply_mamba2(
            p, tx1, cfg.ssm, state=tst, conv_state=(tcx, tcbc))
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
        np.testing.assert_allclose(_np(tst), _np(jst), rtol=stol, atol=stol)
        np.testing.assert_allclose(_np(tcx), _np(jcx), rtol=tol, atol=tol)
