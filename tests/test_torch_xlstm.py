"""The port's xLSTM blocks against the JAX package on the CPU: the mLSTM
block (prefill with its state, normalizer column and conv tail, then
decode) at the smoke config's heads and at one wide head, the sLSTM block
and its streaming, ``log_sigmoid``, K4's plain version at mLSTM's heads
(dv = dk + 1, chunk 256) against the reference's
``chunked_decay_attention`` and its Pallas kernel in interpret mode, and
the byte count behind K4's bound. ``tests/test_torch_xlstm_serve.py``
holds the stack, its conversion and its serve.

Shapes: the smoke config's mLSTM (d 256, 4 heads of dh 128, chunk 64) and
one wide head (dh 1024, d 512, expand 2) over S = 256, one chunk of
mLSTM's 256; sLSTM at d 256, 4 heads. Weights are the JAX init converted;
inputs come from a numpy seed. The JAX package is imported through the
``jref`` fixture, the workaround for fault F1 of the reference
(ROADMAP.md, Queue 3; see ``tests/test_torch_hybrid.py``).

Tolerances, absolute (the hybrid's, ``tests/test_torch_hybrid.py``):

  block outputs   f32 1e-4; bf16 0.125 (the blocks round their
                  activations to bf16 at other places than XLA)
  f32 states      f32 1e-4; bf16 model 1e-2 of their largest value
  conv tails      f32 1e-4; bf16 0.125
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ref, ssd_scan
from repro_torch.models import ssm

jax.config.update("jax_enable_x64", False)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.125}
CACHE_TOL = {"float32": {"state": 1e-4, "other": 1e-4},
             "bfloat16": {"state": 1e-2, "other": 0.125}}


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
    return types.SimpleNamespace(ssm=jssm, ssd=jssd)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _leaves(tree):
    return {k: convert._tensor(v, "cpu") for k, v in tree.items()}


def _close(got, want, tol, what, rel=False):
    want = _np(want)
    atol = tol * max(np.abs(want).max(), 1e-30) if rel else tol
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=atol,
                               err_msg=what)


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(DTYPES[dtype][0]), \
        torch.from_numpy(x).to(DTYPES[dtype][1])


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

MLSTM_SHAPES = {
    # (d_model, ssm config, chunk, batch, prompt)
    "smoke": (256, SSMConfig(state_dim=64, conv_width=4, expand=2,
                             num_ssm_heads=4, chunk_size=64), 64, 2, 128),
    "wide": (512, SSMConfig(state_dim=512, conv_width=4, expand=2,
                            num_ssm_heads=1, chunk_size=256), 256, 1, 256),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(MLSTM_SHAPES))
def test_mlstm_block_prefill_and_decode_match_reference(jref, dtype, shape):
    """The mLSTM block's prefill (``return_state``: its output, the f32
    state (B, H, dh, dh + 1) whose last column is the normalizer's, and
    the raw pre-conv tail) and three decode steps from there, against the
    reference's ``apply_mlstm`` on the same weights and inputs."""
    d, scfg, chunk, B, S = MLSTM_SHAPES[shape]
    jdt, tdt = DTYPES[dtype]
    jp, _ = jref.ssm.init_mlstm(jax.random.PRNGKey(1), d, scfg, 1, jdt)
    p = _leaves(jp)
    dh = scfg.expand * d // scfg.num_ssm_heads
    jx, tx = _x((B, S, d), dtype, seed=2)
    jy, (jst, jcs) = jref.ssm.apply_mlstm(jp, jx, scfg, chunk=chunk,
                                          return_state=True)
    before = ssd_scan.ssd_scan.launches
    ty, (tst, tcs) = ssm.apply_mlstm(p, tx, scfg, chunk=chunk,
                                     return_state=True)
    assert ssd_scan.ssd_scan.launches == before     # CPU: plain version
    assert ty.dtype == tdt and tst.dtype == torch.float32
    assert tuple(tst.shape) == (B, scfg.num_ssm_heads, dh, dh + 1)
    assert tcs.dtype == tdt and tuple(tcs.shape) == (B, 3, scfg.expand * d)
    out_tol = LOGIT_TOL[dtype]
    st_tol = CACHE_TOL[dtype]["state"]
    rel = dtype == "bfloat16"
    _close(ty, jy, out_tol, "prefill output")
    _close(tst, jst, st_tol, "prefill state", rel)
    _close(tst[..., dh], jst[..., dh], st_tol, "normalizer column", rel)
    _close(tcs, jcs, CACHE_TOL[dtype]["other"], "conv tail")
    np.testing.assert_array_equal(_np(tcs), _np(tx @ p["w_up"])[
        :, -3:, :scfg.expand * d])
    for step in range(3):
        jxt, txt = _x((B, 1, d), dtype, seed=10 + step)
        jy, (jst, jcs) = jref.ssm.apply_mlstm(jp, jxt, scfg, state=jst,
                                              conv_state=jcs)
        ty, (tst, tcs) = ssm.apply_mlstm(p, txt, scfg, state=tst,
                                         conv_state=tcs)
        _close(ty, jy, out_tol, f"decode output {step}")
        _close(tst, jst, st_tol, f"decode state {step}", rel)
        _close(tcs, jcs, CACHE_TOL[dtype]["other"], f"conv state {step}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_block_matches_reference(jref, dtype):
    """The sLSTM block over a whole sequence (output and carry) and one
    streamed step from that carry, against the reference's
    ``apply_slstm``."""
    d, H, B, S = 256, 4, 2, 24
    jdt, _ = DTYPES[dtype]
    jp, _ = jref.ssm.init_slstm(jax.random.PRNGKey(3), d, H, 1, jdt)
    p = _leaves(jp)
    jx, tx = _x((B, S, d), dtype, seed=4)
    jy, jc = jref.ssm.apply_slstm(jp, jx, H, return_state=True)
    ty, tc = ssm.apply_slstm(p, tx, H, return_state=True)
    tol = LOGIT_TOL[dtype]
    _close(ty, jy, tol, "output")
    for name, g, w in zip("cnhm", tc, jc):
        assert g.dtype == torch.float32
        _close(g, w, CACHE_TOL[dtype]["state"], name, dtype == "bfloat16")
    assert torch.equal(ssm.apply_slstm(p, tx, H), ty)
    jxt, txt = _x((B, 1, d), dtype, seed=5)
    jy, _ = jref.ssm.apply_slstm(jp, jxt, H, carry=jc)
    ty, _ = ssm.apply_slstm(p, txt, H, carry=tc)
    _close(ty, jy, tol, "streamed step")


def test_slstm_streaming_matches_whole_sequence():
    """The port's sLSTM over a whole sequence equals two streamed halves
    (the reference's ``test_slstm_state_streaming_matches_batch``)."""
    d, H, B, T = 32, 4, 2, 12
    p = ssm.init_slstm(torch.Generator().manual_seed(0), d, H,
                       torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, T, d)).astype(np.float32) * 0.5)
    full = ssm.apply_slstm(p, x, H)
    first, carry = ssm.apply_slstm(p, x[:, :6], H, return_state=True)
    second, _ = ssm.apply_slstm(p, x[:, 6:], H, carry=carry)
    torch.testing.assert_close(torch.cat([first, second], 1), full,
                               rtol=2e-4, atol=2e-4)


def test_log_sigmoid_matches_reference():
    x = np.linspace(-60, 60, 4001).astype(np.float32)
    want = np.asarray(jax.nn.log_sigmoid(jnp.asarray(x)))
    got = ssm.log_sigmoid(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-30)


# ---------------------------------------------------------------------------
# K4's plain version at mLSTM's heads
# ---------------------------------------------------------------------------

def _wide_inputs(B, S, H, dk, seed):
    """mLSTM-like operands at dv = dk + 1 (v's last column ones), f32, as
    numpy: per-head q, k ~ N(0, 1/dk), a = log σ(3 + N(0, 1)),
    i = exp(clip(2 N(0, 1), -10, 10)), an initial state."""
    rng = np.random.default_rng(seed)
    f = np.float32
    q = (rng.standard_normal((B, S, H, dk)) / np.sqrt(dk)).astype(f)
    k = (rng.standard_normal((B, S, H, dk)) / np.sqrt(dk)).astype(f)
    v = rng.standard_normal((B, S, H, dk + 1)).astype(f)
    v[..., -1] = 1.0
    fg = 3.0 + rng.standard_normal((B, S, H))
    a = (-np.logaddexp(0.0, -fg)).astype(f)
    i = np.exp(np.clip(2.0 * rng.standard_normal((B, S, H)), -10, 10)
               ).astype(f)
    h0 = rng.standard_normal((B, H, dk, dk + 1)).astype(f)
    return q, k, v, a, i, h0


def test_ssd_scan_wide_matches_chunked_decay_attention(jref):
    """dv = dk + 1 and chunk 256 from an initial state: y and the final
    state of the wrapper (its plain version on the CPU) against the
    reference's jnp function, each within 1e-5 of its largest value (f32
    sums in other orders; measured <= 1e-6)."""
    ops = _wide_inputs(2, 512, 2, 64, seed=7)
    wy, wh = jref.ssm.chunked_decay_attention(
        *map(jnp.asarray, ops[:5]), chunk=256,
        initial_state=jnp.asarray(ops[5]), return_state=True)
    gy, gh = ssd_scan.ssd_scan(*map(torch.from_numpy, ops[:5]), chunk=256,
                               initial_state=torch.from_numpy(ops[5]))
    assert ssd_scan.is_wide(64, 65, 256)
    _close(gy, wy, 1e-5, "y", rel=True)
    _close(gh, wh, 1e-5, "state", rel=True)


def test_ssd_scan_wide_matches_pallas_kernel(jref):
    """At a small wide shape (dk 128, dv 129, chunk 64: the smoke config's
    mLSTM heads) against the reference's Pallas kernel in interpret mode
    (which starts from a zero state), within 1e-5 of max|y|."""
    q, k, v, a, i, _ = _wide_inputs(1, 128, 2, 128, seed=8)
    want = jref.ssd.ssd_scan(*map(jnp.asarray, (q, k, v, a, i)), chunk=64,
                             interpret=True)
    got, _ = ref.ssd_scan_ref(*map(torch.from_numpy, (q, k, v, a, i)),
                              chunk=64)
    assert ssd_scan.is_wide(128, 129, 64)
    _close(got, want, 1e-5, "y", rel=True)


@pytest.mark.parametrize("init", [False, True])
def test_ssd_scan_wide_bf16_split_is_within_the_card_tolerance(init):
    """What the wide path's bf16 split costs, emulated on the CPU at one
    wide head (dk 1024, dv 1025, chunk 256, S 512, mLSTM's gates with the
    input gate up to e^10, as the card tests draw them): with the gated
    scores, the states and w·v in ``WIDE_PARTS`` bf16 parts, y and the
    final state stay within ``ssd_scan.excess`` of the f32 plain version
    (measured ~0.05 of the tolerance); in one part (and the planted fault
    ``p_one_part``, the scores alone) they do not (~14x over). The kernel
    splits f32 q, k and v into three parts, which hold them exactly, so
    the emulation leaves them as they are."""
    rng = np.random.default_rng(11)
    B, S, H, dk, Q = 1, 512, 2, 1024, 256
    f = np.float32
    q = (rng.standard_normal((B, S, H, dk)) / np.sqrt(dk)).astype(f)
    k = (rng.standard_normal((B, S, H, dk)) / np.sqrt(dk)).astype(f)
    v = rng.standard_normal((B, S, H, dk + 1)).astype(f)
    v[..., -1] = 1.0
    a = (-np.logaddexp(0.0, -(3.0 + rng.standard_normal((B, S, H))))
         ).astype(f)
    i = np.exp(np.clip(4.0 * rng.standard_normal((B, S, H)), -10, 10)
               ).astype(f)
    h0 = rng.standard_normal((B, H, dk, dk + 1)).astype(f) if init else None
    ops = [torch.from_numpy(x) for x in (q, k, v, a, i)]
    h0 = None if h0 is None else torch.from_numpy(h0)
    y32, h32 = ssd_scan.ssd_scan_ref(*ops, chunk=Q, initial_state=h0)
    got = ssd_scan.ssd_scan_ref(*ops, chunk=Q, initial_state=h0,
                                parts=ssd_scan.WIDE_PARTS)
    assert ssd_scan.excess(got[0], y32) <= 0
    assert ssd_scan.excess(got[1], h32) <= 0
    one = ssd_scan.ssd_scan_ref(*ops, chunk=Q, initial_state=h0, parts=1)
    assert max(ssd_scan.excess(one[0], y32), ssd_scan.excess(one[1], h32)) > 0
    fy, _ = ssd_scan.ssd_scan_ref(*ops, chunk=Q, initial_state=h0,
                                  fault="p_one_part")
    assert ssd_scan.excess(fy, y32) > 0
    # parts=None is the plain version itself, bit for bit
    again = ssd_scan.ssd_scan_ref(*ops, chunk=Q, initial_state=h0,
                                  parts=None)
    assert torch.equal(again[0], y32) and torch.equal(again[1], h32)


def test_wide_dispatch_and_byte_count():
    """Which calls take the wide path; K4's bytes count q and k per head
    for mLSTM and once for Mamba2's head-stride-0 views: at the xLSTM
    serve shape in f32 (B 4, S 1024, H 4, dk 1024, dv 1025, chunk 256)
    335,872,000 bytes, 0.100 ms on an H100 SXM's 3.35 TB/s, so bytes bound
    it (77.4 GFLOP: 0.078 ms on the bf16 tensor cores, 1.16 ms on the f32
    cores); zamba2's prefill bound stays 0.1481 ms in bf16."""
    assert not ssd_scan.is_wide(64, 64, 128)
    assert not ssd_scan.is_wide(128, 128, 128)
    assert ssd_scan.is_wide(128, 129, 64) and ssd_scan.is_wide(16, 16, 256)
    shape = (4, 1024, 4, 1024, 1025, 256)
    b = ssd_scan.hbm_bytes(*shape[:5], 4, qk_per_head=True)
    assert b["qk"] == 2 * 4 * 1024 * 4 * 1024 * 4
    assert b["minimum"] == 335_872_000
    x = ssd_scan.bound(*shape, 4, 3.35e12, 989e12, 67e12, qk_per_head=True)
    assert x["bound_by"] == "bytes"
    assert round(x["bound_ms"], 3) == 0.100
    assert ssd_scan.flops(*shape) == 77_414_285_312
    assert round(x["f32_core_bound_ms"], 2) == 1.16
    # per-head q, k in their own item size: bf16 q, k beside f32 v
    half = ssd_scan.hbm_bytes(*shape[:5], 4, qk_per_head=True, qk_itemsize=2)
    assert half["qk"] == b["qk"] // 2
    assert half["minimum"] == b["minimum"] - b["qk"] // 2
    zamba = (4, 4096, 112, 64, 64, 128)
    z = ssd_scan.bound(*zamba, 2, 3.35e12, 989e12, 67e12)
    assert round(z["bound_ms"], 4) == 0.1481
    assert ssd_scan.hbm_bytes(*zamba[:5], 2, qk_per_head=False) == \
        ssd_scan.hbm_bytes(*zamba[:5], 2)
    bw = ssd_scan.bwd_hbm_bytes(*shape, 4, qk_per_head=True)
    assert bw["qk"] == b["qk"]
    assert bw["minimum"] == ssd_scan.bwd_hbm_bytes(*shape, 4)["minimum"] + \
        b["qk"] - b["qk"] // 4
