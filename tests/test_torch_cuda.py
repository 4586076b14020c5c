"""The port's CUDA kernels on the card. Every test here is marked ``cuda``
and skips itself on a machine without a CUDA device; run them there with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_round, ref, swa_decode, trust_agg, \
    trust_score


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(W, D, dtype, dev, seed=0):
    rng = np.random.default_rng(seed * 7919 + W * 31 + D)
    u = torch.from_numpy(rng.standard_normal((W, D)).astype(np.float32))
    pending = torch.from_numpy(rng.standard_normal((W, D)).astype(np.float32))
    weights = torch.from_numpy(rng.random(W).astype(np.float32))
    keep = torch.from_numpy((rng.random(W) > 0.5).astype(np.float32))
    return (u.to(getattr(torch, dtype)).to(dev), pending.to(dev),
            weights.to(dev), keep.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("W,D,dtype", [
    (1, 1, "float32"), (33, 2053, "bfloat16"), (300, 4096, "float32"),
    (16, 21840, "bfloat16"), (257, 21840, "float32")])
def test_kernels_match_plain_versions_on_card(cuda, W, D, dtype):
    """Each kernel against its plain version on the same card inputs, at
    small, ragged and paper-CNN shapes. Both sum in f32 in different
    orders: rtol 1e-4 of the largest plain value."""
    u, pending, weights, keep = _inputs(W, D, dtype, cuda)
    cases = [(trust_score.trust_score_stats, ref.trust_score_ref, (u,)),
             (trust_agg.trust_agg, ref.trust_agg_ref, (u, weights)),
             (fused_round.fused_async_agg, ref.fused_async_agg_ref,
              (u, pending, weights, keep))]
    for kernel, plain, args in cases:
        before = kernel.launches
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, e in zip(got, want):
            assert g.device.type == "cuda" and g.dtype == torch.float32
            tol = 1e-4 * max(1.0, float(e.abs().max()))
            torch.testing.assert_close(g, e, rtol=0, atol=tol)


@pytest.mark.cuda
def test_kernels_are_bitwise_deterministic_on_card(cuda):
    """Two launches on the same inputs give the same bits: no atomics."""
    u, pending, weights, keep = _inputs(4096, 21840, "float32", cuda)
    for kernel, args in [(trust_score.trust_score_stats, (u,)),
                         (trust_agg.trust_agg, (u, weights)),
                         (fused_round.fused_async_agg,
                          (u, pending, weights, keep))]:
        a, b = kernel(*args), kernel(*args)
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# K5 against swa_decode_ref: (B, H, KV, hd, S, window, cur), ragged and at
# danube's decode shape (H 32, KV 8, hd 80, window 4096); S is no multiple
# of the kernel's 256-slot chunk, and cur runs below, at and past the window.
SWA_CASES = [(1, 1, 1, 80, 37, 16, 36), (3, 5, 1, 32, 300, 64, 0),
             (2, 8, 2, 32, 1000, 1, 999), (4, 32, 8, 80, 5184, 4096, 100),
             (4, 32, 8, 80, 5184, 4096, 4095), (4, 32, 8, 80, 5184, 4096, 4096),
             (4, 32, 8, 80, 5184, 4096, 5183)]
# held elementwise to the plain version's f32 result before any rounding:
# |kernel - plain_f32| <= 1e-5 + rtol * |plain_f32|. In f32 both differ in
# summation order only (measured <= 8e-7 on the H100); in bf16 the kernel
# also rounds its result once, by at most half a bf16 step (2^-8 relative).
SWA_ATOL = 1e-5
SWA_RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -8}


def _swa_inputs(B, H, KV, hd, S, dtype, dev, seed=0, layers=1):
    """q (B, H, hd) and the caches as layer ``layers - 1`` of a stacked
    (layers, B, S, KV, hd) cache, as the model hands them to the kernel."""
    rng = np.random.default_rng(seed + B * 7 + H * 13 + S)
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32))
    kv = [torch.from_numpy(rng.standard_normal(
        (layers, B, S, KV, hd)).astype(np.float32)) for _ in range(2)]
    return (q.to(dt).to(dev), kv[0].to(dt).to(dev)[layers - 1],
            kv[1].to(dt).to(dev)[layers - 1])


def _plain_f32(q, kc, vc, cur, window):
    return ref.swa_decode_ref(q.float(), kc.float(), vc.float(), cur, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,hd,S,window,cur", SWA_CASES)
def test_swa_decode_matches_plain_version_on_card(cuda, B, H, KV, hd, S,
                                                  window, cur, dtype):
    q, kc, vc = _swa_inputs(B, H, KV, hd, S, dtype, cuda, layers=2)
    before = swa_decode.swa_decode.launches
    got = swa_decode.swa_decode(q, kc, vc, cur, window)
    torch.cuda.synchronize()
    assert swa_decode.swa_decode.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), _plain_f32(q, kc, vc, cur, window),
                               rtol=SWA_RTOL[dtype], atol=SWA_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swa_tolerance_rejects_planted_faults_on_card(cuda, dtype):
    """At the serve shape the check above fails K5 run with the window one
    slot short or long, or without its oldest chunk."""
    q, kc, vc = _swa_inputs(4, 32, 8, 80, 5184, dtype, cuda)
    want = _plain_f32(q, kc, vc, 5183, 4096)
    for w in (4095, 4097, 4096 - swa_decode.CHUNK):
        bad = swa_decode.swa_decode(q, kc, vc, 5183, w)
        with pytest.raises(AssertionError):
            torch.testing.assert_close(bad.float(), want,
                                       rtol=SWA_RTOL[dtype], atol=SWA_ATOL)


@pytest.mark.cuda
def test_swa_decode_is_bitwise_deterministic_on_card(cuda):
    q, kc, vc = _swa_inputs(4, 32, 8, 80, 5184, "bfloat16", cuda)
    a = swa_decode.swa_decode(q, kc, vc, 5000, 4096)
    b = swa_decode.swa_decode(q, kc, vc, 5000, 4096)
    assert torch.equal(a, b)
