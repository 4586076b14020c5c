"""The port's CUDA kernels on the card. Every test here is marked ``cuda``
and skips itself on a machine without a CUDA device; run them there with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_round, ref, trust_agg, trust_score


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
