"""The port's CUDA kernels on the card. Every test here is marked ``cuda``
and skips itself on a machine without a CUDA device; run them there with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, fused_round, ref, ssd_scan, \
    swa_decode, trust_agg, trust_score


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


# K2 over the W of its paths: one row split below 128 rows, then 2 (W 129)
# or 8 splits combined inside the launch; D = 21840 (the paper CNN) and
# D = 21839 (no multiple of 4 or 8: one column per thread)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [21840, 21839])
@pytest.mark.parametrize("W", [1, 7, 16, 129, 4096, 10240])
def test_trust_agg_matches_plain_version_on_card(cuda, W, D, dtype):
    u, _, weights, _ = _inputs(W, D, dtype, cuda)
    before = trust_agg.trust_agg.launches
    got = trust_agg.trust_agg(u, weights)
    torch.cuda.synchronize()
    assert trust_agg.trust_agg.launches == before + 1
    want = ref.trust_agg_ref(u, weights)
    assert got.dtype == torch.float32 and got.shape == (D,)
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("W,D,dtype", [(16, 21840, "float32"),
                                       (4096, 21840, "float32"),
                                       (4096, 21840, "bfloat16"),
                                       (129, 21839, "float32")])
def test_trust_agg_is_one_deterministic_launch_on_card(cuda, W, D, dtype):
    """Two launches give the same bits, and one call is one device
    kernel (one kernel launch, no copy or memset, among the runtime calls
    the profiler records): the splits are summed inside the launch."""
    u, _, weights, _ = _inputs(W, D, dtype, cuda)
    a, b = trust_agg.trust_agg(u, weights), trust_agg.trust_agg(u, weights)
    assert torch.equal(a, b)
    enqueued, device = _build.launch_records(
        lambda: trust_agg.trust_agg(u, weights))
    assert enqueued == ["cudaLaunchKernel"] * 4, enqueued
    assert all("trust_agg" in n for n in device), device


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
# of a tile, cur runs below, at and past the window, G is 1, 4, 5 and 8,
# and the window's slots are fewer than the 8 chunks of a full window
# (cur 0-7) or no multiple of the chunk (1001, 350, 600 slots).
SWA_CASES = [(1, 1, 1, 80, 37, 16, 36), (3, 5, 1, 32, 300, 64, 0),
             (2, 8, 2, 32, 1000, 1, 999), (4, 32, 8, 80, 5184, 4096, 100),
             (4, 32, 8, 80, 5184, 4096, 4095), (4, 32, 8, 80, 5184, 4096, 4096),
             (4, 32, 8, 80, 5184, 4096, 5183),
             (4, 32, 8, 80, 5184, 4096, 1000), (3, 5, 1, 32, 700, 350, 699),
             (2, 16, 2, 64, 700, 600, 650), (2, 16, 2, 128, 300, 200, 299)] + \
    [(2, 8, 1, 80, 64, 4096, cur) for cur in range(8)]
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
    slot short or long, or without its oldest 256 slots."""
    q, kc, vc = _swa_inputs(4, 32, 8, 80, 5184, dtype, cuda)
    want = _plain_f32(q, kc, vc, 5183, 4096)
    for w in (4095, 4097, 4096 - 256):
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cur", [3, 5000])
def test_swa_decode_is_one_deterministic_launch_on_card(cuda, dtype, cur):
    """Two launches give the same bits, and one call is one device
    kernel (one kernel launch, no copy or memset, among the runtime calls
    the profiler records): the chunks are combined inside the launch (one
    chunk at cur 3, eight at cur 5000)."""
    q, kc, vc = _swa_inputs(4, 32, 8, 80, 5184, dtype, cuda)
    a = swa_decode.swa_decode(q, kc, vc, cur, 4096)
    b = swa_decode.swa_decode(q, kc, vc, cur, 4096)
    assert torch.equal(a, b)
    enqueued, device = _build.launch_records(
        lambda: swa_decode.swa_decode(q, kc, vc, cur, 4096))
    assert enqueued == ["cudaLaunchKernel"] * 4, enqueued
    assert all("swa_decode" in n for n in device), device


# K4 against ssd_scan_ref: (B, S, H, dk, dv, chunk, gates, initial state).
# zamba2-7b's prefill shape with its gates and with gentle ones (a chunk
# keeps >= e^-2.6 of the state, so the carry across chunks shows), the smoke
# shape, one chunk only, an initial state, the 128-wide instantiation,
# chunks that are no multiple of the 32-row tile or shorter than a warp, and
# a chunk of 40 rows at dk = dv = 64 (tensor-map boxes of 40 rows in a stage
# padded to 48).
SSD_CASES = [(4, 4096, 112, 64, 64, 128, "model", False),
             (4, 4096, 112, 64, 64, 128, "gentle", False),
             (2, 128, 8, 16, 64, 64, "gentle", False),
             (2, 128, 16, 64, 64, 128, "gentle", False),
             (2, 256, 8, 64, 64, 128, "gentle", True),
             (1, 256, 4, 128, 128, 128, "gentle", True),
             (2, 160, 3, 24, 40, 80, "gentle", True),
             (1, 60, 2, 8, 8, 20, "model", False),
             (2, 160, 4, 64, 64, 40, "model", True)]


def _ssd_inputs(B, S, H, dk, dv, gates, init, dtype, dev, seed=0,
                per_head=False):
    """The model's operands: q and k as head-stride-0 views of one (B, S,
    2 dk) projection (Mamba2's C and B), or with ``per_head`` their own
    values for every head, v (B, S, H, dv), f32 gates with
    i = softplus(N(0, 1)) and a = i * -linspace(1, 16, H) ("model", as at
    zamba2's init) or a ~ U(-0.02, 0) ("gentle")."""
    gen = torch.Generator(device=dev).manual_seed(seed + S + H + dk)
    dt = getattr(torch, dtype)
    if per_head:
        k = torch.randn((B, S, H, dk), generator=gen, device=dev).to(dt)
        q = torch.randn((B, S, H, dk), generator=gen, device=dev).to(dt)
    else:
        bc = torch.randn((B, S, 2 * dk), generator=gen, device=dev).to(dt)
        k = bc[..., :dk][:, :, None].expand(B, S, H, dk)
        q = bc[..., dk:][:, :, None].expand(B, S, H, dk)
    v = torch.randn((B, S, H, dv), generator=gen, device=dev).to(dt)
    i = F.softplus(torch.randn((B, S, H), generator=gen, device=dev))
    if gates == "model":
        a = i * -torch.linspace(1.0, 16.0, H, device=dev)
    else:
        a = -0.02 * torch.rand((B, S, H), generator=gen, device=dev)
    h0 = torch.randn((B, H, dk, dv), generator=gen, device=dev) \
        if init else None
    return q, k, v, a, i, h0


def _ssd_plain_f32(q, k, v, a, i, h0, chunk, fault=None):
    return ref.ssd_scan_ref(q.float(), k.float(), v.float(), a, i,
                            chunk=chunk, initial_state=h0, fault=fault)


# The same with q and k of their own for every head (head stride dk): at
# dk = dv = 64 in bf16 their tensor maps then take the head axis.
SSD_PER_HEAD_CASES = [(2, 256, 8, 64, 64, 128, "gentle", True),
                      (2, 160, 4, 64, 64, 40, "model", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,H,dk,dv,chunk,gates,init,per_head",
    [pytest.param(*c, False, id="-".join(map(str, c))) for c in SSD_CASES]
    + [pytest.param(*c, True, id="-".join(map(str, c)) + "-per_head")
       for c in SSD_PER_HEAD_CASES])
def test_ssd_scan_matches_plain_version_on_card(cuda, B, S, H, dk, dv, chunk,
                                                gates, init, per_head, dtype):
    """y and the final state within ``ssd_scan.excess`` of the plain
    version's f32 result on the same card inputs."""
    q, k, v, a, i, h0 = _ssd_inputs(B, S, H, dk, dv, gates, init, dtype,
                                    cuda, per_head=per_head)
    assert q.stride(2) == (dk if per_head else 0)
    before = ssd_scan.ssd_scan.launches
    y, h = ssd_scan.ssd_scan(q, k, v, a, i, chunk=chunk, initial_state=h0)
    torch.cuda.synchronize()
    assert ssd_scan.ssd_scan.launches == before + 1
    assert y.dtype == v.dtype and y.shape == v.shape
    assert h.dtype == torch.float32 and h.shape == (B, H, dk, dv)
    y32, h32 = _ssd_plain_f32(q, k, v, a, i, h0, chunk)
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    assert ssd_scan.excess(y, y32, ssd_scan.RTOL[v.dtype]) <= 0
    assert ssd_scan.excess(h, h32) <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_tolerance_rejects_planted_faults_on_card(cuda, dtype):
    """At the serve shape with gentle gates, the plain version with each
    planted fault fails the check the kernel passes above."""
    q, k, v, a, i, h0 = _ssd_inputs(4, 4096, 112, 64, 64, "gentle", False,
                                    dtype, cuda)
    y32, h32 = _ssd_plain_f32(q, k, v, a, i, h0, 128)
    for fault in ssd_scan.FAULTS:
        fy, fh = ref.ssd_scan_ref(q, k, v, a, i, chunk=128, fault=fault)
        worst = max(ssd_scan.excess(fy, y32, ssd_scan.RTOL[v.dtype]),
                    ssd_scan.excess(fh, h32))
        assert worst > 0, fault


@pytest.mark.cuda
def test_ssd_scan_is_bitwise_deterministic_on_card(cuda):
    q, k, v, a, i, h0 = _ssd_inputs(4, 4096, 112, 64, 64, "model", True,
                                    "bfloat16", cuda)
    y1, h1 = ssd_scan.ssd_scan(q, k, v, a, i, chunk=128, initial_state=h0)
    y2, h2 = ssd_scan.ssd_scan(q, k, v, a, i, chunk=128, initial_state=h0)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_is_one_launch_on_card(cuda, dtype):
    """4 calls make 4 kernel launches and no copy or memset, and every
    device record the profiler keeps is K4's kernel."""
    q, k, v, a, i, h0 = _ssd_inputs(2, 512, 8, 64, 64, "model", True, dtype,
                                    cuda)
    enqueued, device = _build.launch_records(
        lambda: ssd_scan.ssd_scan(q, k, v, a, i, chunk=128,
                                  initial_state=h0))
    assert enqueued == ["cudaLaunchKernel"] * 4, enqueued
    assert all("ssd_chunk_scan" in n for n in device), device


@pytest.mark.cuda
def test_ssd_scan_raises_on_what_the_kernel_does_not_take(cuda):
    """A CUDA tensor the kernel cannot take raises; it never runs the plain
    version instead."""
    q, k, v, a, i, _ = _ssd_inputs(1, 256, 2, 16, 16, "model", False,
                                   "float32", cuda)
    before = ssd_scan.ssd_scan.launches
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan.ssd_scan(q, k, v, a, i, chunk=256)
    with pytest.raises(TypeError):
        ssd_scan.ssd_scan(q.half(), k.half(), v.half(), a, i, chunk=128)
    wide = torch.zeros((1, 256, 2, 160), device=cuda)
    with pytest.raises(ValueError, match="dk"):
        ssd_scan.ssd_scan(wide, wide, v, a, i, chunk=128)
    with pytest.raises(ValueError, match="rows"):
        ssd_scan.ssd_scan(q.transpose(2, 3).contiguous().transpose(2, 3), k,
                          v, a, i, chunk=128)
    assert ssd_scan.ssd_scan.launches == before
