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


# K1 over the W of its plans: one block a cluster (W 1 to 129), clusters of
# 8 (W 4096) and 16 (W 10240); D = 21840 (the paper CNN) and D = 21839 (rows
# the bulk copy engine cannot take: copied by every thread)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [21840, 21839])
@pytest.mark.parametrize("W", [1, 7, 16, 129, 4096, 10240])
def test_trust_score_matches_plain_version_on_card(cuda, W, D, dtype):
    u = _inputs(W, D, dtype, cuda)[0]
    before = trust_score.trust_score_stats.launches
    got = trust_score.trust_score_stats(u)
    torch.cuda.synchronize()
    assert trust_score.trust_score_stats.launches == before + 1
    for g, e in zip(got, ref.trust_score_ref(u)):
        assert g.dtype == torch.float32 and g.shape == e.shape
        tol = 1e-4 * max(1.0, float(e.abs().max()))
        torch.testing.assert_close(g, e, rtol=0, atol=tol)


def _k1_launches(enqueued, calls=4):
    """One kernel launch a call, by cudaLaunchKernel (one block a cluster)
    or by cudaLaunchKernelEx (a cluster launch), and no copy or memset."""
    return len(enqueued) == calls and all(
        n.startswith("cudaLaunchKernel") for n in enqueued)


@pytest.mark.cuda
@pytest.mark.parametrize("W,D,dtype", [(16, 21840, "float32"),
                                       (4096, 21840, "float32"),
                                       (4096, 21840, "bfloat16"),
                                       (10240, 21840, "float32"),
                                       (129, 21839, "bfloat16")])
def test_trust_score_is_one_deterministic_launch_on_card(cuda, W, D, dtype):
    """Two launches give the same bits, and one call is one device kernel
    (one kernel launch, no copy or memset, among the runtime calls the
    profiler records): the clusters' sums are combined inside the
    launch."""
    u = _inputs(W, D, dtype, cuda)[0]
    a, b = trust_score.trust_score_stats(u), trust_score.trust_score_stats(u)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    enqueued, device = _build.launch_records(
        lambda: trust_score.trust_score_stats(u))
    assert _k1_launches(enqueued), enqueued
    assert all("trust_stats" in n for n in device), device


@pytest.mark.cuda
@pytest.mark.parametrize("W", [16, 4096, 10240])
def test_trust_score_tolerance_rejects_planted_faults_on_card(cuda, W):
    """The check above fails the plain version with each planted fault of
    ``trust_score.FAULTS`` (the plan's last tile dropped, the consensus
    without the last cluster rank's rows, |c|^2 of the first tile)."""
    u = _inputs(W, 21840, "float32", cuda)[0]
    want = ref.trust_score_ref(u)
    for fault in trust_score.FAULTS:
        bad = ref.trust_score_ref(u, fault=fault)
        assert any(float((x - e).abs().max())
                   > 1e-4 * max(1.0, float(e.abs().max()))
                   for x, e in zip(bad, want)), fault


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


# K3 over the W of its plans: one row split of 32-thread tiles below W 128,
# then 128-thread tiles in 2 (W 129), 13 (W 4096 f32, W 10240) or 24 (W 4096
# bf16) splits combined inside the launch; D = 21840
# (the paper CNN) and D = 21839 (one column per thread); and once at the
# LLM round's flat pack, W 8, D 134,515,008 bf16 (byte offsets past 2^31)
K3_LLM = (8, 134_515_008, "bfloat16")


def _k3_card_inputs(W, D, dtype, dev):
    """K3's operands made on the card (the LLM pack is too large to make
    on the host in a test's time)."""
    if (W, D, dtype) != K3_LLM:
        return _inputs(W, D, dtype, dev)
    gen = torch.Generator(device=dev).manual_seed(W + D)
    return (torch.randn((W, D), generator=gen, device=dev).to(torch.bfloat16),
            torch.randn((W, D), generator=gen, device=dev),
            torch.rand((W,), generator=gen, device=dev),
            (torch.rand((W,), generator=gen, device=dev) > 0.5).float())


def _k3_tol(e):
    return 1e-4 * max(1.0, float(e.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("W,D,dtype", [
    (W, D, dt) for W in (1, 7, 16, 129, 4096, 10240) for D in (21840, 21839)
    for dt in ("float32", "bfloat16")] + [K3_LLM])
def test_fused_async_agg_matches_plain_version_on_card(cuda, W, D, dtype):
    """The aggregate within 1e-4 of the largest plain value; the new
    pending buffer, the same elementwise operations, equal bit for bit. At
    one row split the call allocates its two outputs and nothing else."""
    args = _k3_card_inputs(W, D, dtype, cuda)
    before = fused_round.fused_async_agg.launches
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    agg, newp = fused_round.fused_async_agg(*args)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - held
    assert fused_round.fused_async_agg.launches == before + 1
    p = fused_round.plan(W, D, args[0].element_size())
    if p.splits == 1:          # the allocator rounds each up to 2 MiB
        assert grown <= 4 * D + 4 * W * D + 2 * 2 ** 21, grown
    want_agg, want_newp = ref.fused_async_agg_ref(*args)
    assert agg.dtype == newp.dtype == torch.float32
    assert agg.shape == (D,) and newp.shape == (W, D)
    assert newp.data_ptr() != args[1].data_ptr()
    torch.testing.assert_close(agg, want_agg, rtol=0, atol=_k3_tol(want_agg))
    assert torch.equal(newp, want_newp)


@pytest.mark.cuda
@pytest.mark.parametrize("W,D,dtype", [(16, 21840, "float32"),
                                       (4096, 21840, "float32"),
                                       (4096, 21840, "bfloat16"),
                                       (10240, 21840, "float32"),
                                       (129, 21839, "bfloat16"), K3_LLM])
def test_fused_async_agg_is_one_deterministic_launch_on_card(cuda, W, D,
                                                             dtype):
    """Two launches give the same bits, and one call is one device kernel
    (one kernel launch, no copy or memset, among the runtime calls the
    profiler records): the splits are summed inside the launch."""
    args = _k3_card_inputs(W, D, dtype, cuda)
    a, b = fused_round.fused_async_agg(*args), \
        fused_round.fused_async_agg(*args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    del a, b
    enqueued, device = _build.launch_records(
        lambda: fused_round.fused_async_agg(*args))
    assert enqueued == ["cudaLaunchKernel"] * 4, enqueued
    assert all("fused_async_agg" in n for n in device), device


@pytest.mark.cuda
@pytest.mark.parametrize("W,D,dtype", [(16, 21840, "float32"),
                                       (4096, 21840, "float32"), K3_LLM])
def test_fused_async_agg_tolerance_rejects_planted_faults_on_card(cuda, W, D,
                                                                 dtype):
    """The check above fails the plain version with each planted fault of
    ``fused_round.FAULTS`` (keep ignored, pending not added, the last row
    dropped, a split summed twice, the weights shifted by a row)."""
    args = _k3_card_inputs(W, D, dtype, cuda)
    want = ref.fused_async_agg_ref(*args)
    for fault in fused_round.FAULTS:
        bad = ref.fused_async_agg_ref(*args, fault=fault)
        assert any(float((x - e).abs().max()) > _k3_tol(e)
                   for x, e in zip(bad, want)), fault
        del bad


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


# few rows and W·D past 2^31 elements, the class of chameleon-34b's round
# pack (2, 1,765,826,560) bf16: D = 2^30 + 128, W·D = 2^31 + 256
BIG_PACK = (2, 1_073_741_952)


@pytest.mark.cuda
def test_trust_kernels_past_2_31_elements_on_card(cuda):
    """K1, K2 and K3 over a (2, 1,073,741,952) bf16 pack (4.3 GB), made on
    the card, against their plain versions: each output within 1e-4 of its
    largest plain value (at least 1), K3's new pending bit for bit; one
    launch each. K1's plan walks 8,388,609 strips of 128 columns in 132
    single-block clusters; K2 and K3 take 4,194,305 column tiles."""
    W, D = BIG_PACK
    gen = torch.Generator(device=cuda).manual_seed(W + D)
    u = torch.randn((W, D), generator=gen, device=cuda).to(torch.bfloat16)
    pending = torch.randn((W, D), generator=gen, device=cuda)
    weights = torch.tensor([0.75, 0.25], device=cuda)
    keep = torch.tensor([0.0, 1.0], device=cuda)
    assert trust_score.plan(W, D, 2) == trust_score.Plan(
        1, 256, 128, 2, 132, 8_388_609)
    assert trust_agg.plan(W, D, 2).tiles == 4_194_305
    assert fused_round.plan(W, D, 2).tiles == 4_194_305
    cases = [(trust_score.trust_score_stats, ref.trust_score_ref, (u,)),
             (trust_agg.trust_agg, ref.trust_agg_ref, (u, weights)),
             (fused_round.fused_async_agg, ref.fused_async_agg_ref,
              (u, pending, weights, keep))]
    for kernel, plain, args in cases:
        before = kernel.launches
        got = kernel(*args)
        got = got if isinstance(got, tuple) else (got,)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        want = plain(*args)
        want = want if isinstance(want, tuple) else (want,)
        for g, e in zip(got, want):
            assert g.shape == e.shape and g.dtype == torch.float32
            tol = 1e-4 * max(1.0, float(e.abs().max()))
            assert float((g - e).abs().max()) <= tol
        if kernel is fused_round.fused_async_agg:
            assert torch.equal(got[1], want[1])
        del got, want
        torch.cuda.empty_cache()


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
    """A CUDA tensor the kernels cannot take raises; it never runs the plain
    version instead: a chunk beyond the wide path's 256, dk beyond its
    1024, bf16 at a wide shape (the wide path is f32 only), a half dtype,
    rows that are not contiguous; and a wide backward without the
    forward's states."""
    q, k, v, a, i, _ = _ssd_inputs(1, 512, 2, 16, 16, "model", False,
                                   "float32", cuda)
    before = (ssd_scan.ssd_scan.launches, ssd_scan.ssd_scan.bwd_launches)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan.ssd_scan(q, k, v, a, i, chunk=512)
    with pytest.raises(TypeError):
        ssd_scan.ssd_scan(q.half(), k.half(), v.half(), a, i, chunk=128)
    huge = torch.zeros((1, 512, 2, 2048), device=cuda)
    with pytest.raises(ValueError, match="dk"):
        ssd_scan.ssd_scan(huge, huge, v, a, i, chunk=128)
    wide = torch.zeros((1, 512, 2, 160), device=cuda)
    with pytest.raises(TypeError, match="wide"):
        ssd_scan.ssd_scan(wide.bfloat16(), wide.bfloat16(), v.bfloat16(), a,
                          i, chunk=128)
    with pytest.raises(ValueError, match="rows"):
        ssd_scan.ssd_scan(q.transpose(2, 3).contiguous().transpose(2, 3), k,
                          v, a, i, chunk=128)
    with pytest.raises(ValueError, match="states"):
        ssd_scan.ssd_scan_bwd(wide, wide, v, a, i, torch.zeros_like(v),
                              chunk=256, states=None)
    assert (ssd_scan.ssd_scan.launches,
            ssd_scan.ssd_scan.bwd_launches) == before


# The wide path (mLSTM's heads: dk = dh, dv = dh + 1 with the ones column
# appended, f32) against ssd_scan_ref: (B, S, H, dk, dv, chunk, gates,
# initial state). xlstm-1.3b's prefill shape (B 4, S 1024, H 4, dk 1024,
# dv 1025, chunk 256: the last 16-column tile holds one column) with the
# model's gates and gentle ones; the smoke config's (dk 128, dv 129, chunk
# 64); a run from an initial state; sizes that are no multiple of the
# kernels' tiles (dk 200, dv 77, chunk 96); a chunk shorter than a warp's
# strip; and chunk 256 at narrow heads.
SSD_WIDE_SERVE = (4, 1024, 4, 1024, 1025, 256)
SSD_WIDE_CASES = [(*SSD_WIDE_SERVE, "mlstm", False),
                  (*SSD_WIDE_SERVE, "gentle", False),
                  (2, 128, 4, 128, 129, 64, "mlstm", False),
                  (2, 128, 4, 128, 129, 64, "gentle", True),
                  (1, 512, 2, 1024, 1025, 256, "mlstm", True),
                  (2, 192, 3, 200, 77, 96, "gentle", True),
                  (1, 40, 2, 256, 257, 40, "mlstm", False),
                  (2, 512, 2, 64, 64, 256, "gentle", True)]


def _wide_inputs(B, S, H, dk, dv, gates, init, dev, seed=0):
    """mLSTM's operands: per-head f32 q, k ~ N(0, 1/dk), v (B, S, H, dv)
    whose last column is ones (the normalizer's), and gates a = log
    sigmoid(3 + N(0, 1)), i = exp(clip(4 N(0, 1), -10, 10)) ("mlstm": the
    forget gate's bias 3, the input gate up to e^10) or a ~ U(-0.02, 0),
    i = softplus(N(0, 1)) ("gentle")."""
    gen = torch.Generator(device=dev).manual_seed(seed + S + H + dk + dv)
    q = torch.randn((B, S, H, dk), generator=gen, device=dev) * dk ** -0.5
    k = torch.randn((B, S, H, dk), generator=gen, device=dev) * dk ** -0.5
    v = torch.randn((B, S, H, dv), generator=gen, device=dev)
    v[..., -1] = 1.0
    if gates == "mlstm":
        f = 3.0 + torch.randn((B, S, H), generator=gen, device=dev)
        a = F.logsigmoid(f)
        i = torch.exp(torch.clamp(
            4.0 * torch.randn((B, S, H), generator=gen, device=dev),
            -10.0, 10.0))
    else:
        a = -0.02 * torch.rand((B, S, H), generator=gen, device=dev)
        i = F.softplus(torch.randn((B, S, H), generator=gen, device=dev))
    h0 = torch.randn((B, H, dk, dv), generator=gen, device=dev) \
        if init else None
    return q, k, v, a, i, h0


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,dk,dv,chunk,gates,init", [
    pytest.param(*c, id="-".join(map(str, c))) for c in SSD_WIDE_CASES])
def test_ssd_scan_wide_matches_plain_version_on_card(cuda, B, S, H, dk, dv,
                                                     chunk, gates, init):
    """y and the final state within ``ssd_scan.excess`` of the plain
    version's f32 result on the same card inputs, one call counted."""
    assert ssd_scan.is_wide(dk, dv, chunk)
    q, k, v, a, i, h0 = _wide_inputs(B, S, H, dk, dv, gates, init, cuda)
    before = ssd_scan.ssd_scan.launches
    y, h = ssd_scan.ssd_scan(q, k, v, a, i, chunk=chunk, initial_state=h0)
    torch.cuda.synchronize()
    assert ssd_scan.ssd_scan.launches == before + 1
    assert y.dtype == torch.float32 and y.shape == v.shape
    assert h.dtype == torch.float32 and h.shape == (B, H, dk, dv)
    y32, h32 = ref.ssd_scan_ref(q, k, v, a, i, chunk=chunk, initial_state=h0)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert ssd_scan.excess(y, y32) <= 0
    assert ssd_scan.excess(h, h32) <= 0


# the planted faults that apply to the wide path: all of them, since it
# splits the gated scores into bf16 parts as the narrow kernel does
WIDE_FAULTS = ssd_scan.FAULTS


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [SSD_WIDE_SERVE, (2, 128, 4, 128, 129, 64)])
def test_ssd_wide_tolerance_rejects_planted_faults_on_card(cuda, shape):
    """At the serve and smoke shapes with gentle gates, the plain version
    with each planted fault fails the check the wide path passes."""
    B, S, H, dk, dv, chunk = shape
    q, k, v, a, i, h0 = _wide_inputs(B, S, H, dk, dv, "gentle", False, cuda)
    y32, h32 = ref.ssd_scan_ref(q, k, v, a, i, chunk=chunk)
    for fault in WIDE_FAULTS:
        fy, fh = ref.ssd_scan_ref(q, k, v, a, i, chunk=chunk, fault=fault)
        assert max(ssd_scan.excess(fy, y32), ssd_scan.excess(fh, h32)) > 0, \
            fault


@pytest.mark.parametrize("f32_at", [None, "q", "v"])
@pytest.mark.cuda
def test_ssd_scan_wide_bf16_values_on_card(cuda, f32_at):
    """At the serve shape with bf16-valued q, k and v (the serve's: their
    second and third bf16 parts are zero, and the kernel skips them), and
    with one f32 row of q or v among them (the slab that holds it takes
    three parts): within ``ssd_scan.excess`` of the plain version, and two
    calls give the same bits."""
    q, k, v, a, i, _ = _wide_inputs(*SSD_WIDE_SERVE[:5], "mlstm", False,
                                    cuda)
    chunk = SSD_WIDE_SERVE[-1]
    exact = [x.bfloat16().float() for x in (q, k, v)]
    if f32_at == "q":
        exact[0][1, 700, 2] = q[1, 700, 2]
    elif f32_at == "v":
        exact[2][2, 300, 1] = v[2, 300, 1]
    y, h = ssd_scan.ssd_scan(*exact, a, i, chunk=chunk)
    y2, h2 = ssd_scan.ssd_scan(*exact, a, i, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(h, h2)
    y32, h32 = ref.ssd_scan_ref(*exact, a, i, chunk=chunk)
    assert ssd_scan.excess(y, y32) <= 0
    assert ssd_scan.excess(h, h32) <= 0


@pytest.mark.cuda
def test_ssd_scan_wide_is_two_deterministic_launches_on_card(cuda):
    """At the serve shape from an initial state, two calls give the same
    bits; 4 calls make 4 x ``WIDE_LAUNCHES`` kernel launches (the bf16
    split of q, k, v and w·v, then the states before each chunk and the
    gated scores, then y) and no copy or memset, and every device record
    the profiler keeps is one of the wide path's kernels."""
    q, k, v, a, i, h0 = _wide_inputs(*SSD_WIDE_SERVE[:5], "mlstm", True,
                                     cuda)
    chunk = SSD_WIDE_SERVE[-1]
    y1, h1 = ssd_scan.ssd_scan(q, k, v, a, i, chunk=chunk, initial_state=h0)
    y2, h2 = ssd_scan.ssd_scan(q, k, v, a, i, chunk=chunk, initial_state=h0)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
    enqueued, device = _build.launch_records(
        lambda: ssd_scan.ssd_scan(q, k, v, a, i, chunk=chunk,
                                  initial_state=h0))
    assert enqueued == ["cudaLaunchKernel"] * (4 * ssd_scan.WIDE_LAUNCHES), \
        enqueued
    assert all("ssd_wide" in n for n in device), device


# K4's wide backward (``csrc/ssd_scan_wide_bwd.cu``) against
# ssd_scan_bwd_ref: (B, S, H, dk, dv, chunk, gates, init), init True for an
# initial state and a dh_final, False for neither (autograd's call in
# training), "h0" for the initial state alone and "dh" for dh_final alone
# (each of the kernel's skips of a state known to be zero on its own). The
# smoke config's mLSTM shape (dk 128, dv 129: a 128-wide column tile and one
# of a single column; chunk 64, two chunks) with the model's gates and
# gentle ones, one full-width head of xlstm-1.3b's training shape (dk 1024,
# dv 1025, chunk 256, two chunks), sizes that are no multiple of the
# 128 x 128 tiles (dk 200, dv 77, chunk 96), and other chunk counts: eight
# (the state's gradient carried through the middle chunks), three, and one
# (the first chunk also the last).
SSD_WIDE_BWD_SMOKE = (2, 128, 4, 128, 129, 64)
SSD_WIDE_BWD_CASES = [(*SSD_WIDE_BWD_SMOKE, "mlstm", False),
                      (*SSD_WIDE_BWD_SMOKE, "gentle", True),
                      (1, 512, 1, 1024, 1025, 256, "mlstm", True),
                      (2, 192, 3, 200, 77, 96, "gentle", True),
                      (*SSD_WIDE_BWD_SMOKE, "mlstm", "h0"),
                      (*SSD_WIDE_BWD_SMOKE, "gentle", "dh"),
                      (1, 512, 2, 128, 129, 64, "gentle", True),
                      (1, 384, 2, 256, 257, 128, "mlstm", "dh"),
                      (2, 64, 2, 160, 161, 64, "mlstm", False),
                      (2, 64, 2, 160, 161, 64, "gentle", True)]


def _wide_bwd_case(B, S, H, dk, dv, chunk, gates, init, dev):
    """mLSTM's operands, the wide forward's states on the card, dy and
    dh_final (``init`` as in ``SSD_WIDE_BWD_CASES``), and the plain
    backward's f32 result on them."""
    q, k, v, a, i, h0 = _wide_inputs(B, S, H, dk, dv, gates,
                                     init in (True, "h0"), dev)
    gen = torch.Generator(device=dev).manual_seed(29)
    dy = torch.randn(v.shape, generator=gen, device=dev)
    dh = torch.randn((B, H, dk, dv), generator=gen, device=dev) \
        if init in (True, "dh") else None
    _, _, states = ssd_scan._launch_fwd(q, k, v, a, i, h0, chunk, True)
    want = ssd_scan.ssd_scan_bwd_ref(q, k, v, a, i, dy, dh, chunk=chunk,
                                     initial_state=h0, states=states)
    return (q, k, v, a, i, dy, dh), h0, states, want


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,dk,dv,chunk,gates,init", [
    pytest.param(*c, id="-".join(map(str, c))) for c in SSD_WIDE_BWD_CASES])
def test_ssd_scan_wide_bwd_matches_plain_backward_on_card(
        cuda, B, S, H, dk, dv, chunk, gates, init):
    """The wide forward's f32 states within the forward's check of the
    plain forward's; dq, dk, dv, da, di and dh0 within
    ``ssd_scan.bwd_margins`` of the plain backward's f32 result on the same
    card inputs and states, one backward call counted."""
    assert ssd_scan.is_wide(dk, dv, chunk)
    args, h0, states, want = _wide_bwd_case(B, S, H, dk, dv, chunk, gates,
                                            init, cuda)
    q, k, v, a, i = args[:5]
    _, _, want_states = ssd_scan.ssd_scan_ref(
        q, k, v, a, i, chunk=chunk, initial_state=h0, return_states=True)
    assert ssd_scan.excess(states, want_states) <= 0
    before = ssd_scan.ssd_scan.bwd_launches
    got = ssd_scan.ssd_scan_bwd(*args, chunk=chunk, initial_state=h0,
                                states=states)
    torch.cuda.synchronize()
    assert ssd_scan.ssd_scan.bwd_launches == before + 1
    assert [g.dtype for g in got] == [torch.float32] * 6
    assert got[2].shape == (B, S, H, dv) and got[5].shape == (B, H, dk, dv)
    assert all(torch.isfinite(g).all() for g in got)
    margins = ssd_scan.bwd_margins(got, want)
    assert max(margins.values()) <= 1, margins


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [SSD_WIDE_BWD_SMOKE,
                                   (1, 512, 1, 1024, 1025, 256)])
def test_ssd_scan_wide_bwd_skips_move_no_bit_on_card(cuda, shape):
    """Without an initial state ``_SSDScan`` asks for no dh0, and the wide
    backward leaves out the update that only dh0 reads: its dq, dk, dv, da
    and di (with a loss on y alone, so no dh_final either) are bitwise
    those of ``ssd_scan_bwd`` called with dh0 asked for on the same states;
    and that call's dh0 is the plain backward's within the tolerance."""
    B, S, H, dk, dv, chunk = shape
    q, k, v, a, i, _ = _wide_inputs(B, S, H, dk, dv, "mlstm", False, cuda)
    gen = torch.Generator(device=cuda).manual_seed(31)
    dy = torch.randn(v.shape, generator=gen, device=cuda)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v, a, i)]
    before = ssd_scan.ssd_scan.bwd_launches
    y, _ = ssd_scan.ssd_scan(*leaves, chunk=chunk)
    got = torch.autograd.grad(y, leaves, dy)
    assert ssd_scan.ssd_scan.bwd_launches == before + 1
    _, _, states = ssd_scan._launch_fwd(q, k, v, a, i, None, chunk, True)
    direct = ssd_scan.ssd_scan_bwd(q, k, v, a, i, dy, chunk=chunk,
                                   states=states)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, direct[:5]))
    want = ssd_scan.ssd_scan_bwd_ref(q, k, v, a, i, dy, chunk=chunk,
                                     states=states)
    margins = ssd_scan.bwd_margins(direct, want)
    assert max(margins.values()) <= 1, margins
    none = ssd_scan.ssd_scan_bwd(q, k, v, a, i, dy, chunk=chunk,
                                 states=states, want_dh0=False)
    assert none[5] is None
    assert all(torch.equal(x, y) for x, y in zip(none[:5], direct[:5]))


@pytest.mark.cuda
@pytest.mark.parametrize("gates", ["gentle", "mlstm"])
def test_ssd_wide_bwd_tolerance_rejects_planted_faults_on_card(cuda, gates):
    """At the smoke shape each of ``BWD_FAULTS`` fails the check the wide
    backward passes above, by a margin > 1."""
    args, h0, states, want = _wide_bwd_case(*SSD_WIDE_BWD_SMOKE, gates, True,
                                            cuda)
    for fault in ssd_scan.BWD_FAULTS:
        got = ssd_scan.ssd_scan_bwd_ref(*args, chunk=SSD_WIDE_BWD_SMOKE[-1],
                                        initial_state=h0, states=states,
                                        fault=fault)
        assert max(ssd_scan.bwd_margins(got, want).values()) > 1, fault


@pytest.mark.cuda
def test_ssd_scan_wide_bwd_is_deterministic_on_card(cuda):
    """Two calls give the same bits; 4 calls make 4 x ``WIDE_BWD_LAUNCHES``
    kernel launches and no copy or memset, and every device record the
    profiler keeps is one of the wide backward's kernels."""
    args, h0, states, _ = _wide_bwd_case(*SSD_WIDE_BWD_SMOKE, "mlstm", True,
                                         cuda)
    chunk = SSD_WIDE_BWD_SMOKE[-1]
    one = ssd_scan.ssd_scan_bwd(*args, chunk=chunk, initial_state=h0,
                                states=states)
    two = ssd_scan.ssd_scan_bwd(*args, chunk=chunk, initial_state=h0,
                                states=states)
    assert all(torch.equal(x, y) for x, y in zip(one, two))
    enqueued, device = _build.launch_records(
        lambda: ssd_scan.ssd_scan_bwd(*args, chunk=chunk, initial_state=h0,
                                      states=states))
    assert enqueued == ["cudaLaunchKernel"] * (
        4 * ssd_scan.WIDE_BWD_LAUNCHES), enqueued
    assert all("ssd_wide_bwd" in n for n in device), device


@pytest.mark.cuda
def test_ssd_scan_wide_autograd_on_card_matches_autograd_of_plain(cuda):
    """``ssd_scan`` under grad at a wide shape on the card (the wide forward
    with its states, then the wide backward) against ``torch.autograd``
    through the plain forward on the same card inputs, with an initial
    state and a loss on the final state."""
    B, S, H, dk, dv, chunk = SSD_WIDE_BWD_SMOKE
    q, k, v, a, i, h0 = _wide_inputs(B, S, H, dk, dv, "mlstm", True, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    dy = torch.randn(v.shape, generator=gen, device=cuda)
    dh = torch.randn(h0.shape, generator=gen, device=cuda)
    base = [x.detach().clone().requires_grad_(True)
            for x in (q, k, v, a, i, h0)]

    def run(fn):
        for x in base:
            x.grad = None
        y, h = fn(*base[:5], chunk=chunk, initial_state=base[5])
        torch.autograd.backward([y, h], [dy, dh])
        return [x.grad.clone() for x in base]
    before = (ssd_scan.ssd_scan.launches, ssd_scan.ssd_scan.bwd_launches)
    got = run(ssd_scan.ssd_scan)
    torch.cuda.synchronize()
    assert (ssd_scan.ssd_scan.launches, ssd_scan.ssd_scan.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    want = run(ssd_scan.ssd_scan_ref)
    margins = ssd_scan.bwd_margins(got, want)
    assert max(margins.values()) <= 1, margins


@pytest.mark.cuda
def test_kernel_wrappers_refuse_grad_on_card(cuda):
    """Fault F4: K1-K3 and K5 have no backward, so each of their four
    wrappers raises on a CUDA input that requires grad while grad mode is
    on, before it launches; the same call under ``no_grad`` launches once.
    K4 has a backward: a zamba2 forward (2 Mamba2 layers and the shared
    block, smoke widths) whose params require grad launches K4 once a
    Mamba2 layer, and its backward the K4 backward kernel once a layer,
    giving every leaf a finite gradient; under ``no_grad`` the forward
    launches K4 once a layer and no backward."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import api
    u, pending, weights, keep = _inputs(8, 4096, "bfloat16", cuda)
    rng = np.random.default_rng(5)
    sq, kc, vc = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(cuda) for s in ((2, 8, 64), (2, 300, 2, 64),
                                        (2, 300, 2, 64)))
    calls = [
        (trust_score.trust_score_stats, lambda g: (g(u),)),
        (trust_agg.trust_agg, lambda g: (g(u), weights)),
        (fused_round.fused_async_agg, lambda g: (u, g(pending), weights,
                                                 keep)),
        (swa_decode.swa_decode, lambda g: (sq, kc, g(vc), 299, 128)),
    ]
    for fn, args in calls:
        before = fn.launches
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*args(lambda t: t.clone().requires_grad_(True)))
        assert fn.launches == before, fn.__name__
        with torch.no_grad():
            fn(*args(lambda t: t.clone().requires_grad_(True)))
        fn(*args(lambda t: t))             # grad mode, nothing requires it
        torch.cuda.synchronize()
        assert fn.launches == before + 2, fn.__name__

    cfg = get_smoke_config("zamba2-7b").replace(num_layers=2)
    params = api.init(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    tokens = torch.zeros((1, cfg.ssm.chunk_size), dtype=torch.long,
                         device=cuda)
    trained = {n: p.requires_grad_(True) for n, p in params.items()}
    K4 = ssd_scan.ssd_scan
    before = (K4.launches, K4.bwd_launches)
    logits, _ = api.forward(trained, cfg, {"tokens": tokens})
    assert (K4.launches, K4.bwd_launches) == (before[0] + 2, before[1])
    grads = torch.autograd.grad(logits.float().square().mean(),
                                list(trained.values()))
    torch.cuda.synchronize()
    assert (K4.launches, K4.bwd_launches) == (before[0] + 2, before[1] + 2)
    assert all(torch.isfinite(g).all() for g in grads)
    with torch.no_grad():
        logits, _ = api.forward(trained, cfg, {"tokens": tokens})
    torch.cuda.synchronize()
    assert torch.isfinite(logits).all()
    assert (K4.launches, K4.bwd_launches) == (before[0] + 4, before[1] + 2)


# K4's backward against ssd_scan_bwd_ref: (B, S, H, dk, dv, chunk, gates,
# initial state and dh_final, per-head q and k). zamba2-7b's training shape
# (B 4, S 512, H 112, chunk 128) with its gates and with gentle ones, the
# smoke config's SSD shape, one chunk, a run from an initial state with a
# nonzero dh_final, per-head q and k, dk = dv = 128 (the first design, the
# rows read from global memory), and a chunk of 80 with dk, dv padded.
# Then the tensor-core design's clusters of 4 blocks a (b, h): 3 chunks (a
# block without one), 5 (runs of 2, 2, 1 and none) and 12 (runs of 3,
# restaged), per-head q and k from an initial state at dk = dv = 128, and a
# chunk of 40 (the first design, the rows in shared memory).
SSD_BWD_TRAIN = (4, 512, 112, 64, 64, 128)
SSD_BWD_CASES = [(*SSD_BWD_TRAIN, "model", False, False),
                 (*SSD_BWD_TRAIN, "gentle", False, False),
                 (4, 128, 8, 16, 64, 64, "gentle", False, False),
                 (2, 128, 16, 64, 64, 128, "gentle", False, False),
                 (2, 512, 8, 64, 64, 128, "gentle", True, False),
                 (2, 512, 8, 64, 64, 128, "model", True, True),
                 (1, 256, 2, 128, 128, 128, "gentle", True, False),
                 (2, 160, 3, 24, 40, 80, "gentle", True, True),
                 (4, 384, 8, 64, 64, 128, "model", True, False),
                 (2, 640, 4, 64, 64, 128, "gentle", True, False),
                 (2, 1536, 4, 64, 64, 128, "model", True, True),
                 (1, 256, 2, 128, 128, 128, "model", True, True),
                 (2, 160, 3, 24, 40, 40, "gentle", True, True)]


def _ssd_bwd_case(B, S, H, dk, dv, chunk, gates, init, per_head, dtype,
                  dev, seed=0):
    """K4's operands, the forward's states on the card, dy and dh_final,
    and the plain backward's f32 result on them."""
    q, k, v, a, i, h0 = _ssd_inputs(B, S, H, dk, dv, gates, init, dtype, dev,
                                    seed=seed, per_head=per_head)
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    dy = torch.randn((B, S, H, dv), generator=gen, device=dev).to(v.dtype)
    dh = torch.randn((B, H, dk, dv), generator=gen, device=dev) \
        if init else None
    _, _, states = ssd_scan._launch_fwd(q, k, v, a, i, h0, chunk, True)
    want = ssd_scan.ssd_scan_bwd_ref(q.float(), k.float(), v.float(), a, i,
                                     dy, dh, chunk=chunk, initial_state=h0,
                                     states=states)
    return (q, k, v, a, i, dy, dh), h0, states, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,dk,dv,chunk,gates,init,per_head",
                         SSD_BWD_CASES,
                         ids=["-".join(map(str, c)) for c in SSD_BWD_CASES])
def test_ssd_scan_bwd_matches_plain_backward_on_card(
        cuda, B, S, H, dk, dv, chunk, gates, init, per_head, dtype):
    """dq, dk, dv, da, di and dh0 within ``ssd_scan.bwd_margins`` of the
    plain backward's f32 result on the same card inputs and states, one
    backward launch a call; and the forward's states within the forward's
    check of the plain forward's."""
    args, h0, states, want = _ssd_bwd_case(B, S, H, dk, dv, chunk, gates,
                                           init, per_head, dtype, cuda)
    q, k, v, a, i = args[:5]
    _, _, want_states = ssd_scan.ssd_scan_ref(
        q.float(), k.float(), v.float(), a, i, chunk=chunk,
        initial_state=h0, return_states=True)
    assert ssd_scan.excess(states, want_states) <= 0
    before = ssd_scan.ssd_scan.bwd_launches
    got = ssd_scan.ssd_scan_bwd(*args, chunk=chunk, initial_state=h0,
                                states=states)
    torch.cuda.synchronize()
    assert ssd_scan.ssd_scan.bwd_launches == before + 1
    assert [g.dtype for g in got] == [v.dtype] * 3 + [torch.float32] * 3
    assert got[0].shape == (B, S, H, dk) and got[5].shape == (B, H, dk, dv)
    assert all(torch.isfinite(g.float()).all() for g in got)
    margins = ssd_scan.bwd_margins(got, want)
    assert max(margins.values()) <= 1, margins


# a shape that each instantiation of the backward kernel takes in each
# dtype: the tensor-core design, and the first with the rows in shared memory
# and read from global memory
SSD_BWD_DESIGN_SHAPES = [(2, 256, 4, 64, 64, 128), (2, 160, 3, 24, 40, 40),
                         (1, 256, 2, 128, 128, 128)]


@pytest.mark.cuda
def test_ssd_scan_bwd_launches_every_instantiation_on_card(cuda):
    """Every instantiation that the backward kernel's dispatch can pick
    (``ssd_scan.BWD_DESIGNS``, by ``ssd_scan.bwd_design``) is launched,
    once a call, and passes the check against the plain backward."""
    seen = set()
    for dtype in ("bfloat16", "float32"):
        for B, S, H, dk, dv, chunk in SSD_BWD_DESIGN_SHAPES:
            seen.add(ssd_scan.bwd_design(getattr(torch, dtype), dk, dv,
                                         chunk))
            args, h0, states, want = _ssd_bwd_case(
                B, S, H, dk, dv, chunk, "model", True, False, dtype, cuda)
            before = ssd_scan.ssd_scan.bwd_launches
            got = ssd_scan.ssd_scan_bwd(*args, chunk=chunk, initial_state=h0,
                                        states=states)
            torch.cuda.synchronize()
            assert ssd_scan.ssd_scan.bwd_launches == before + 1
            margins = ssd_scan.bwd_margins(got, want)
            assert max(margins.values()) <= 1, (dtype, chunk, dk, margins)
    assert seen == set(range(len(ssd_scan.BWD_DESIGNS))), seen


@pytest.mark.cuda
@pytest.mark.parametrize("gates", ["gentle", "model"])
def test_ssd_scan_bwd_tolerance_rejects_planted_faults_on_card(cuda, gates):
    """At the training shape each of ``BWD_FAULTS`` fails the check the
    kernel passes above, by a margin > 1."""
    args, h0, states, want = _ssd_bwd_case(*SSD_BWD_TRAIN, gates, True,
                                           False, "bfloat16", cuda)
    for fault in ssd_scan.BWD_FAULTS:
        got = ssd_scan.ssd_scan_bwd_ref(
            *(x.float() if x is not None else None for x in args),
            chunk=128, initial_state=h0, states=states, fault=fault)
        assert max(ssd_scan.bwd_margins(got, want).values()) > 1, fault


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_bwd_is_one_deterministic_launch_on_card(cuda, dtype):
    """4 calls make 4 kernel launches and no copy or memset, and two calls
    give the same bits."""
    args, h0, states, _ = _ssd_bwd_case(2, 512, 8, 64, 64, 128, "model",
                                        True, False, dtype, cuda)
    one = ssd_scan.ssd_scan_bwd(*args, chunk=128, initial_state=h0,
                                states=states)
    two = ssd_scan.ssd_scan_bwd(*args, chunk=128, initial_state=h0,
                                states=states)
    assert all(torch.equal(x, y) for x, y in zip(one, two))
    enqueued, device = _build.launch_records(
        lambda: ssd_scan.ssd_scan_bwd(*args, chunk=128, initial_state=h0,
                                      states=states))
    assert enqueued == ["cudaLaunchKernel"] * 4, enqueued
    assert all("ssd_chunk_scan_bwd" in n for n in device), device


@pytest.mark.cuda
@pytest.mark.parametrize("per_head", [False, True])
def test_ssd_scan_autograd_on_card_matches_autograd_of_plain(cuda, per_head):
    """``ssd_scan`` under grad on the card (K4 with its states, then the
    backward kernel) against ``torch.autograd`` through the plain forward
    on the same card inputs, with an initial state and a loss on the final
    state; q and k shared by the heads go through the expand backward."""
    q, k, v, a, i, h0 = _ssd_inputs(2, 256, 8, 64, 64, "gentle", True,
                                    "float32", cuda, per_head=per_head)
    gen = torch.Generator(device=cuda).manual_seed(3)
    dy = torch.randn(v.shape, generator=gen, device=cuda)
    dh = torch.randn(h0.shape, generator=gen, device=cuda)
    base = [x.detach().clone().requires_grad_(True)
            for x in ((q if per_head else q[:, :, :1]),
                      (k if per_head else k[:, :, :1]), v, a, i, h0)]

    def run(fn):
        for x in base:
            x.grad = None
        qq, kk = base[:2]
        if not per_head:
            qq, kk = (x.expand(q.shape) for x in (qq, kk))
        y, h = fn(qq, kk, *base[2:5], chunk=128, initial_state=base[5])
        torch.autograd.backward([y, h], [dy, dh])
        return [x.grad.clone() for x in base]
    before = (ssd_scan.ssd_scan.launches, ssd_scan.ssd_scan.bwd_launches)
    got = run(ssd_scan.ssd_scan)
    torch.cuda.synchronize()
    assert (ssd_scan.ssd_scan.launches, ssd_scan.ssd_scan.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    want = run(ssd_scan.ssd_scan_ref)
    margins = ssd_scan.bwd_margins(got, want)
    assert max(margins.values()) <= 1, margins


@pytest.mark.cuda
def test_hybrid_protocol_inits_and_trains_on_card(cuda):
    """Fault F5: ``SDFLBProtocol`` over zamba2 on the card draws its
    weights from a CPU generator, which ``init_mamba2`` handed to
    ``torch.randn`` with the card as device (a RuntimeError). Now the
    weights are the CPU's, bit for bit but A_log, the log of a linspace
    that each device takes itself (within f32 roundings), and a sync
    round (2 x 2 workers, smoke config) launches K4 and its backward."""
    from repro_torch.configs.base import FederationConfig, TrainConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core.protocol import SDFLBProtocol
    from repro_torch.data.datasets import synthetic_tokens
    from repro_torch.models import api
    cfg = get_smoke_config("zamba2-7b")
    fed = FederationConfig(num_clusters=2, workers_per_cluster=2)
    tc = TrainConfig(optimizer="adamw", lr=3e-4, grad_clip=1.0)
    proto = SDFLBProtocol(cfg, fed, tc, use_blockchain=False, seed=0,
                          device=cuda)
    cpu = api.init(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    for k, v in cpu.items():
        got = proto.global_params[k].cpu()
        if k.endswith("A_log"):
            torch.testing.assert_close(got, v, rtol=1e-6, atol=0)
        else:
            assert torch.equal(got, v), k
    K4 = ssd_scan.ssd_scan
    before = (K4.launches, K4.bwd_launches)
    rec = proto.run_round(synthetic_tokens(4, 2, 128, cfg.vocab_size, seed=0))
    torch.cuda.synchronize()
    assert K4.launches > before[0] and K4.bwd_launches > before[1]
    assert np.isfinite(rec.scores).all() and np.isfinite(rec.losses).all()
    proto.finalize()


@pytest.mark.cuda
def test_xlstm_worker_step_on_card(cuda):
    """``SDFLBProtocol`` over xlstm-1.3b's smoke config on the card (mLSTM
    heads of dh 128, dv 129: K4's wide path) starts from the CPU's weights
    bit for bit and trains one sync round: each worker's step (remat, the
    default) launches K4's wide forward twice (the forward and backward's
    recompute of the one mLSTM block) and its wide backward once, and its
    loss after the step K4's forward once more; scores and losses are
    finite."""
    from repro_torch.configs.base import FederationConfig, TrainConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core.protocol import SDFLBProtocol
    from repro_torch.data.datasets import synthetic_tokens
    from repro_torch.models import api
    cfg = get_smoke_config("xlstm-1.3b")
    fed = FederationConfig(num_clusters=2, workers_per_cluster=2)
    tc = TrainConfig(optimizer="adamw", lr=3e-4, grad_clip=1.0)
    proto = SDFLBProtocol(cfg, fed, tc, use_blockchain=False, seed=0,
                          device=cuda)
    cpu = api.init(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    for k, v in cpu.items():
        assert torch.equal(proto.global_params[k].cpu(), v), k
    K4 = ssd_scan.ssd_scan
    before = (K4.launches, K4.bwd_launches)
    rec = proto.run_round(synthetic_tokens(4, 2, 128, cfg.vocab_size, seed=0))
    torch.cuda.synchronize()
    assert (K4.launches - before[0], K4.bwd_launches - before[1]) == (12, 4)
    assert np.isfinite(rec.scores).all() and np.isfinite(rec.losses).all()
    proto.finalize()


def _moe_case(dtype, dev, seed=0):
    """A small MoE layer (d 64, 8 experts top-2, one shared expert, cf 1.0)
    and its input: the second half of each row repeats the first, so equal
    routing weights meet at the capacity boundary and tokens drop."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe
    cfg = MoEConfig(num_experts=8, top_k=2, d_ff_expert=96,
                    num_shared_experts=1, d_ff_shared=64, capacity_factor=1.0)
    gen = torch.Generator().manual_seed(seed)
    p = moe.init_moe(gen, 64, cfg, getattr(torch, dtype), "cpu")
    x = torch.randn((2, 96, 64), generator=gen).to(getattr(torch, dtype))
    x[:, 48:] = x[:, :48]
    dout = torch.randn((2, 96, 64), generator=gen)
    return cfg, {k: v.to(dev) for k, v in p.items()}, x.to(dev), dout.to(dev)


def _moe_fwd_bwd(cfg, p, x, dout):
    """The gather path's output, aux loss, and the gradients of
    sum(out · dout) + aux with respect to x and every param."""
    from repro_torch.models import moe
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    x = x.detach().clone().requires_grad_(True)
    out, aux = moe.apply_moe(p, x, cfg)
    grads = torch.autograd.grad((out.float() * dout).sum() + aux,
                                [x, *p.values()])
    return [out.detach(), aux.detach(), *grads], list(p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_matches_cpu_on_card(cuda, dtype):
    """The MoE layer on the card against the same layer on the CPU from the
    same weights and inputs: the same experts and dropped tokens, outputs
    and gradients within 1e-4 (f32) or two bf16 steps (bf16) of each
    tensor's largest value."""
    from repro_torch.models import moe
    cfg, p, x, dout = _moe_case(dtype, cuda)
    plans = []
    for dev in (cuda, torch.device("cpu")):
        xf = x.to(dev).reshape(-1, 64)
        probs, _ = moe._router_probs({"router": p["router"].to(dev)}, xf, cfg)
        w, idx = moe._topk_weights(probs, cfg.top_k)
        plans.append([t.cpu() for t in moe._routes(w, idx, moe.capacity(
            cfg, xf.shape[0], cfg.capacity_factor))])
    for a, b in zip(*plans):
        assert torch.equal(a, b)
    assert not plans[0][3].all()                 # the capacity drops tokens
    got, names = _moe_fwd_bwd(cfg, p, x, dout)
    want, _ = _moe_fwd_bwd(cfg, {k: v.cpu() for k, v in p.items()}, x.cpu(),
                           dout.cpu())
    rtol = 1e-4 if dtype == "float32" else 2.0 ** -7
    for name, a, b in zip(["out", "aux", "x", *names], got, want):
        a, b = a.cpu().float(), b.float()
        assert torch.isfinite(a).all(), name
        assert (a - b).abs().max() <= rtol * b.abs().max().clamp_min(1e-6), \
            name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_is_bitwise_deterministic_on_card(cuda, dtype):
    """Without ``torch.use_deterministic_algorithms``, three runs of the MoE
    layer's forward and backward give the same bits: the combine and the
    dispatch's backward add in a fixed order, with no float atomics."""
    assert not torch.are_deterministic_algorithms_enabled()
    cfg, p, x, dout = _moe_case(dtype, cuda, seed=1)
    runs = [_moe_fwd_bwd(cfg, p, x, dout)[0] for _ in range(3)]
    for again in runs[1:]:
        for a, b in zip(runs[0], again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_moe_protocol_inits_and_trains_on_card(cuda):
    """``SDFLBProtocol`` over qwen2-moe-a2.7b's smoke config (shared
    experts) starts on the card with the CPU's weights bit for bit, takes
    the per-leaf trust path (no kernel launch) and trains one sync round
    to finite scores and losses."""
    from repro_torch.configs.base import FederationConfig, TrainConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core.protocol import SDFLBProtocol
    from repro_torch.data.datasets import synthetic_tokens
    from repro_torch.models import api
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    fed = FederationConfig(num_clusters=2, workers_per_cluster=2)
    tc = TrainConfig(optimizer="adamw", lr=3e-4, grad_clip=1.0)
    proto = SDFLBProtocol(cfg, fed, tc, use_blockchain=False, seed=0,
                          device=cuda)
    cpu = api.init(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    assert set(cpu) == set(proto.global_params)
    for k, v in cpu.items():
        assert proto.global_params[k].device.type == "cuda"
        assert torch.equal(proto.global_params[k].cpu(), v), k
    wrappers = (trust_score.trust_score_stats, trust_agg.trust_agg,
                fused_round.fused_async_agg)
    before = [f.launches for f in wrappers]
    rec = proto.run_round(synthetic_tokens(4, 2, 128, cfg.vocab_size, seed=0))
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == before
    assert np.isfinite(rec.scores).all() and np.isfinite(rec.losses).all()
    proto.finalize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_absorbed_decode_matches_cpu_on_card(cuda, dtype):
    """MLA's absorbed decode (minicpm3-4b's smoke config, layer 0) on the
    card against the CPU from the same weights, input and a latent cache of
    40 slots filled at random, at cur_index 23: the output within 1e-5
    (f32) or one bf16 step (bf16) of its largest value, the cache written
    in place at slot 23 alone, equal on both devices. No kernel launches."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import api, layers, transformer
    resolve_device(cuda)
    cfg = get_smoke_config("minicpm3-4b").replace(dtype=dtype)
    p = api.init(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    attn = transformer.all_layer_params(p, cfg)[0]["attn"]
    rng = np.random.default_rng(3)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((2, 1, 256)).astype(
        np.float32)).to(dt)
    lat = torch.from_numpy(rng.standard_normal((2, 40, 48)).astype(
        np.float32)).to(dt)
    kw = dict(num_heads=cfg.num_heads, mla=cfg.mla, rope_theta=cfg.rope_theta,
              cur_index=23)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        cache = {"latent": lat.clone().to(dev)}
        o, new = layers.apply_mla({k: v.to(dev) for k, v in attn.items()},
                                  x.to(dev), positions=torch.full(
                                      (1,), 23, device=dev), cache=cache, **kw)
        assert new["latent"] is cache["latent"]
        outs.append((o.cpu().float(), new["latent"].cpu()))
    (o, c), (want_o, want_c) = outs
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -8
    assert (o - want_o).abs().max() <= rtol * want_o.abs().max()
    moved = (c != lat).any(dim=(0, 2)).nonzero().flatten()
    assert moved.tolist() == [23]
    torch.testing.assert_close(c.float(), want_c.float(), rtol=0,
                               atol=rtol * float(want_c.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_encoder_matches_cpu_on_card(cuda, dtype):
    """whisper-base's encoder (smoke config: 2 layers over 64 frames,
    non-causal attention with RoPE, GELU MLPs, LayerNorms) on the card
    against the CPU from the same weights and frames, and one decode
    step's logits over the prefill's caches: within 1e-4 (f32) or the
    serve parity's bf16 0.125 of the CPU's."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import api, encdec
    resolve_device(cuda)
    cfg = get_smoke_config("whisper-base").replace(dtype=dtype)
    p = api.init(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(rng.standard_normal((2, 64, 256)).astype(
        np.float32))
    toks = torch.from_numpy(rng.integers(0, 512, (2, 9)))
    tol = 1e-4 if dtype == "float32" else 0.125
    got = []
    for dev in (cuda, torch.device("cpu")):
        pd = {k: v.to(dev) for k, v in p.items()}
        with torch.no_grad():
            enc = encdec.encode(pd, cfg, frames.to(dev))
            _, cache = api.prefill(pd, cfg, {"tokens": toks[:, :8].to(dev),
                                             "frames": frames.to(dev)}, 16)
            lg, _ = api.decode_step(pd, cfg, cache, toks[:, 8:].to(dev), 8)
        got.append((enc.cpu().float(), lg.cpu().float()))
    (enc, lg), (want_enc, want_lg) = got
    assert torch.isfinite(enc).all() and torch.isfinite(lg).all()
    assert (enc - want_enc).abs().max() <= tol
    assert (lg - want_lg).abs().max() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm3-4b", "whisper-base"])
def test_mla_and_encdec_protocols_init_and_train_on_card(cuda, arch):
    """F5's check for the two new families: ``SDFLBProtocol`` over the
    smoke config starts on the card with the CPU's weights bit for bit,
    takes the per-leaf trust path (no kernel launch) and trains one sync
    round (whisper's batches carry frames) to finite scores and losses."""
    from repro_torch.configs.base import FederationConfig, TrainConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core.protocol import SDFLBProtocol
    from repro_torch.data.datasets import synthetic_tokens
    from repro_torch.models import api
    cfg = get_smoke_config(arch)
    fed = FederationConfig(num_clusters=2, workers_per_cluster=2)
    tc = TrainConfig(optimizer="adamw", lr=3e-4, grad_clip=1.0)
    proto = SDFLBProtocol(cfg, fed, tc, use_blockchain=False, seed=0,
                          device=cuda)
    cpu = api.init(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    assert set(cpu) == set(proto.global_params)
    for k, v in cpu.items():
        assert proto.global_params[k].device.type == "cuda"
        assert torch.equal(proto.global_params[k].cpu(), v), k
    batch = synthetic_tokens(4, 2, 64, cfg.vocab_size, seed=0)
    if cfg.family == "audio":
        batch["frames"] = np.random.default_rng(0).standard_normal(
            (4, 2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    wrappers = (trust_score.trust_score_stats, trust_agg.trust_agg,
                fused_round.fused_async_agg, swa_decode.swa_decode,
                ssd_scan.ssd_scan)
    before = [f.launches for f in wrappers]
    rec = proto.run_round(batch)
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == before
    assert np.isfinite(rec.scores).all() and np.isfinite(rec.losses).all()
    proto.finalize()


def _vlm_grads(cfg, p, batch):
    from repro_torch.models import api
    pr = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    loss, _ = api.lm_loss_fn(cfg, kv_chunk=16)(pr, batch)
    g = torch.autograd.grad(loss, list(pr.values()))
    return float(loss.detach()), {k: x.float().cpu() for k, x in zip(pr, g)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_serve_and_loss_gradient_match_cpu_on_card(cuda, dtype):
    """chameleon-34b's smoke config (16 patches before the prompt) on the
    card against the CPU from the same weights: ``serve`` (a 24-token
    prompt, 4 greedy tokens; the patches drawn on the CPU from the seed)
    within 1e-4 (f32) or the serve parity's bf16 0.125, the tokens equal
    up to a near tie; the loss within 1e-4 / 2e-3 and every leaf's
    gradient within 2e-4 / 5e-2 of its largest value, in bf16 plus the
    CPU's own bf16-vs-f32 gap of that leaf (the CPU sums repeated tokens'
    embedding rows in bf16). No kernel launches."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import api
    cfg32 = get_smoke_config("chameleon-34b").replace(dtype="float32")
    cfg = cfg32.replace(dtype=dtype)
    p32 = api.init(cfg32, torch.Generator().manual_seed(0),
                   torch.device("cpu"))
    p = {k: v.to(getattr(torch, dtype)) for k, v in p32.items()}
    tol = {"float32": (1e-4, 1e-4, 2e-4),
           "bfloat16": (0.125, 2e-3, 5e-2)}[dtype]
    wrappers = (trust_score.trust_score_stats, trust_agg.trust_agg,
                fused_round.fused_async_agg, swa_decode.swa_decode,
                ssd_scan.ssd_scan)
    before = [f.launches for f in wrappers]
    kw = dict(batch=2, prompt_len=24, gen=4, seed=3)
    card = serve(cfg, device=cuda,
                 params={k: v.to(cuda) for k, v in p.items()}, **kw)
    cpu = serve(cfg, device="cpu", params=p, **kw)
    lg, want = card.logits.float().cpu(), cpu.logits.float()
    same = (card.tokens.cpu() == cpu.tokens).all(dim=0)
    upto = int(same.float().argmin()) if not same.all() else 4
    if upto < 4:
        top2 = want[:, upto].topk(2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) <= 2 * tol[0]
    assert torch.isfinite(lg).all()
    assert (lg - want)[:, :upto + 1].abs().max() <= tol[0]

    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, 512, (1, 48)))
    pe = torch.from_numpy(rng.standard_normal((1, 16, 256)).astype(
        np.float32))
    batch = {"tokens": toks, "labels": toks, "patch_embeds": pe}
    loss, g = _vlm_grads(cfg, {k: v.to(cuda) for k, v in p.items()},
                         {k: v.to(cuda) for k, v in batch.items()})
    want_loss, want_g = _vlm_grads(cfg, p, batch)
    _, g32 = _vlm_grads(cfg32, p32, batch)
    assert np.isfinite(loss) and abs(loss - want_loss) <= tol[1]
    for k in g:
        scale = want_g[k].abs().max().clamp_min(1e-30)
        gap = 0.0 if dtype == "float32" else float(
            (want_g[k] - g32[k]).abs().max() / scale)
        assert float((g[k] - want_g[k]).abs().max() / scale) <= \
            tol[2] + gap, k
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == before
