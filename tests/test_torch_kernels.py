"""The port's trust kernels K1 (statistics), K2 (sync aggregate) and K3
(async aggregate and flush) against the JAX package's Pallas kernels, run in
interpret mode, and against ``repro.kernels.ref``.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
themselves are checked against the same plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``). Inputs are made from a
seed with numpy and handed to both packages. Tolerances are those of
``tests/test_kernels.py``: f32 2e-5 for the aggregates and 1e-4 (times D,
absolute) for the statistics, bf16 2e-2 and 5e-2 — the two frameworks sum
in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_round as jfused
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, fused_round, ref, trust_agg, \
    trust_score

jax.config.update("jax_enable_x64", False)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(W, D, dtype, seed=0):
    rng = np.random.default_rng(seed * 7919 + W * 31 + D)
    u = rng.standard_normal((W, D)).astype(np.float32)
    pending = rng.standard_normal((W, D)).astype(np.float32)
    weights = rng.random(W).astype(np.float32)
    keep = (rng.random(W) > 0.5).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    ju = jnp.asarray(u).astype(jdt)
    tu = torch.from_numpy(u).to(tdt)
    return u, ju, tu, pending, weights, keep


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [1, 127, 2053])
@pytest.mark.parametrize("W", [1, 2, 16, 33])
def test_trust_kernels_match_pallas_and_ref(W, D, dtype):
    _, ju, tu, pending, weights, keep = _inputs(W, D, dtype)
    f32 = dtype == "float32"
    agg_tol = 2e-5 if f32 else 2e-2
    stat_tol = 1e-4 if f32 else 5e-2

    # K1: statistics
    got = trust_score.trust_score_stats(tu)
    pallas = jops._trust_score_stats(ju, interpret=True)
    oracle = jref.trust_score_ref(ju)
    for g, p, o in zip(got, pallas, oracle):
        for expect in (p, o):
            np.testing.assert_allclose(_np(g), _np(expect), rtol=stat_tol,
                                       atol=stat_tol * D)

    # K2: sync aggregate
    tw = torch.from_numpy(weights)
    got = trust_agg.trust_agg(tu, tw)
    for expect in (jops._trust_agg(ju, jnp.asarray(weights), interpret=True),
                   jref.trust_agg_ref(ju, jnp.asarray(weights))):
        np.testing.assert_allclose(_np(got), _np(expect), rtol=agg_tol,
                                   atol=agg_tol)

    # K3: async aggregate + flush; the port's pending is unpadded (W, D),
    # the TPU kernel's is padded to its tile grid
    agg, newp = fused_round.fused_async_agg(
        tu, torch.from_numpy(pending), tw, torch.from_numpy(keep))
    assert newp.shape == (W, D) and newp.dtype == torch.float32
    wp, dp = jfused.pending_shape(W, D)
    jpend = jnp.zeros((wp, dp), jnp.float32).at[:W, :D].set(pending)
    jagg, jnewp = jfused.fused_async_agg_kernel(
        ju, jpend, jnp.asarray(weights), jnp.asarray(keep), interpret=True)
    np.testing.assert_allclose(_np(agg), _np(jagg), rtol=agg_tol,
                               atol=agg_tol)
    np.testing.assert_allclose(_np(newp), _np(jnewp)[:W, :D], rtol=agg_tol,
                               atol=agg_tol)
    # the JAX padding carries nothing the port drops
    assert not np.asarray(jnewp)[W:].any()
    assert not np.asarray(jnewp)[:, D:].any()
    ragg, rnewp = jref.fused_async_agg_ref(ju, jnp.asarray(pending),
                                           jnp.asarray(weights),
                                           jnp.asarray(keep))
    np.testing.assert_allclose(_np(agg), _np(ragg), rtol=agg_tol,
                               atol=agg_tol)
    np.testing.assert_allclose(_np(newp), _np(rnewp), rtol=agg_tol,
                               atol=agg_tol)


def test_wrappers_reject_what_the_kernels_do_not_take():
    u = torch.zeros((4, 8))
    with pytest.raises(TypeError):
        trust_score.trust_score_stats(u.double())
    with pytest.raises(ValueError):
        trust_score.trust_score_stats(torch.zeros((0, 8)))
    with pytest.raises(ValueError):
        trust_agg.trust_agg(u, torch.zeros(3))
    with pytest.raises(ValueError):
        fused_round.fused_async_agg(u, torch.zeros((4, 7)), torch.zeros(4),
                                    torch.zeros(4))


def test_hbm_accounting():
    """The port's chain streams the update matrix twice (K1 once, then K2
    or K3), as the TPU chain does."""
    W, D = 10240, 21840
    for dt in (torch.float32, torch.bfloat16):
        for am in (False, True):
            assert fused_round.update_passes(W, D, dt, async_mode=am) == 2.0
    k1 = trust_score.hbm_bytes(W, D, 4)
    assert k1["update_read"] == W * D * 4
    assert k1["minimum"] < k1["total"]
    # K3 in one launch: its splits are the plan's, and their f32 sums are
    # the only traffic beyond the minimum (none with one split)
    k3 = fused_round.hbm_bytes(W, D, 4)
    k3_plan = fused_round.plan(W, D, 4)
    assert k3_plan.splits == -(-W // k3_plan.rows) > 1
    assert k3_plan.threads <= fused_round.MAX_THREADS == 256  # kMaxThreads
    assert k3["total"] - k3["minimum"] == 2 * k3_plan.splits * D * 4
    # K2 in one launch: the matrix once, plus its splits' f32 sums (under
    # 2 % of the matrix at W = 10240) and none with one split
    for itemsize in (4, 2):
        k2 = trust_agg.hbm_bytes(W, D, itemsize)
        splits = trust_agg.plan(W, D, itemsize).splits
        assert k2["update_read"] == W * D * itemsize
        assert k2["minimum"] == W * D * itemsize + W * 4 + D * 4
        assert k2["total"] - k2["minimum"] == 2 * splits * D * 4
        assert k2["total"] < 1.02 * k2["minimum"]
    small = trust_agg.hbm_bytes(16, D, 4)
    assert small["total"] == small["minimum"] == 16 * D * 4 + 16 * 4 + D * 4


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("D", [1, 7, 2053, 21839, 21840, 1 << 20])
@pytest.mark.parametrize("W", [1, 7, 16, 63, 64, 129, 4096, 10240, 100_000])
def test_trust_agg_plan_covers_every_row_and_column_once(W, D, itemsize):
    """K2's launch plan: the splits take every row once, in order, none
    empty; the column tiles take every column once, 16-byte pieces only
    where D allows them."""
    p = trust_agg.plan(W, D, itemsize)
    assert 1 <= p.splits <= min(W, trust_agg.MAX_SPLITS)
    # the kernel derives the rows from the splits the same way
    assert p.rows == -(-W // p.splits)
    spans = [(s * p.rows, min(W, (s + 1) * p.rows)) for s in range(p.splits)]
    assert spans[0][0] == 0 and spans[-1][1] == W
    assert all(a < b for a, b in spans)
    assert all(spans[i][1] == spans[i + 1][0] for i in range(p.splits - 1))
    assert p.vec == (16 // itemsize if D % (16 // itemsize) == 0 else 1)
    tile = trust_agg.THREADS * p.vec          # columns per block
    assert (p.tiles - 1) * tile < D <= p.tiles * tile
    if p.splits > 1:
        assert p.rows >= trust_agg.MIN_SPLIT_ROWS
    assert trust_agg.plan(W, D, itemsize, aligned=False).vec == 1


def test_trust_agg_plan_fills_the_card_at_the_main_path_shape():
    """W = 16, D = 21840 f32 (the sync round): one split, and enough column
    tiles for every SM; at W = 4096 the splits raise the grid further."""
    p = trust_agg.plan(16, 21840, 4)
    assert p.splits == 1 and p.rows == 16
    assert p.tiles * p.splits >= trust_agg.SMS
    for W, itemsize in ((4096, 4), (4096, 2), (10240, 4)):
        big = trust_agg.plan(W, 21840, itemsize)
        assert big.splits > 1 and big.tiles * big.splits >= trust_agg.SMS


def test_trust_agg_block_width_matches_the_kernel():
    """The plan's column tiles assume the kernel's block width: THREADS is
    ``kThreads`` in csrc/trust_agg.cu."""
    import re
    src = (_build.CSRC / "trust_agg.cu").read_text()
    assert re.findall(r"constexpr int kThreads = (\d+);", src) == \
        [str(trust_agg.THREADS)]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("D", [1, 7, 2053, 21839, 21840, 1 << 20])
@pytest.mark.parametrize("W", [1, 7, 16, 129, 1000, 4096, 10240, 65536])
def test_trust_score_plan_covers_every_row_and_column(W, D, itemsize):
    """K1's launch plan: the cluster's blocks hold every row, each at least
    one, and their rows of a strip fit the threads' registers (16 pieces a
    thread); the strips cover every column; the clusters take one block an
    SM and have a strip each."""
    p = trust_score.plan(W, D, itemsize)
    assert p.cluster in trust_score.CLUSTERS and p.strip in trust_score.STRIPS
    assert p.cols * itemsize == p.strip
    assert p.cluster * p.rows >= W > (p.cluster - 1) * p.rows
    assert p.rows * p.strip <= trust_score.BLOCK_BYTES[itemsize]
    assert (p.strips - 1) * p.cols < D <= p.strips * p.cols
    assert 1 <= p.clusters <= p.strips
    assert p.clusters * p.cluster <= trust_score.SMS


def test_trust_score_plan_at_the_paper_shapes():
    """256-byte strip rows and one block a cluster at W = 16 (132 blocks);
    clusters of 16 at W = 4096 and, with 128-byte strip rows, at
    W = 10240; above MAX_W the plan raises."""
    assert trust_score.plan(16, 21840, 4)[:2] == (1, 256)
    assert trust_score.plan(16, 21840, 4).clusters == trust_score.SMS
    assert trust_score.plan(4096, 21840, 4)[:2] == (16, 256)
    assert trust_score.plan(4096, 21840, 2)[:2] == (16, 256)
    assert trust_score.plan(10240, 21840, 4)[:2] == (16, 128)
    assert trust_score.MAX_W >= 65536
    with pytest.raises(ValueError, match="rows"):
        trust_score.plan(trust_score.MAX_W + 1, 21840, 4)


def test_trust_score_plan_at_smollm_full_size():
    """The LLM round's flat pack: W = 8 rows of D = 134,515,008 (smollm-135m,
    bf16; f32 too). One block a cluster, 256-byte strips, 132 clusters
    walking ~8k strips each. D and W · D fit the kernels' 32-bit int
    arguments, but the matrix's byte offsets (and K3's f32 pending) pass
    2^31: the kernels form row · D in 64 bits."""
    D = 134_515_008
    for isz in (2, 4):
        p = trust_score.plan(8, D, isz)
        assert p[:2] == (1, 256) and p.rows == 8
        assert p.clusters == trust_score.SMS
        assert (p.strips - 1) * p.cols < D <= p.strips * p.cols
    assert 8 * D < 2 ** 31 < 8 * D * 2
    src = (_build.CSRC / "trust_score.cu").read_text()
    assert "const T* p = u + row * D + col;" in src and \
        "int64_t row, int64_t col" in src
    for name, frag in (("trust_agg.cu", "(int64_t)(r + i) * step"),
                       ("fused_async_agg.cu", "const int64_t row = r + i;"),
                       ("fused_async_agg.cu", "pc + row * pstep + j"),
                       ("fused_async_agg.cu", "oc[row * pstep + j]")):
        assert frag in (_build.CSRC / name).read_text(), name


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("D", [1, 127, 2053, 21839, 21840])
@pytest.mark.parametrize("W", [1, 2, 16, 33, 129, 4096, 10240])
def test_fused_async_agg_plan_covers_every_row_and_column_once(W, D,
                                                               itemsize):
    """K3's launch plan: the splits take every row once, in order, none
    empty, each of at least MIN_SPLIT_ROWS rows when there are several;
    the column tiles take every column once, 16-byte pieces only where D
    allows them."""
    p = fused_round.plan(W, D, itemsize)
    assert 1 <= p.splits <= W
    # the kernel derives the rows from the splits the same way
    assert p.rows == -(-W // p.splits)
    spans = [(s * p.rows, min(W, (s + 1) * p.rows)) for s in range(p.splits)]
    assert spans[0][0] == 0 and spans[-1][1] == W
    assert all(a < b for a, b in spans)
    assert all(spans[i][1] == spans[i + 1][0] for i in range(p.splits - 1))
    if p.splits > 1:
        assert p.rows >= fused_round.MIN_SPLIT_ROWS
    assert p.vec == (16 // itemsize if D % (16 // itemsize) == 0 else 1)
    assert p.threads % 32 == 0 and p.threads <= fused_round.MAX_THREADS
    tile = p.threads * p.vec                  # columns per block
    assert (p.tiles - 1) * tile < D <= p.tiles * tile
    assert fused_round.plan(W, D, itemsize, aligned=False).vec == 1


def test_fused_async_agg_plan_at_the_paper_and_llm_shapes():
    """W = 16, D = 21840 f32 (the async round): one split and more blocks
    than the card has SMs. The LLM round's flat pack (W = 8, D =
    134,515,008 bf16): one split, so no partial sums: the HBM traffic is
    the minimum. W = 4096 and 10240: row splits raise the grid."""
    p = fused_round.plan(16, 21840, 4)
    assert p.splits == 1 and p.rows == 16 and p.vec == 4
    assert p.tiles * p.splits > fused_round.SMS
    D = 134_515_008
    llm = fused_round.plan(8, D, 2)
    assert llm.splits == 1 and llm.vec == 8
    hbm = fused_round.hbm_bytes(8, D, 2)
    assert hbm["total"] == hbm["minimum"] == \
        8 * D * 2 + 2 * 8 * D * 4 + 2 * 8 * 4 + D * 4
    small = fused_round.hbm_bytes(16, 21840, 4)
    assert small["total"] == small["minimum"]
    for W, itemsize in ((4096, 4), (4096, 2), (10240, 4)):
        big = fused_round.plan(W, 21840, itemsize)
        assert big.splits > 1 and big.tiles * big.splits >= fused_round.SMS


def test_fused_async_agg_block_width_matches_the_kernel():
    """The plan's widest block is the kernel's: MAX_THREADS is
    ``kMaxThreads`` in csrc/fused_async_agg.cu."""
    import re
    src = (_build.CSRC / "fused_async_agg.cu").read_text()
    assert re.findall(r"constexpr int kMaxThreads = (\d+);", src) == \
        [str(fused_round.MAX_THREADS)]


def _k3_margins(args, floor):
    """Each planted fault of K3's plain version against the plain version:
    its largest distance over the card's tolerance, RTOL of the largest
    plain value of each output (at least ``floor``); > 1 rejects."""
    want = ref.fused_async_agg_ref(*args)
    margins = {}
    for fault in fused_round.FAULTS:
        bad = ref.fused_async_agg_ref(*args, fault=fault)
        margins[fault] = max(
            float((b - e).abs().max())
            / (1e-4 * max(floor, float(e.abs().max())))
            for b, e in zip(bad, want))
    return margins


@pytest.mark.parametrize("W", [16, 4096])
def test_fused_async_agg_tolerance_rejects_planted_faults(W):
    """The card's check (1e-4 of the largest plain value of each output, at
    least 1) fails the plain version with each planted fault, at one row
    split (W 16) and at several (W 4096); at the LLM round's scale (W 8,
    updates ~1e-3, the flat-pack round's participation) the check without
    the floor of 1 does."""
    _, _, u, pending, weights, keep = _inputs(W, 300, "float32")
    args = (u, torch.from_numpy(pending), torch.from_numpy(weights),
            torch.from_numpy(keep))
    assert (fused_round.plan(W, 300, 4).splits > 1) == (W == 4096)
    margins = _k3_margins(args, floor=1.0)
    assert min(margins.values()) > 1, margins
    # the LLM flat pack's async round: rows 2 and 5 sat out (keep 1, weight
    # 0), the others' weights sum to 1; updates and pending ~1e-3
    rng = np.random.default_rng(W)
    part = np.array([1, 1, 0, 1, 1, 0, 1, 1], np.float32)
    w = rng.random(8).astype(np.float32) * part
    llm = (torch.from_numpy(rng.standard_normal((8, 4096)).astype(
               np.float32) * 1e-3).bfloat16(),
           torch.from_numpy(rng.standard_normal((8, 4096)).astype(
               np.float32) * 1e-3),
           torch.from_numpy(w / w.sum()), torch.from_numpy(1 - part))
    margins = _k3_margins(llm, floor=0.0)
    assert min(margins.values()) > 1, margins
    with pytest.raises(ValueError, match="fault"):
        ref.fused_async_agg_ref(*args, fault="nope")


def test_grad_guard_rejects_exactly_what_it_should():
    """``_build.check_no_grad`` (fault F4): raises when grad mode is on and
    an input requires grad; passes under ``no_grad``, for inputs that do
    not require grad, and for absent (None) inputs."""
    x, y = torch.ones(3), torch.ones(3, requires_grad=True)
    _build.check_no_grad("k", x, None)
    with pytest.raises(RuntimeError, match="k: the CUDA kernel has no "
                       "backward"):
        _build.check_no_grad("k", x, y)
    with pytest.raises(RuntimeError):
        _build.check_no_grad("k", (y * 2)[:1])
    with torch.no_grad():
        _build.check_no_grad("k", x, y)
    with torch.inference_mode():
        _build.check_no_grad("k", y)
    _build.check_no_grad("k", y.detach())
    # the CPU plain versions stay differentiable through the wrappers
    u = torch.ones((2, 5), requires_grad=True)
    w = torch.full((2,), 0.5)
    trust_agg.trust_agg(u, w).sum().backward()
    torch.testing.assert_close(u.grad, torch.full((2, 5), 0.5))


def test_trust_score_constants_match_the_kernel():
    """The plan's limits are the kernel's: THREADS ``kThreads``,
    ROWS_A_THREAD ``rows_a_thread`` and the widest strip ``kMaxStrip`` in
    csrc/trust_score.cu."""
    import re
    src = (_build.CSRC / "trust_score.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kThreads") == trust_score.THREADS
    assert const("kMaxStrip") == max(trust_score.STRIPS)
    f32, bf16 = re.search(r"return sizeof\(T\) == 4 \? (\d+) : (\d+);",
                          src).groups()
    assert trust_score.ROWS_A_THREAD == {4: int(f32), 2: int(bf16)}


@pytest.mark.parametrize("W", [16, 600])
def test_trust_score_tolerance_rejects_planted_faults(W):
    """The card's check (1e-4 of the largest plain value of each output)
    fails the plain version with each planted fault, at one block a
    cluster (W 16) and at clusters of 2 (W 600)."""
    u = _inputs(W, 300, "float32")[2]
    want = ref.trust_score_ref(u)
    assert trust_score.plan(W, 300, 4).cluster == (1 if W == 16 else 2)
    for fault in trust_score.FAULTS:
        bad = ref.trust_score_ref(u, fault=fault)
        assert any(float((x - e).abs().max())
                   > 1e-4 * max(1.0, float(e.abs().max()))
                   for x, e in zip(bad, want)), fault
    with pytest.raises(ValueError, match="fault"):
        ref.trust_score_ref(u, fault="nope")


def test_ctypes_signatures_match_the_c_entry_points():
    """Each ``_build._SIGNATURES`` entry lists the C entry point's
    parameters in order, the stream last: pointers as c_void_p, ``int`` as
    c_int, ``long long`` as c_int64. A missing entry makes ctypes pass a
    pointer as a 32-bit int, which nvcc cannot catch."""
    import ctypes
    import re
    kinds = {"int": ctypes.c_int, "long long": ctypes.c_int64}
    found = {}
    for src in _build.CSRC.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text()):
            found[name] = [
                kinds.get(" ".join(p.split()[:-1]).replace("const ", ""),
                          ctypes.c_void_p) if "*" not in p else
                ctypes.c_void_p for p in params.split(",")]
    assert set(found) == set(_build._SIGNATURES)
    for name, argtypes in _build._SIGNATURES.items():
        assert argtypes == found[name], name
