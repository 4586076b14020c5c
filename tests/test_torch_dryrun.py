"""The port's dry run for one card (``repro_torch.launch.{mesh,specs,
dryrun}``, ``api.cache_struct``) against the JAX package's on the CPU, and
its counter and the kernels' abstract branches on known programs.

Against the reference (``repro.launch.{specs,dryrun}``, ``repro.models.
api``), exactly: every arch's parameter leaves and count (``init_specs``
against ``jax.eval_shape`` of the reference's init), ``model_flops`` and
``params_active`` of every applicable (arch, shape) pair, ``cache_struct``
at decode_32k and long_500k, ``make_cache`` at smoke size, and the batch
structs of a train and a prefill step for the vlm and audio families.

The reference counts parameters at tp = 16 (``dryrun.model_flops``), where
qwen2-moe-a2.7b's 60 experts a layer are padded to 64 and the four padding
experts count as active; one card has tp = 1 and no padding. So the
reference is asked at tp = 1, the one card's mesh, and the tp = 16 count
is held to differ by exactly the padding experts.

The counter (``dryrun.Counter``): a matmul's flops and bytes in its dtype's
bucket, a chain of views moving nothing, and the peak of live storage.
Every kernel wrapper on fake tensors: outputs of the plain version's shape
and dtype, no build, load or launch, no launch counter moved, and exactly
the module's own flops and total bytes added to the counter.

The JAX package is imported through the ``jref`` fixture, the workaround
for fault F1 of the reference (ROADMAP.md, Queue 3).
"""
import functools
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import pytest
import torch

from repro_torch.configs.registry import ARCH_IDS, INPUT_SHAPES, \
    applicable, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels import _build, fused_round, ssd_scan, swa_decode, \
    trust_agg, trust_score
from repro_torch.launch import dryrun, mesh, specs
from repro_torch.models import api

ROOT = pathlib.Path(__file__).resolve().parent.parent
PAIRS = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES
         if applicable(a, s)[0]]
DECODE = [(a, s) for a, s in PAIRS if INPUT_SHAPES[s].kind == "decode"]
DEV = specs.DEVICE


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
    jax.devices()            # the backend is up before dryrun sets XLA_FLAGS
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    from repro.configs.registry import get_config as jget
    from repro.configs.registry import get_smoke_config as jsmoke
    from repro.launch import specs as jspecs
    from repro.models import api as japi
    return types.SimpleNamespace(dryrun=jdry, specs=jspecs, api=japi,
                                 get=jget, smoke=jsmoke)


@functools.lru_cache(maxsize=None)
def _ref_leaves(arch, tp):
    """The reference's param leaves of ``arch`` at ``tp``: {path: shape}."""
    from repro.configs.registry import get_config as jget
    from repro.models import api as japi
    sds = jax.eval_shape(lambda k: japi.init(jget(arch), k, tp=tp)[0],
                         jax.random.PRNGKey(0))
    return {jax.tree_util.keystr(p): tuple(x.shape)
            for p, x in jax.tree_util.tree_leaves_with_path(sds)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_specs_has_the_reference_leaves(jref, arch):
    """``init_specs`` (fake tensors) has as many leaves as the reference's
    ``jax.eval_shape`` of its init, and as many parameters at tp = 1."""
    params = specs.init_specs(get_config(arch))
    ref = _ref_leaves(arch, 1)
    assert len(params) == len(ref)
    assert sum(v.numel() for v in params.values()) == \
        sum(int(torch.tensor(s).prod()) for s in ref.values())
    assert all(v.device.type == DEV.type for v in params.values())


_INITS = {}     # (reference config, tp) -> the reference's init_specs


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_model_flops_match_the_reference(jref, monkeypatch, arch, shape):
    """``model_flops`` and ``params_active`` equal the reference's on one
    card's mesh (tp = 1), exactly. At the reference's tp = 16 only
    qwen2-moe-a2.7b differs, by its padding experts."""
    init = jref.specs.init_specs

    def cached(one_card):
        def f(cfg, tp):
            key = (cfg, 1 if one_card else tp)
            if key not in _INITS:
                _INITS[key] = init(*key)
            return _INITS[key]
        return f
    mf, n = dryrun.model_flops(arch, shape)
    monkeypatch.setattr(jref.specs, "init_specs", cached(False))
    mf16, n16 = jref.dryrun.model_flops(arch, shape)
    monkeypatch.setattr(jref.specs, "init_specs", cached(True))
    assert (mf, n) == jref.dryrun.model_flops(arch, shape)
    cfg = get_config(arch)
    pad = 0
    if cfg.moe.enabled and cfg.moe.num_experts % 16:
        extra = -cfg.moe.num_experts % 16
        # each padding expert's three matrices and its router column
        pad = cfg.num_layers * extra * cfg.d_model * (
            3 * cfg.moe.d_ff_expert + 1)
    assert n16 - n == pad
    assert mf16 * n == mf * n16


def test_chameleon_decode_anchor():
    """chameleon-34b at decode_32k: 34,293,424,128 parameters, 2 N a token
    for 128 sequences, and a K/V cache that no card holds."""
    mf, n = dryrun.model_flops("chameleon-34b", "decode_32k")
    assert n == 34_293_424_128
    assert mf == 2 * n * 128 == 8_779_116_576_768
    cache = api.cache_struct(get_config("chameleon-34b"), 128, 32768)
    kv = sum(int(torch.tensor(s).prod()) * torch.empty((), dtype=d)
             .element_size() for s, d in cache.values())
    assert kv == 48 * 128 * 32768 * 8 * 128 * 2 * 2 > mesh.HBM_BYTES


def _struct(tree, prefix=""):
    """{path: (shape, dtype name)} of a (nested) dict of (shape, dtype)
    pairs, ShapeDtypeStructs or tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_struct(v, f"{prefix}{k}/"))
        elif isinstance(v, tuple):
            out[prefix + k] = (tuple(v[0]), str(v[1]).replace("torch.", ""))
        else:
            out[prefix + k] = (tuple(v.shape),
                               str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch,shape", DECODE)
def test_cache_struct_matches_the_reference(jref, arch, shape):
    sh = INPUT_SHAPES[shape]
    got = _struct(api.cache_struct(get_config(arch), sh.global_batch,
                                   sh.seq_len))
    want = _struct(jref.api.cache_struct(jref.get(arch), sh.global_batch,
                                         sh.seq_len))
    assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_cache_is_zeros_of_cache_struct(jref, arch):
    """At smoke size: the reference's zeros, leaf for leaf, in shape, dtype
    and bits."""
    cfg = get_smoke_config(arch)
    tc = api.make_cache(cfg, 2, 24, "cpu")
    jc = jref.api.make_cache(jref.smoke(arch), 2, 24)
    assert _struct(tc) == _struct(api.cache_struct(cfg, 2, 24)) == \
        _struct(jc)

    def leaves(t):
        return [x for v in t.values() for x in
                (leaves(v) if isinstance(v, dict) else [v])]
    assert all(not x.any() for x in leaves(tc))


@pytest.mark.parametrize("arch", ["chameleon-34b", "whisper-base"])
def test_batch_structs_match_the_reference(jref, arch):
    cfg, jcfg = get_config(arch), jref.get(arch)
    tr = INPUT_SHAPES["train_4k"]
    W = 16
    got = _struct(specs._batch_struct(cfg, W, 1, tr.global_batch // W,
                                      tr.seq_len))
    want = _struct(jref.specs._batch_struct(jcfg, W, 1,
                                            tr.global_batch // W,
                                            tr.seq_len))
    assert got == want
    pf = INPUT_SHAPES["prefill_32k"]
    assert _struct(specs._prefill_batch_struct(cfg, pf.global_batch,
                                               pf.seq_len)) == \
        _struct(jref.specs._prefill_batch_struct(jcfg, pf.global_batch,
                                                 pf.seq_len))


def test_one_card_mesh_and_federation():
    m = mesh.make_production_mesh()
    assert m.axis_names == ("data", "model") and m.devices == 1
    assert mesh.tp_size(m) == mesh.dp_size(m) == 1
    assert mesh.data_axes(m) == ("data",)
    with pytest.raises(ValueError, match="one card"):
        mesh.make_production_mesh(multi_pod=True)
    from repro_torch.configs.base import FederationConfig
    from repro_torch.core import fl_step
    fed = specs.federation_for(m, FederationConfig())
    assert fl_step.num_workers(fed) == 16
    assert INPUT_SHAPES["train_4k"].global_batch // 16 == 16
    big = specs.train_config_for(get_config("chameleon-34b"))
    assert big.opt_dtype == "bfloat16" and big.remat
    assert specs.train_config_for(get_config("yi-6b")).opt_dtype == \
        "float32"


# -- the counter ---------------------------------------------------------

@pytest.mark.parametrize("dtype,bucket", [(torch.bfloat16, "bf16"),
                                          (torch.float32, "f32")])
def test_counter_counts_a_matmul(dtype, bucket):
    M, K, N = 64, 96, 40
    with specs.new_fake_mode():
        a = torch.empty((M, K), dtype=dtype, device=DEV)
        b = torch.empty((K, N), dtype=dtype, device=DEV)
        c = dryrun.Counter()
        with c:
            a @ b
    isz = torch.empty((), dtype=dtype).element_size()
    assert c.flops == {"bf16": 0, "f32": 0, bucket: 2 * M * N * K}
    assert c.nbytes == (M * K + K * N + M * N) * isz


def test_counter_counts_no_bytes_for_views():
    with specs.new_fake_mode():
        a = torch.empty((64, 128), device=DEV)
        c = dryrun.Counter()
        with c:
            v = a.view(128, 64).t()[1:].unsqueeze(0).expand(3, -1, -1)
            v = v.permute(2, 0, 1).select(0, 2).detach()
            v = torch.as_strided(v, (4, 4), (1, 4))
    assert c.calls >= 8 and c.nbytes == 0 and c.flops["f32"] == 0


def test_counter_peak_of_live_storage():
    """Allocate A, allocate B, free A, allocate C: the peak is max(A + B,
    B + C); views of a storage count once; sizes round up to 512 bytes."""
    A, B, C = 4096 * 4, 1024 * 4, 8192 * 4
    with specs.new_fake_mode():
        c = dryrun.Counter()
        with c:
            a = torch.empty(A // 4, device=DEV)
            b = torch.empty(B // 4, device=DEV)
            a2 = a[10:]
            del a, a2
            cc = torch.empty(C // 4, device=DEV)
            assert c.live == B + C
            d = torch.empty(3, device=DEV)
            assert c.live == B + C + 512
            del b, cc, d
    assert c.peak == max(A + B, B + C) + 512 and c.live == 0


# -- the kernels' abstract branches -------------------------------------------

COUNTS = [(trust_score.trust_score_stats, "launches"),
          (trust_agg.trust_agg, "launches"),
          (fused_round.fused_async_agg, "launches"),
          (swa_decode.swa_decode, "launches"),
          (ssd_scan.ssd_scan, "launches"), (ssd_scan.ssd_scan, "bwd_launches")]


@pytest.fixture
def no_build(monkeypatch):
    """The library may not be built, loaded or launched; the launch
    counters may not move."""
    def refuse(*a, **k):
        raise AssertionError("the abstract branch reached the library")
    for name in ("load", "build", "launch", "scratch"):
        monkeypatch.setattr(_build, name, refuse)
    before = [getattr(f, a) for f, a in COUNTS]
    yield
    assert [getattr(f, a) for f, a in COUNTS] == before


def _fake_call(fn, specs_in):
    """fn on fake tensors of ``specs_in`` ((shape, dtype) or a Python
    value) under a counter; (outputs as (shape, dtype), the counter)."""
    with specs.new_fake_mode():
        args = [torch.empty(s[0], dtype=s[1], device=DEV)
                if isinstance(s, tuple) else s for s in specs_in]
        c = dryrun.Counter()
        with c:
            out = fn(*args)
        assert all(_build.is_fake(x) for x in
                   (out if isinstance(out, tuple) else (out,))
                   if x is not None)
        got = [None if x is None else (tuple(x.shape), x.dtype)
               for x in (out if isinstance(out, tuple) else (out,))]
    return got, c


def _plain(fn, specs_in, seed=0):
    gen = torch.Generator().manual_seed(seed)
    args = [torch.randn(s[0], generator=gen).to(s[1])
            if isinstance(s, tuple) else s for s in specs_in]
    out = fn(*args)
    return [None if x is None else (tuple(x.shape), x.dtype)
            for x in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trust_kernels_abstract_branch(no_build, dtype):
    W, D = 129, 4099
    isz = torch.empty((), dtype=dtype).element_size()
    u, w = ((W, D), dtype), ((W,), torch.float32)
    pend = ((W, D), torch.float32)
    cases = [(trust_score.trust_score_stats, trust_score.trust_score_ref,
              [u], "trust_score", trust_score.flops(W, D),
              trust_score.hbm_bytes(W, D, isz)["total"]),
             (trust_agg.trust_agg, trust_agg.trust_agg_ref, [u, w],
              "trust_agg", trust_agg.flops(W, D),
              trust_agg.hbm_bytes(W, D, isz)["total"]),
             (fused_round.fused_async_agg, fused_round.fused_async_agg_ref,
              [u, pend, w, w], "fused_async_agg", fused_round.flops(W, D),
              fused_round.hbm_bytes(W, D, isz)["total"])]
    for wrapper, plain, ins, name, flops, nbytes in cases:
        got, c = _fake_call(wrapper, ins)
        assert got == _plain(plain, ins), name
        assert c.kernels == {name: {"calls": 1, "flops": flops,
                                    "bytes": nbytes}}
        assert c.flops["f32"] == flops and c.flops["bf16"] == 0


@pytest.mark.parametrize("cur", [40, 700])
def test_swa_decode_abstract_branch(no_build, cur):
    B, H, KV, hd, S, window = 2, 8, 2, 64, 768, 256
    ins = [((B, H, hd), torch.bfloat16), ((B, S, KV, hd), torch.bfloat16),
           ((B, S, KV, hd), torch.bfloat16), cur, window]
    got, c = _fake_call(swa_decode.swa_decode, ins)
    assert got == _plain(swa_decode.swa_decode_ref, ins)
    assert c.kernels == {"swa_decode": {
        "calls": 1, "flops": swa_decode.flops(B, H, hd, window, cur),
        "bytes": swa_decode.hbm_bytes(B, H, KV, hd, window, cur,
                                      2)["total"]}}
    assert c.flops["bf16"] == swa_decode.flops(B, H, hd, window, cur)


# (B, S, H, dk, dv, chunk): the narrow kernel, and the wide path
K4_SHAPES = [(2, 64, 3, 16, 32, 16), (1, 64, 2, 136, 137, 32)]


def _k4_inputs(B, S, H, dk, dv, dtype):
    return [((B, S, H, dk), dtype), ((B, S, H, dk), dtype),
            ((B, S, H, dv), dtype), ((B, S, H), torch.float32),
            ((B, S, H), torch.float32)]


@pytest.mark.parametrize("shape", K4_SHAPES)
@pytest.mark.parametrize("with_states", [False, True])
def test_ssd_scan_forward_abstract_branch(no_build, shape, with_states):
    B, S, H, dk, dv, chunk = shape
    wide = ssd_scan.is_wide(dk, dv, chunk)
    ins = _k4_inputs(B, S, H, dk, dv, torch.float32)
    got, c = _fake_call(lambda *a: ssd_scan._launch_fwd(
        *a, None, chunk, with_states), ins)
    want = _plain(lambda q, k, v, a, i: ssd_scan.ssd_scan_ref(
        q, k, v, -a.abs(), i, chunk=chunk, return_states=True), ins)
    assert got == want[:2] + [want[2] if with_states else None]
    scratch = ssd_scan.wide_scratch_layout_bytes(B, S, H, dk, dv, chunk) \
        if wide else 0
    nbytes = ssd_scan.total_bytes(
        ssd_scan.hbm_bytes(B, S, H, dk, dv, 4, qk_per_head=True)["minimum"],
        scratch=scratch,
        saved=B * (S // chunk) * H * dk * dv * 4 if with_states else 0)
    assert c.kernels == {"ssd_scan": {
        "calls": 1, "flops": ssd_scan.flops(B, S, H, dk, dv, chunk),
        "bytes": nbytes}}


@pytest.mark.parametrize("shape", K4_SHAPES)
def test_ssd_scan_under_grad_abstract_branches(no_build, shape):
    """``_SSDScan``'s forward keeps the (B, nc, H, dk, dv) f32 states and
    its backward takes ``ssd_scan_bwd``'s abstract branch: dq, dk, dv of
    the inputs' shapes, and the backward's flops and bytes, less the
    products the wide backward skips (no initial state, no dh_final, no
    dh0 asked for)."""
    B, S, H, dk, dv, chunk = shape
    wide = ssd_scan.is_wide(dk, dv, chunk)
    with specs.new_fake_mode():
        q, k, v, a, i = [torch.empty(s, dtype=d, device=DEV,
                                     requires_grad=True)
                         for s, d in _k4_inputs(B, S, H, dk, dv,
                                                torch.float32)]
        c = dryrun.Counter()
        with c:
            y, h = ssd_scan.ssd_scan(q, k, v, a, i, chunk=chunk)
            g = torch.autograd.grad(y.sum(), [q, k, v, a, i])
    assert [tuple(x.shape) for x in g] == [tuple(x.shape)
                                           for x in (q, k, v, a, i)]
    known = dict(initial_state=False, dh_final=False, dh0=False) \
        if wide else {}
    scratch = ssd_scan.wide_bwd_scratch_layout_bytes(
        B, S, H, dk, dv, chunk, initial_state=False, dh_final=False) \
        if wide else 0
    assert c.kernels["ssd_scan_bwd"] == {
        "calls": 1,
        "flops": ssd_scan.bwd_flops(B, S, H, dk, dv, chunk, **known),
        "bytes": ssd_scan.total_bytes(ssd_scan.bwd_hbm_bytes(
            B, S, H, dk, dv, chunk, 4, qk_per_head=True,
            **known)["minimum"], scratch=scratch)}
    assert c.kernels["ssd_scan"]["calls"] == 1


@pytest.mark.parametrize("shape", K4_SHAPES)
def test_ssd_scan_backward_abstract_branch(no_build, shape):
    """``ssd_scan_bwd`` called directly, with every input: the plain
    backward's shapes (dq, dk, dv in the inputs' dtype on the card)."""
    B, S, H, dk, dv, chunk = shape
    nc = S // chunk
    ins = _k4_inputs(B, S, H, dk, dv, torch.float32) + [
        ((B, S, H, dv), torch.float32), ((B, H, dk, dv), torch.float32),
        ((B, H, dk, dv), torch.float32), ((B, nc, H, dk, dv),
                                          torch.float32)]
    got, c = _fake_call(lambda q, k, v, a, i, dy, dhf, h0, st:
                        ssd_scan.ssd_scan_bwd(q, k, v, a, i, dy, dhf,
                                              chunk=chunk, initial_state=h0,
                                              states=st), ins)
    want = _plain(lambda q, k, v, a, i, dy, dhf, h0, st:
                  ssd_scan.ssd_scan_bwd_ref(q, k, v, -a.abs(), i, dy, dhf,
                                            chunk=chunk, initial_state=h0),
                  ins)
    assert got == want
    wide = ssd_scan.is_wide(dk, dv, chunk)
    scratch = ssd_scan.wide_bwd_scratch_layout_bytes(B, S, H, dk, dv,
                                                     chunk) if wide else 0
    assert c.kernels == {"ssd_scan_bwd": {
        "calls": 1, "flops": ssd_scan.bwd_flops(B, S, H, dk, dv, chunk),
        "bytes": ssd_scan.total_bytes(ssd_scan.bwd_hbm_bytes(
            B, S, H, dk, dv, chunk, 4, qk_per_head=True)["minimum"],
            scratch=scratch)}}


def test_wide_scratch_layout_at_the_serve_and_training_shapes():
    """The Python layouts at xlstm-1.3b's shapes: 0.66 GB at the prefill's
    (batch 4, prompt 1024, 4 heads of 1024 × 1025, chunk 256) and 0.39 GB
    for the backward at the training shape (batch 4, seq 512) without an
    initial state or a dh_final (``ssd_scan``'s documented sizes; the card
    holds them equal to the library's count, ``chip_smoke.py``)."""
    fwd = ssd_scan.wide_scratch_layout_bytes(4, 1024, 4, 1024, 1025, 256)
    bwd = ssd_scan.wide_bwd_scratch_layout_bytes(
        4, 512, 4, 1024, 1025, 256, initial_state=False, dh_final=False)
    assert round(fwd / 1e9, 2) == 0.66 and round(bwd / 1e9, 2) == 0.39


def test_real_cpu_tensors_still_take_the_plain_version(no_build):
    u = torch.randn(4, 64)
    assert torch.equal(trust_agg.trust_agg(u, torch.ones(4)),
                       trust_agg.trust_agg_ref(u, torch.ones(4)))


def test_resolve_device_cuda_needs_a_card_outside_fake_mode():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with specs.new_fake_mode():
        assert resolve_device("cuda").type == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


# -- the command line ----------------------------------------------------

def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_cli_one_pair(tmp_path):
    out = tmp_path / "r.json"
    r = _cli("--arch", "h2o-danube-1.8b", "--shape", "decode_32k",
             "--json", str(out))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("OK    h2o-danube-1.8b")
    assert "ALL DRY-RUNS PASSED" in r.stdout
    (rec,) = json.loads(out.read_text())
    assert rec["mesh"] == "1x1" and rec["devices"] == 1
    # 24 layers of a 32,768-slot K/V cache for 128 sequences: 257.7 GB
    assert rec["fits_one_card"] is (rec["peak_bytes"] <= mesh.HBM_BYTES) \
        is False
    assert rec["collective_s"] == 0
    assert rec["kernels"]["swa_decode"]["calls"] == 24
    assert rec["peak_memory_per_device_gb"] > rec["args_gb"] > 0


def test_cli_skip_cut_and_multi_pod(tmp_path):
    out = tmp_path / "r.json"
    r = _cli("--arch", "yi-6b", "--shape", "long_500k", "--json", str(out))
    assert r.returncode == 0 and r.stdout.startswith("SKIP  yi-6b")
    assert json.loads(out.read_text())[0]["skipped"]
    r = _cli("--arch", "yi-6b", "--shape", "decode_32k", "--max-calls",
             "100", "--json", str(out))
    assert r.returncode == 0 and r.stdout.startswith("CUT   yi-6b")
    assert "1 CUT at --max-calls 100" in r.stdout
    (rec,) = json.loads(out.read_text())
    assert rec["cut"] and rec["aten_calls"] == 100
    r = _cli("--arch", "yi-6b", "--shape", "decode_32k", "--multi-pod")
    assert r.returncode != 0 and "one card" in r.stderr
