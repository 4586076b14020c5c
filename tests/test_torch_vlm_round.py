"""chameleon-34b's federated round with the economics the reference gives
its biggest archs, on the port against the JAX package, on the CPU.

``launch.specs.train_config_for`` gives archs of ≳ 20 B parameters the
paper's SGD (lr 0.01, momentum 0.5, no clip, remat) with the momentum kept
in bf16; the rule reads the config it is given, so the full chameleon-34b
config takes bf16 state and a one-layer cut of it f32 state. Chameleon's
tree has one leaf dtype (``api.flat_packable``), so its round can take the
flat pack that K1–K3 read (``fused_trust_path="on"``). One
``make_fl_round`` round at the smoke config, W = 2 (2 clusters × 1 worker,
the one-card form of the round), SGD with bf16 momentum on the flat path,
f32 and bf16 params, sync and async, against the reference's: the
scores, weights and losses; the new global params; the bf16 momentum; in
async the staleness and each worker's pending row (the reference pads its
pending buffer to the async kernel's tiles; its first W rows and D
columns are compared). ``tools/dryrun_round`` sizes the round at the smoke
size with ``--fused-trust-path`` and ``--async``.

Tolerances. Scores, weights and losses: ``test_torch_vlm.py``'s
``ROUND_TOL`` in bf16. In f32, scores and weights are held to 5e-5: under
SGD a worker's update is lr·g, ~1e-4 an element, formed as the difference
of two f32 params of up to ~1 (one f32 step of a param, ~1.2e-7, is
~1e-3 of an element of the update), so the two packages' updates differ
by a few 1e-6 of their norm (measured 4.4e-6) and the scores, cosines and
norm ratios of those updates, by up to 2.5e-5 (measured); AdamW's updates
(``test_torch_vlm.py``) are lr·sign(g) and keep within 1e-5. A momentum
is the bf16 rounding of the gradient (one step from zero state): within a
bf16 step (2^-7 of its value) plus ``test_torch_vlm.py``'s gradient
tolerance of the leaf's largest value (``GRAD_TOL``). A new param, and a
pending row (the worker's new params less the global ones), is within
lr times that gradient tolerance plus, in f32, four f32 steps (2^-21) of
the old and of the new value (each rounding of p − lr·g is one step of
p), and in bf16 a bf16 step of each (each package rounds the worker's
params and the new global params to bf16 once).

The JAX round is imported through the ``jref`` fixture, the workaround
for fault F1 of the reference (ROADMAP.md, Queue 3): see
``tests/test_torch_model.py``.
"""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import FederationConfig, TrainConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core import fl_step
from repro_torch.kernels import pack
from repro_torch.launch import specs
from repro_torch.models import api
from repro_torch.tools import dryrun_round

jax.config.update("jax_enable_x64", False)

ARCH = "chameleon-34b"
P = 16                                   # the smoke config's patch tokens
D_FULL_ONE_LAYER = 1_765_826_560         # the card's round: d 8192, one layer
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ROUND_TOL = {"float32": dict(score=5e-5, loss=1e-5),
             "bfloat16": dict(score=2e-3, loss=1e-2)}
GRAD_TOL = {"float32": 2e-5, "bfloat16": 5e-2}     # test_torch_vlm.py's
PARTICIPATION = np.array([1, 0], np.int32)
FED = dict(num_clusters=2, workers_per_cluster=1, trust_threshold=0.0,
           fused_trust_path="on")


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
    from repro.configs.base import FederationConfig as JFed
    from repro.configs.base import TrainConfig as JTrain
    from repro.configs.registry import get_config as jget
    from repro.configs.registry import get_smoke_config as jsmoke
    from repro.core import fl_step as jfl_step
    from repro.launch import specs as jspecs
    from repro.models import api as japi
    return types.SimpleNamespace(api=japi, fl_step=jfl_step, specs=jspecs,
                                 get=jget, smoke=jsmoke, Fed=JFed,
                                 Train=JTrain)


@pytest.fixture(scope="module")
def models(jref):
    """(jax config, port config, JAX params, port params) of a dtype: the
    JAX init (seed 1), converted; the bf16 init is the f32 one rounded."""
    jp32 = jax.jit(lambda k: jref.api.init(
        jref.smoke(ARCH).replace(dtype="float32"), k, tp=1)[0])(
            jax.random.PRNGKey(1))
    made = {}

    def get(dtype):
        if dtype not in made:
            jp = jax.tree.map(lambda x: x.astype(DTYPES[dtype][0]), jp32)
            made[dtype] = (jref.smoke(ARCH).replace(dtype=dtype),
                           get_smoke_config(ARCH).replace(dtype=dtype),
                           jp, convert.params_from_jax(
                               jax.tree.map(np.asarray, jp)))
        return made[dtype]
    return get


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("cut", [False, True], ids=["full", "one_layer"])
def test_train_config_for_is_the_reference_s(jref, cut):
    """The economics of chameleon-34b's round: the paper's SGD, no clip,
    remat; bf16 momentum for the full config, f32 for a one-layer cut
    (1 · 8192² < 2e9), in both packages."""
    cfg, jcfg = get_config(ARCH), jref.get(ARCH)
    if cut:
        cfg, jcfg = cfg.replace(num_layers=1), jcfg.replace(num_layers=1)
    tc = specs.train_config_for(cfg)
    assert dataclasses.asdict(tc) == dataclasses.asdict(
        jref.specs.train_config_for(jcfg))
    assert (tc.optimizer, tc.lr, tc.momentum, tc.grad_clip, tc.remat) == \
        ("sgd", 0.01, 0.5, 0.0, True)
    assert tc.opt_dtype == ("float32" if cut else "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_packable_on_the_smoke_tree(jref, models, dtype):
    _, _, jp, p = models(dtype)
    assert api.flat_packable(p) and jref.api.flat_packable(jp)


def test_flat_packable_on_the_full_one_layer_tree_on_meta():
    """The card's round: chameleon-34b at full width cut to one layer, on
    fake tensors (no allocation): one bf16 dtype, D = 1,765,826,560."""
    params = specs.init_specs(get_config(ARCH).replace(num_layers=1),
                              device="meta")
    assert {v.dtype for v in params.values()} == {torch.bfloat16}
    assert all(v.device.type == "meta" for v in params.values())
    assert api.flat_packable(params)
    assert api.param_count(params) == D_FULL_ONE_LAYER


def _batch(dtype):
    """2 workers × 1 step × batch 2: 16 patches and 32 tokens a sample."""
    toks = np.random.default_rng(15).integers(0, 512, (2, 1, 2, 32)
                                              ).astype(np.int32)
    patches = np.random.default_rng(16).standard_normal(
        (2, 1, 2, P, 256)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    t = torch.from_numpy(toks)
    return ({"tokens": toks, "labels": toks,
             "patch_embeds": jnp.asarray(patches).astype(jdt)},
            {"tokens": t, "labels": t,
             "patch_embeds": torch.from_numpy(patches).to(tdt)})


def _param_bound(b, old, grad_max, dtype, lr):
    """What a new param ``b``, or a pending update ``b`` (the worker's new
    params less the global ones), may differ by; ``old`` is the param
    before the round."""
    if dtype == "float32":
        return (lr * GRAD_TOL[dtype] * grad_max
                + 2.0 ** -21 * (np.abs(b) + np.abs(old)))
    return (lr * GRAD_TOL[dtype] * grad_max
            + 2.0 ** -7 * (np.abs(b) + np.abs(old)))


@pytest.mark.parametrize("dtype,async_mode", [
    ("float32", False), ("float32", True), ("bfloat16", False),
    ("bfloat16", True)], ids=["f32-sync", "f32-async", "bf16-sync",
                              "bf16-async"])
def test_flat_sgd_round_matches_reference(jref, models, dtype, async_mode):
    """One round at W = 2 on the flat pack with the reference's SGD and
    bf16 momentum; async: worker 0 takes part, worker 1's update goes to
    its pending row, from fresh async states."""
    jcfg, cfg, jp, p = models(dtype)
    tc_kw = dataclasses.asdict(specs.train_config_for(get_config(ARCH)))
    tc_kw["remat"] = False
    fed_kw = dict(FED, async_mode=async_mode)
    jfed, jtc = jref.Fed(**fed_kw), jref.Train(**tc_kw)
    fed, tc = FederationConfig(**fed_kw), TrainConfig(**tc_kw)
    assert tc.opt_dtype == "bfloat16" and tc.optimizer == "sgd"
    jbatch, batch = _batch(dtype)
    jopt = jax.jit(lambda p: jref.fl_step.init_worker_opt(p, jfed, jtc))(jp)
    jfn = jax.jit(jref.fl_step.make_fl_round(jcfg, jfed, jtc))
    fn = fl_step.make_fl_round(cfg, fed, tc, device="cpu")
    opt = fl_step.init_worker_opt(p, fed, tc)
    if async_mode:
        jout, jst = jfn(jp, jopt, jbatch, None,
                        jnp.asarray(PARTICIPATION, jnp.float32),
                        jref.fl_step.init_async_state_for(jcfg, jfed, jp, 2))
        out, st = fn(p, opt, batch, None, torch.from_numpy(PARTICIPATION),
                     fl_step.init_async_state_for(cfg, fed, p, 2))
    else:
        jout, out = jfn(jp, jopt, jbatch), fn(p, opt, batch)
    tol = ROUND_TOL[dtype]
    for name in ("scores", "weights"):
        assert np.abs(_f32(getattr(out, name))
                      - _f32(getattr(jout, name))).max() <= tol["score"]
    assert np.abs(_f32(out.losses) - _f32(jout.losses)).max() <= tol["loss"]

    # in the port's keys: the momentum, each worker's gradient rounded to
    # bf16, and the new global params
    def port(tree):
        return {k: _f32(v) for k, v in convert.params_from_jax(
            jax.tree.map(np.asarray, tree)).items()}
    jmom = port(jout.opt_state["momentum"])
    assert all(v.dtype == torch.bfloat16
               for v in out.opt_state["momentum"].values())
    assert all(np.asarray(x).dtype == jnp.bfloat16
               for x in jax.tree.leaves(jout.opt_state["momentum"]))
    grad_max = {k: float(np.abs(b).max()) for k, b in jmom.items()}
    for k, b in jmom.items():
        a = _f32(out.opt_state["momentum"][k])
        assert (np.abs(a - b) <= 2.0 ** -7 * np.abs(b)
                + GRAD_TOL[dtype] * grad_max[k]).all(), k
    jnew = port(jout.global_params)
    for k, b in jnew.items():
        a, old = _f32(out.global_params[k]), _f32(p[k])
        assert (np.abs(a - b) <= _param_bound(b, old, grad_max[k], dtype,
                                              tc.lr)).all(), k
    if not async_mode:
        return
    assert st.staleness.tolist() == np.asarray(jst.staleness).tolist() \
        == [0, 1]
    W, D = st.pending.shape
    assert (W, D) == (2, api.param_count(p))
    jpend = np.asarray(jst.pending)
    assert not jpend[W:].any() and not jpend[:, D:].any()
    spec = pack.pack_spec(p)
    for w in range(W):
        got, want = _f32(st.pending[w]), jpend[w, :D]
        if PARTICIPATION[w]:
            assert not got.any() and not want.any()
            continue
        assert want.any()
        for k, off, size, _ in spec.slices():
            a, b = got[off:off + size], want[off:off + size]
            old = _f32(p[k]).reshape(-1)
            assert (np.abs(a - b) <= _param_bound(b, old, grad_max[k], dtype,
                                                  tc.lr)).all(), (w, k)


@pytest.mark.parametrize("fused", ["off", "on"])
def test_dryrun_round_sizes_the_sgd_round_at_the_smoke_size(capsys, fused):
    """``tools/dryrun_round`` at the smoke size, sync and async: the flat
    pack's round traces K1 with K2 (sync) or K3 (async), the per-leaf one
    no kernel; the async round's arguments add the (W, D) f32 pending
    buffer (flat, or a leaf each) to the sync round's."""
    common = ["--arch", ARCH, "--smoke", "--layers", "1", "--workers", "2",
              "--seq", "48", "--batch", "2", "--optimizer", "sgd",
              "--opt-dtype", "bfloat16", "--fused-trust-path", fused]
    dryrun_round.main(common)
    dryrun_round.main(common + ["--async"])
    sync, asyn = [json.loads(x) for x in
                  capsys.readouterr().out.strip().splitlines()]
    assert (sync["async"], asyn["async"]) == (False, True)
    assert sync["fused_trust_path"] == asyn["fused_trust_path"] == fused
    D = sync["D"]
    assert D == asyn["D"] == api.param_count(specs.init_specs(
        get_smoke_config(ARCH).replace(num_layers=1)))
    if fused == "on":
        assert {k: v["calls"] for k, v in sync["kernels"].items()} == \
            {"trust_score": 1, "trust_agg": 1}
        assert {k: v["calls"] for k, v in asyn["kernels"].items()} == \
            {"trust_score": 1, "fused_async_agg": 1}
    else:
        assert sync["kernels"] == asyn["kernels"] == {}
    grown = asyn["args_bytes"] - sync["args_bytes"]
    assert 2 * D * 4 <= grown <= 2 * D * 4 + 64 * 512
    assert asyn["peak_bytes"] > sync["peak_bytes"] + 2 * D * 4
