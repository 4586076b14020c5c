"""What a single card has a meaning for of the reference's remaining
helpers, against the JAX package on the CPU: the registry's
``get_shape`` and ``applicable`` (every arch × input shape) and each
arch's config, head rotation (``core.hierarchy.rotate_heads``) and the
flat-param view of ``models.api`` (``flat_param_spec``, ``flat_packable``,
``flatten_params``, ``unflatten_params``). All exact: the helpers move
and index values, they compute none.

The JAX package's models are imported through the ``jref`` fixture, the
workaround for fault F1 of the reference (ROADMAP.md, Queue 3; see
``tests/test_torch_serve.py``).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core import hierarchy
from repro_torch.models import api

jax.config.update("jax_enable_x64", False)


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
    from repro.configs import registry as jregistry
    from repro.core import hierarchy as jhierarchy
    from repro.models import api as japi
    return types.SimpleNamespace(registry=jregistry, hierarchy=jhierarchy,
                                 api=japi)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_lists_the_reference_s_archs_and_shapes(jref):
    assert registry.ARCH_IDS == jref.registry.ARCH_IDS
    assert list(registry.INPUT_SHAPES) == list(jref.registry.INPUT_SHAPES)
    for name in registry.INPUT_SHAPES:
        assert dataclasses.asdict(registry.get_shape(name)) == \
            dataclasses.asdict(jref.registry.get_shape(name))
    with pytest.raises(KeyError):
        registry.get_shape("no-such-shape")


@pytest.mark.parametrize("arch", registry.ARCH_IDS + ["paper-net"])
def test_configs_and_applicable_match_reference(jref, arch):
    """Each arch's full and smoke config field for field, and
    ``applicable`` (with its reason) for every input shape."""
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(registry, get)(arch)) == \
            dataclasses.asdict(getattr(jref.registry, get)(arch)), get
    for shape in registry.INPUT_SHAPES:
        assert registry.applicable(arch, shape) == \
            jref.registry.applicable(arch, shape), shape


def test_applicable_skips_what_the_reference_skips():
    ok, why = registry.applicable("yi-6b", "long_500k")
    assert not ok and "sub-quadratic" in why
    assert registry.applicable("paper-net", "decode_32k")[0] is False
    assert registry.applicable("zamba2-7b", "long_500k") == (True, "")


# ---------------------------------------------------------------------------
# head rotation
# ---------------------------------------------------------------------------

def _rotate_both(jref, x, offsets):
    want = jref.hierarchy.rotate_heads(
        {k: jnp.asarray(v) for k, v in x.items()}, jnp.asarray(offsets))
    got = hierarchy.rotate_heads({k: torch.from_numpy(v)
                                  for k, v in x.items()},
                                 torch.from_numpy(offsets))
    return got, want


def test_rotate_heads_is_the_reference_s_permutation(jref):
    """``tests/test_trust.py``'s case: 8 workers in 2 clusters, offsets
    (1, 3): a permutation of the rows, each cluster rolled by its
    offset."""
    x = {"p": (np.arange(8.0)[:, None] * np.ones((8, 3))).astype(np.float32)}
    got, want = _rotate_both(jref, x, np.array([1, 3]))
    assert sorted(got["p"][:, 0].tolist()) == list(range(8))
    assert got["p"][:, 0].tolist() == [1, 2, 3, 0, 7, 4, 5, 6]
    np.testing.assert_array_equal(got["p"].numpy(), np.asarray(want["p"]))


def test_rotate_heads_matches_reference_on_random_offsets(jref):
    """4 clusters of 5 on leaves of three ranks and dtypes; offsets drawn
    in [-7, 12], beyond one cluster's size both ways."""
    rng = np.random.default_rng(0)
    x = {"a": rng.standard_normal(20).astype(np.float32),
         "b": rng.standard_normal((20, 3, 2)).astype(np.float32),
         "c": rng.integers(0, 100, (20, 4)).astype(np.int32)}
    offsets = rng.integers(-7, 13, 4)
    got, want = _rotate_both(jref, x, offsets)
    for k in x:
        assert got[k].dtype == torch.from_numpy(x[k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert not np.array_equal(got["b"].numpy(), x["b"])


# ---------------------------------------------------------------------------
# the flat-param view
# ---------------------------------------------------------------------------

VIEW_ARCHS = ["chameleon-34b", "zamba2-7b", "xlstm-1.3b",
              "qwen2-moe-a2.7b", "whisper-base"]


@pytest.mark.parametrize("arch", VIEW_ARCHS)
def test_flatten_params_matches_reference(jref, arch):
    """On each arch's smoke params (the JAX init, converted): the same leaf
    order, offsets, sizes, shapes, dtype and D as the reference's
    ``flatten_params``, the same (D,) vector bit for bit, and
    ``unflatten_params`` its exact inverse in both packages."""
    jcfg = jref.registry.get_smoke_config(arch).replace(dtype="float32")
    jp = jax.jit(lambda k: jref.api.init(jcfg, k, tp=1)[0])(
        jax.random.PRNGKey(2))
    p = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    jflat, jspec = jref.api.flatten_params(jp)
    flat, spec = api.flatten_params(p)
    assert api.flat_param_spec(p) == spec
    assert (spec.offsets, spec.sizes, spec.shapes, spec.total) == (
        jspec.offsets, jspec.sizes, jspec.shapes, jspec.total)
    assert spec.dtype == torch.float32 and jspec.dtype == jnp.float32
    assert flat.shape == (spec.total,) == (api.param_count(p),)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back = api.unflatten_params(flat, spec)
    assert set(back) == set(p)
    for k in p:
        assert torch.equal(back[k], p[k])
    theirs = convert.params_from_jax(jax.tree.map(
        np.asarray, jref.api.unflatten_params(jflat, jspec)))
    for k in p:
        assert torch.equal(theirs[k], back[k])


def test_flat_packable_matches_reference(jref):
    """One floating dtype packs; a mix of dtypes or integer leaves do not;
    nor does an empty dict."""
    cases = [{"a": np.zeros(3, np.float32), "b": np.ones((2, 2), np.float32)},
             {"a": np.zeros(3, np.float32), "b": np.ones(2, np.float16)},
             {"a": np.zeros(3, np.int32)}, {}]
    for tree in cases:
        assert api.flat_packable({k: torch.from_numpy(v)
                                  for k, v in tree.items()}) == \
            jref.api.flat_packable({k: jnp.asarray(v)
                                    for k, v in tree.items()})
    assert api.flat_packable({"a": torch.zeros(2, dtype=torch.bfloat16)})
